"""Cluster metric fan-in for ``GET /metrics/cluster``.

Counterpart of ``crowdllama_tpu/obs/cluster.py``: the gateway scrapes
every worker's metric families over the authenticated p2p plane (a
``MetricsFetch`` fan-out, bounded, with a per-node timeout; a dead
worker leaves the snapshot partial, never failed) and re-exports them:
each worker family re-labeled ``worker="<peer-id head>"``, the
``crowdllama_cluster_*`` rollups, and the gateway's own per-worker
routing gauges, so one scrape feeds ``cli top``.
"""

from __future__ import annotations

import asyncio
import logging
import re

from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import (
    extract_metrics_snapshot,
    metrics_fetch_msg,
)
from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL
from crowdllama_tpu_torch.obs.metrics import LabelGuard, _fmt
from crowdllama_tpu_torch.testing import faults

log = logging.getLogger("crowdllama.torch.obs.cluster")

# Per-node scrape budget: mirrors the trace collector's — a dead worker
# must cost seconds, not the whole scrape.
FETCH_TIMEOUT_S = 3.0
# Fan-out bound, shared rationale with obs/collector.py: beyond this the
# operator should shard scraping into a real metrics backend.
MAX_FANOUT = 32

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (.*)$")

# Worker gauges the rollups aggregate: (family suffix, how to combine).
_ROLLUP_MEAN = ("batch_occupancy", "kv_cache_utilization")
_ROLLUP_SUM = ("active_slots", "pending_depth")


async def fetch_metrics(peer, peer_id: str, families: tuple[str, ...] = (),
                        timeout: float = FETCH_TIMEOUT_S
                        ) -> tuple[str, str] | None:
    """Scrape one worker over the p2p plane.

    Returns ``(node_tag, exposition_text)``, or None when the worker
    cannot be reached or answers found=false — a cluster scrape must
    degrade to a partial snapshot, never fail.
    """
    s = None
    try:
        # Chaos choke point (``testing/faults.py``): a worker dying mid-scrape
        # is what the partial-snapshot contract defends against.
        await faults.inject("obs.scrape", worker=peer_id)
        contact = await peer.dht.find_peer(peer_id)
        if contact is None:
            return None
        s = await peer.host.new_stream(contact, INFERENCE_PROTOCOL,
                                       timeout=timeout)
        await wire.write_length_prefixed_pb(
            s.writer, metrics_fetch_msg(families))
        reply = await wire.read_length_prefixed_pb(s.reader, timeout=timeout)
        snap = extract_metrics_snapshot(reply)
        if not snap.found:
            return None
        return (snap.node or f"peer:{peer_id[:8]}",
                snap.payload.decode("utf-8", "replace"))
    except asyncio.CancelledError:
        raise
    except Exception as e:
        log.debug("metrics scrape from %s failed: %s", peer_id[:8], e)
        return None
    finally:
        if s is not None:
            s.close()


class ClusterScraper:
    """Gateway-side swarm scrape + worker-labeled re-export."""

    def __init__(self, peer, timeout: float = FETCH_TIMEOUT_S) -> None:
        self.peer = peer  # the gateway's Peer (host + dht + peer_manager)
        self.timeout = timeout
        # One label value per scraped worker; MAX_FANOUT bounds the
        # fan-out, +1 headroom keeps churn from collapsing a live worker
        # to the fallback before old ids age out of the allow-set.
        self._worker_guard = LabelGuard(max_values=2 * MAX_FANOUT)
        self.scrapes_total = 0
        self.scrape_misses_total = 0  # targets that answered nothing

    def _targets(self) -> list:
        """Workers worth scraping: newest-seen first, bounded, never self
        (same policy as the trace collector's fan-out)."""
        pm = self.peer.peer_manager
        if pm is None:
            return []
        peers = sorted(pm.get_workers(), key=lambda p: -p.last_seen)
        return [p for p in peers[:MAX_FANOUT]
                if p.peer_id != self.peer.peer_id]

    async def scrape(self, families: tuple[str, ...] = ()
                     ) -> list[tuple[str, str, str]]:
        """Fan out; returns [(worker_label, node_tag, exposition_text)]
        for every worker that answered (partial on any failure)."""
        targets = self._targets()
        results = await asyncio.gather(
            *(fetch_metrics(self.peer, p.peer_id, families, self.timeout)
              for p in targets),
            return_exceptions=True)
        out: list[tuple[str, str, str]] = []
        seen: set[str] = set()
        for p, r in zip(targets, results):
            self.scrapes_total += 1
            if not isinstance(r, tuple):
                self.scrape_misses_total += 1
                continue
            label = self._worker_guard.value(p.peer_id[:16])
            if label in seen:
                # Guard fallback collision: dropping the extra worker's
                # samples keeps the exposition free of duplicate series.
                self.scrape_misses_total += 1
                continue
            seen.add(label)
            out.append((label, r[0], r[1]))
        return out

    async def render(self, families: tuple[str, ...] = ()) -> str:
        """The full /metrics/cluster exposition text."""
        snapshots = await self.scrape(families)
        lines = self._rollup_lines(snapshots)
        lines.extend(self._worker_lines())
        lines.extend(merge_snapshots(snapshots))
        return "\n".join(lines) + "\n"

    def _worker_lines(self) -> list[str]:
        """The gateway's own routing view per worker (advertised
        throughput/load/health) — same families and ``peer`` label head as
        the gateway /metrics block, so `top` reads one surface."""
        pm = self.peer.peer_manager
        if pm is None:
            return []
        lines = [
            "# TYPE crowdllama_worker_throughput_tokens_per_sec gauge",
            "# TYPE crowdllama_worker_load gauge",
            "# TYPE crowdllama_worker_healthy gauge",
        ]
        for p in pm.get_workers():
            pid = p.peer_id[:16]
            r = p.resource
            lines.append(
                f'crowdllama_worker_throughput_tokens_per_sec{{'
                f'peer="{pid}"}} {r.tokens_throughput}')
            lines.append(f'crowdllama_worker_load{{peer="{pid}"}} {r.load}')
            lines.append(f'crowdllama_worker_healthy{{peer="{pid}"}} '
                         f'{1 if p.is_healthy else 0}')
        return lines

    def _rollup_lines(self, snapshots: list[tuple[str, str, str]]
                      ) -> list[str]:
        """Pre-aggregated swarm gauges, computed from the scraped
        snapshots (occupancy/KV/inflight) and the routing plane's
        advertised throughput (tokens/s — workers do not self-report a
        rate family, the resource ad is the swarm-wide source)."""
        acc: dict[str, list[float]] = {}
        for _, _, text in snapshots:
            for key in _ROLLUP_MEAN + _ROLLUP_SUM:
                m = re.search(
                    rf"^crowdllama_engine_{key} ([0-9.eE+-]+)\s*$",
                    text, re.M)
                if m:
                    acc.setdefault(key, []).append(float(m.group(1)))
        pm = self.peer.peer_manager
        workers = pm.get_workers() if pm is not None else []
        tokens = sum(p.resource.tokens_throughput for p in workers)
        n = max(1, len(snapshots))
        inflight = sum(acc.get("active_slots", [])) \
            + sum(acc.get("pending_depth", []))
        lines = [
            "# TYPE crowdllama_cluster_workers_total gauge",
            f"crowdllama_cluster_workers_total {len(workers)}",
            "# TYPE crowdllama_cluster_workers_scraped gauge",
            f"crowdllama_cluster_workers_scraped {len(snapshots)}",
            "# TYPE crowdllama_cluster_scrapes_total counter",
            f"crowdllama_cluster_scrapes_total {self.scrapes_total}",
            "# TYPE crowdllama_cluster_scrape_misses_total counter",
            f"crowdllama_cluster_scrape_misses_total "
            f"{self.scrape_misses_total}",
            "# TYPE crowdllama_cluster_tokens_per_second gauge",
            f"crowdllama_cluster_tokens_per_second {_fmt(float(tokens))}",
            "# TYPE crowdllama_cluster_batch_occupancy gauge",
            f"crowdllama_cluster_batch_occupancy "
            f"{_fmt(sum(acc.get('batch_occupancy', [0.0])) / n)}",
            "# TYPE crowdllama_cluster_kv_cache_utilization gauge",
            f"crowdllama_cluster_kv_cache_utilization "
            f"{_fmt(sum(acc.get('kv_cache_utilization', [0.0])) / n)}",
            "# TYPE crowdllama_cluster_inflight gauge",
            f"crowdllama_cluster_inflight {_fmt(inflight)}",
        ]
        # Autopilot rollup: swarm-wide dial-move count
        # — one number that says whether the fleet's tuners have settled.
        moves = 0.0
        for _, _, text in snapshots:
            m = re.search(r"^crowdllama_autotune_moves_total ([0-9.eE+-]+)"
                          r"\s*$", text, re.M)
            if m:
                moves += float(m.group(1))
        lines += [
            "# TYPE crowdllama_cluster_autotune_moves_total counter",
            f"crowdllama_cluster_autotune_moves_total {_fmt(moves)}",
        ]
        return lines


def merge_snapshots(snapshots: list[tuple[str, str, str]]) -> list[str]:
    """Merge per-worker expositions into one worker-labeled exposition.

    Each family's ``# TYPE`` is declared once (the families are identical
    code on every worker; the first declaration wins and conflicting
    redeclarations are dropped); every sample line gains a leading
    ``worker`` label.  Exemplars are stripped — a trace id is meaningful
    against the worker that minted it, not a merged surface.
    """
    types: dict[str, str] = {}
    by_family: dict[str, list[str]] = {}
    order: list[str] = []
    for label, _, text in snapshots:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split()
                if len(parts) == 4 and parts[:2] == ["#", "TYPE"]:
                    fam, kind = parts[2], parts[3]
                    if fam not in types:
                        types[fam] = kind
                        order.append(fam)
                continue
            if " # " in line:  # strip OpenMetrics exemplar suffix
                line = line.partition(" # ")[0]
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name, labels, value = m.groups()
            inner = (labels or "{}")[1:-1]
            merged = f'worker="{label}"' + ("," + inner if inner else "")
            fam = _base_family(name, types)
            by_family.setdefault(fam, []).append(
                f"{name}{{{merged}}} {value}")
    out: list[str] = []
    for fam in order:
        samples = by_family.pop(fam, [])
        if not samples:
            continue
        out.append(f"# TYPE {fam} {types[fam]}")
        out.extend(samples)
    # Samples whose TYPE never appeared (malformed worker) are dropped —
    # the lint contract on this surface is "declared or absent".
    return out


def _base_family(name: str, types: dict[str, str]) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in types:
            return name[: -len(suffix)]
    return name
