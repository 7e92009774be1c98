"""Swarm-wide trace stitching and the flight recorder.

Counterpart of ``crowdllama_tpu/obs/collector.py``: a request's spans
are scattered over every node that touched it (gateway, workers), each
holding a fragment in its own :class:`~.trace.TraceBuffer` under the
trace id the llama.v1 envelope carried.  :class:`TraceCollector` takes
the gateway's fragment as the root, fans a ``TraceFetch`` out over the
inference protocol to every worker the gateway knows (a node without the
id answers ``found=false``) and assembles one span tree on the gateway's
clock (``stitch``): each fragment is placed by its wall-clock start, then
clamped to nest inside the gateway's request window.
:class:`FlightRecorder` keeps complete stitched traces of interesting
requests (the p99 tail, failovers, migrations, sheds, stalls) in a ring
of their own.  ``render_waterfall`` draws one for ``cli trace``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Any

from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import (
    extract_trace_spans,
    trace_fetch_msg,
)
from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL

log = logging.getLogger("crowdllama.torch.obs.collector")

# Per-node fetch budget: a trace fetch is a debugging aid — a dead or
# wedged peer must cost seconds, not the request_timeout.
FETCH_TIMEOUT_S = 3.0
# Fan-out bound: the collector queries at most this many peers per fetch
# (newest-seen first); beyond that a swarm is big enough that the
# operator should be sharding traces into a real backend.
MAX_FANOUT = 32


async def fetch_fragment(peer, peer_id: str, trace_id: str,
                         timeout: float = FETCH_TIMEOUT_S) -> dict | None:
    """Fetch one node's span fragment over the p2p plane.

    Returns the decoded trace record (the node's /debug/trace shape) with
    a ``node`` key injected, None when the node has no spans for the id
    (or cannot be reached — a collector must degrade, not fail).
    """
    s = None
    try:
        contact = await peer.dht.find_peer(peer_id)
        if contact is None:
            return None
        s = await peer.host.new_stream(contact, INFERENCE_PROTOCOL,
                                       timeout=timeout)
        msg = trace_fetch_msg(trace_id)
        await wire.write_length_prefixed_pb(s.writer, msg)
        reply = await wire.read_length_prefixed_pb(s.reader, timeout=timeout)
        ts = extract_trace_spans(reply)
        if not ts.found or not ts.payload:
            return None
        record = json.loads(ts.payload.decode("utf-8"))
        record["node"] = ts.node or f"peer:{peer_id[:8]}"
        return record
    except asyncio.CancelledError:
        raise
    except Exception as e:
        log.debug("trace fetch from %s failed: %s", peer_id[:8], e)
        return None
    finally:
        if s is not None:
            s.close()


class TraceCollector:
    """Gateway-side cross-node trace assembly."""

    def __init__(self, peer, obs, timeout: float = FETCH_TIMEOUT_S) -> None:
        self.peer = peer  # the gateway's Peer (host + dht + peer_manager)
        self.obs = obs    # the gateway's NodeObs (root fragments)
        self.timeout = timeout

    def _targets(self) -> list[str]:
        """Peers worth asking: every worker the manager knows (healthy or
        not — a drained donor still holds spans), newest-seen first."""
        pm = self.peer.peer_manager
        if pm is None:
            return []
        peers = sorted(pm.get_workers(), key=lambda p: -p.last_seen)
        return [p.peer_id for p in peers[:MAX_FANOUT]
                if p.peer_id != self.peer.peer_id]

    async def collect(self, trace_id: str) -> dict[str, Any] | None:
        """One stitched cross-node trace, or None when NOBODY has spans."""
        root = self.obs.trace.get(trace_id)
        if root is not None:
            root = dict(root)
            root["node"] = "gateway"
        results = await asyncio.gather(
            *(fetch_fragment(self.peer, pid, trace_id, self.timeout)
              for pid in self._targets()),
            return_exceptions=True)
        fragments = [r for r in results
                     if isinstance(r, dict) and r is not None]
        if root is None and not fragments:
            return None
        return stitch(trace_id, root, fragments)


def stitch(trace_id: str, root: dict | None,
           fragments: list[dict]) -> dict[str, Any]:
    """Assemble fragments into one span tree on the root's timeline.

    Output spans carry ``node`` plus a synthetic per-node root span named
    after the node, parented under the gateway root, so the tree has no
    orphans: fragment spans whose recorded parent is the cross-node
    ``"gateway"`` link (or is missing from their own fragment) re-parent
    onto their node's root.
    """
    if root is None:
        # Degenerate: gateway ring already wrapped — promote the earliest
        # fragment to root so the operator still gets a tree.
        fragments = sorted(fragments,
                           key=lambda f: f.get("started_at", 0.0))
        root, fragments = dict(fragments[0]), fragments[1:]
    t0_wall = float(root.get("started_at", 0.0))
    total_us = float(root.get("total_us", 0.0))
    root_node = str(root.get("node", "gateway"))

    out_spans: list[dict] = [{
        "node": root_node, "name": root_node, "start_us": 0.0,
        "dur_us": total_us, "parent": "",
    }]
    names_by_node: dict[str, set[str]] = {root_node: {root_node}}

    def add_fragment(frag: dict, parent: str) -> None:
        node = str(frag.get("node", "?"))
        spans = list(frag.get("spans", []))
        frag_end = max([float(s.get("start_us", 0.0))
                        + float(s.get("dur_us", 0.0)) for s in spans]
                       + [float(frag.get("total_us", 0.0))] or [0.0])
        # Coarse wall-clock placement, then nest inside the root window
        # (see module docstring): skew cannot push a hop before admission
        # or past completion.
        off_us = (float(frag.get("started_at", t0_wall)) - t0_wall) * 1e6
        if total_us > 0:
            off_us = max(0.0, min(off_us, max(0.0, total_us - frag_end)))
        else:
            off_us = max(0.0, off_us)
        node_root = {
            "node": node, "name": node,
            "start_us": round(off_us, 1),
            "dur_us": round(frag_end, 1),
            "parent": parent,
        }
        if frag.get("meta"):
            node_root["meta"] = frag["meta"]
        out_spans.append(node_root)
        local_names = {str(s.get("name", "")) for s in spans}
        names_by_node[node] = local_names | {node}
        for s in spans:
            sp = {
                "node": node,
                "name": str(s.get("name", "")),
                "start_us": round(off_us + float(s.get("start_us", 0.0)), 1),
                "dur_us": float(s.get("dur_us", 0.0)),
                "parent": str(s.get("parent", "")),
            }
            # Re-parent the fragment-local tree: a span pointing at the
            # cross-node link (the sender's parent_span, e.g. "gateway")
            # or at a name this fragment never recorded hangs off the
            # node root instead of dangling as an orphan.
            if sp["parent"] not in local_names or sp["parent"] == sp["name"]:
                sp["parent"] = node
            if s.get("meta"):
                sp["meta"] = s["meta"]
            out_spans.append(sp)

    # Root fragment's own spans keep their recorded parents when those
    # resolve; anything else hangs off the root span.
    root_names = {str(s.get("name", "")) for s in root.get("spans", [])}
    for s in root.get("spans", []):
        sp = {
            "node": root_node,
            "name": str(s.get("name", "")),
            "start_us": float(s.get("start_us", 0.0)),
            "dur_us": float(s.get("dur_us", 0.0)),
            "parent": str(s.get("parent", "")),
        }
        if (sp["parent"] != root_node and sp["parent"] not in root_names) \
                or sp["parent"] == sp["name"]:
            sp["parent"] = root_node
        if s.get("meta"):
            sp["meta"] = s["meta"]
        out_spans.append(sp)

    for frag in sorted(fragments, key=lambda f: f.get("started_at", 0.0)):
        add_fragment(frag, root_node)

    leaf_sum = sum(s["dur_us"] for s in out_spans[1:]
                   if s["name"] not in names_by_node)
    return {
        "trace_id": trace_id,
        "stitched": True,
        "started_at": round(t0_wall, 3),
        "total_us": round(total_us, 1),
        "done": bool(root.get("done", False)),
        "meta": root.get("meta", {}),
        "nodes": [root_node] + [str(f.get("node", "?")) for f in fragments],
        "span_sum_us": round(leaf_sum, 1),
        "spans": out_spans,
    }


def render_waterfall(stitched: dict, width: int = 48) -> str:
    """Indented text waterfall of a stitched trace (the ``crowdllama-tpu
    trace <id>`` CLI output).  One line per span: tree indentation, a bar
    positioned on the request timeline, duration, and meta."""
    total = max(1.0, float(stitched.get("total_us", 0.0)))
    spans = stitched.get("spans", [])
    children: dict[str, list[dict]] = {}
    by_name: dict[str, dict] = {}
    for s in spans:
        by_name.setdefault(s["name"], s)
        children.setdefault(s.get("parent", ""), []).append(s)

    def fmt_us(us: float) -> str:
        if us >= 1e6:
            return f"{us / 1e6:.2f}s"
        if us >= 1e3:
            return f"{us / 1e3:.1f}ms"
        return f"{us:.0f}us"

    lines = [
        f"trace {stitched.get('trace_id', '?')}"
        f"  ·  nodes: {', '.join(stitched.get('nodes', []))}"
        f"  ·  total {fmt_us(total)}"
        + ("" if stitched.get("done") else "  ·  IN FLIGHT"),
    ]
    meta = stitched.get("meta") or {}
    if meta:
        lines.append("  " + " ".join(f"{k}={v}" for k, v in
                                     sorted(meta.items())))

    seen: set[int] = set()

    def bar(start_us: float, dur_us: float) -> str:
        lo = int(width * min(1.0, max(0.0, start_us / total)))
        hi = int(width * min(1.0, max(0.0, (start_us + dur_us) / total)))
        hi = max(hi, lo + 1)
        return " " * lo + "▇" * (hi - lo) + " " * (width - hi)

    def walk(span: dict, depth: int) -> None:
        if id(span) in seen:  # defensive: malformed parent cycles
            return
        seen.add(id(span))
        label = ("  " * depth) + span["name"]
        extra = ""
        if span.get("meta"):
            extra = "  " + ",".join(
                f"{k}={v}" for k, v in sorted(span["meta"].items()))
        lines.append(f"  {label:<28.28} |{bar(span['start_us'], span['dur_us'])}"
                     f"| {fmt_us(span['dur_us']):>8}{extra}")
        kids = [c for c in children.get(span["name"], []) if c is not span]
        for c in sorted(kids, key=lambda x: x["start_us"]):
            walk(c, depth + 1)

    roots = [s for s in spans if not s.get("parent")]
    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


class FlightRecorder:
    """Bounded ring of complete stitched traces for interesting requests.

    Separate from the general trace ring on purpose: under load the
    general ring wraps in seconds, but the three requests that crossed
    p99 during an incident must still be there when the operator arrives.
    Thread-safe; capture is last-writer-wins per trace id.
    """

    def __init__(self, capacity: int = 32) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring: OrderedDict[str, dict] = OrderedDict()
        self.captured_total = 0

    def capture(self, trace_id: str, reasons: list[str],
                stitched: dict) -> None:
        if not trace_id or not reasons:
            return
        entry = {
            "trace_id": trace_id,
            "captured_at": round(time.time(), 3),
            "reasons": sorted(set(reasons)),
            "trace": stitched,
        }
        with self._lock:
            if trace_id in self._ring:
                self._ring.pop(trace_id)
            self._ring[trace_id] = entry
            self.captured_total += 1
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            return self._ring.get(trace_id)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {"capacity": self.capacity,
                    "captured_total": self.captured_total,
                    "traces": list(self._ring.values())}
