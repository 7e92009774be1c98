"""Fixed-bucket histograms, label hygiene and the engine gauges of the
``/metrics`` exposition.

Counterpart of ``crowdllama_tpu/obs/metrics.py``, family for family:

- ``crowdllama_request_seconds``     end-to-end per request, by model
- ``crowdllama_ttft_seconds``        time to first token
- ``crowdllama_decode_step_seconds`` per decode step

plus the KV-ship, drain, migration, gossip and tenant families
(:class:`NodeMetrics`), the engine gauges (``engine_gauge_lines``), the
process-wide compile / padding / host-gap plane (:class:`EngineTelemetry`,
under the JAX package's family names; the port's kernels build at warmup
and record no compiles) and the device memory gauges, from
``torch.cuda.memory_stats``.  :class:`LabelGuard` bounds every label's
value space so a client cannot mint unbounded series.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Iterable

# Bucket upper bounds in seconds.  Request/TTFT cover loopback FakeEngine
# (sub-ms) through big-model TPU prefill (tens of seconds); decode steps
# cover fused-kernel steps (sub-ms) through CPU-interpreted tiny models.
REQUEST_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0)
DECODE_STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                       0.05, 0.1, 0.25, 0.5, 1.0)
# XLA compile wall time per (program, bucket) first dispatch: CPU-jitted
# tiny test models compile in tens of ms, big-model TPU prefill programs in
# minutes.
COMPILE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0)

_LABEL_VALUE_RE = re.compile(r"^[A-Za-z0-9_.:/\-]{1,64}$")

# The scheduler's decode dispatch classes (docs/OBSERVABILITY.md duty
# cycle): how a flight reached the device — plain per-step chunk,
# kernel-looped megastep, unified ragged step, or speculative verify.
DISPATCH_CLASSES = ("plain", "megastep", "ragged", "spec")


def _fmt(v: float) -> str:
    """Exposition number format: integers without a trailing .0."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


class LabelGuard:
    """Bound the value space of one metric label.

    A value passes when it matches the explicit allowlist (if given) or,
    with no allowlist, when it looks like a sane identifier AND the number
    of distinct values seen so far is under ``max_values``.  Everything
    else collapses to ``fallback`` so series cardinality stays bounded no
    matter what strings arrive from the network.
    """

    def __init__(self, allowed: Iterable[str] | None = None,
                 max_values: int = 64, fallback: str = "other") -> None:
        self._allowed = frozenset(allowed) if allowed is not None else None
        self._max = max(1, int(max_values))
        self._fallback = fallback
        self._seen: set[str] = set()
        self._lock = threading.Lock()

    def value(self, raw: object) -> str:
        s = str(raw) if raw else ""
        if self._allowed is not None:
            return s if s in self._allowed else self._fallback
        if not _LABEL_VALUE_RE.match(s):
            return self._fallback
        with self._lock:
            if s not in self._seen:
                if len(self._seen) >= self._max:
                    return self._fallback
                self._seen.add(s)
        return s


class Histogram:
    """Fixed-bucket histogram, rendered cumulatively at exposition time.

    Observations may carry a trace_id *exemplar* — the last one lands on
    the bucket it fell into and, when exemplar rendering is enabled, is
    emitted in OpenMetrics syntax (`` # {trace_id="..."} <value>``) so a
    dashboard spike links straight to a stitched trace."""

    def __init__(self, buckets: Iterable[float]) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = overflow (+Inf)
        self._exemplars: list[tuple[str, float] | None] = \
            [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: str = "") -> None:
        v = float(value)
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            if exemplar:
                self._exemplars[idx] = (exemplar, v)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot_counts(self) -> list[int]:
        """Non-cumulative per-bucket counts (last = overflow); benchmarks
        diff two snapshots to get a per-window distribution."""
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (PromQL histogram_quantile
        semantics).  Benchmarks read their percentiles from here so the
        published number is the same one a dashboard would compute from
        the scraped series."""
        return quantile_from_counts(self.buckets, self.snapshot_counts(), q)

    def lines(self, name: str, labels: str = "",
              exemplars: bool = False) -> list[str]:
        """Series lines (no TYPE header) for one child of a family.

        ``labels`` is a pre-rendered ``key="value"`` list without braces.
        With ``exemplars`` each bucket that captured one gets the
        OpenMetrics exemplar suffix on its _bucket line.
        """
        with self._lock:
            counts = list(self._counts)
            exs = list(self._exemplars)
            total_sum = self._sum
        sep = "," if labels else ""

        def _ex(i: int) -> str:
            if not exemplars or exs[i] is None:
                return ""
            tid, v = exs[i]
            return f' # {{trace_id="{tid}"}} {_fmt(v)}'

        out: list[str] = []
        cum = 0
        for i, (b, c) in enumerate(zip(self.buckets, counts)):
            cum += c
            out.append(f'{name}_bucket{{{labels}{sep}le="{_fmt(b)}"}} '
                       f'{cum}{_ex(i)}')
        cum += counts[-1]
        out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} '
                   f'{cum}{_ex(len(counts) - 1)}')
        out.append(f"{name}_sum{{{labels}}} {_fmt(total_sum)}"
                   if labels else f"{name}_sum {_fmt(total_sum)}")
        out.append(f"{name}_count{{{labels}}} {cum}"
                   if labels else f"{name}_count {cum}")
        return out


def quantile_from_counts(buckets: tuple[float, ...], counts: list[int],
                         q: float) -> float:
    """Quantile of a (buckets, non-cumulative counts) pair: linear
    interpolation inside the bucket, the overflow bucket clamps to the
    highest finite bound.  Counts may be a DELTA of two snapshots."""
    q = min(1.0, max(0.0, float(q)))
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    cum = 0
    lo = 0.0
    for b, c in zip(buckets, counts):
        cum += c
        if cum >= rank:
            if c == 0:
                return b
            return lo + (b - lo) * (1 - (cum - rank) / c)
        lo = b
    return buckets[-1]


class HistogramVec:
    """Histogram family keyed by one guarded label."""

    def __init__(self, buckets: Iterable[float], label: str,
                 guard: LabelGuard | None = None) -> None:
        self._buckets = tuple(buckets)
        self._label = label
        self._guard = guard or LabelGuard(max_values=32)
        self._children: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def labels(self, value: object) -> Histogram:
        key = self._guard.value(value)
        with self._lock:
            h = self._children.get(key)
            if h is None:
                h = Histogram(self._buckets)
                self._children[key] = h
            return h

    def expose(self, name: str, exemplars: bool = False) -> list[str]:
        out = [f"# TYPE {name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for key, h in children:
            out.extend(h.lines(name, f'{self._label}="{key}"',
                               exemplars=exemplars))
        return out


class NodeMetrics:
    """The three per-node histogram families, one instance per node."""

    def __init__(self, exemplars: bool = False) -> None:
        # OpenMetrics trace_id exemplars on the request-path histograms
        # (--metrics-exemplars): off by default — classic Prometheus text
        # parsers reject the suffix.
        self.exemplars = bool(exemplars)
        self.model_guard = LabelGuard(max_values=32)
        self.request_seconds = HistogramVec(
            REQUEST_BUCKETS, "model", self.model_guard)
        self.ttft_seconds = Histogram(TTFT_BUCKETS)
        self.decode_step_seconds = Histogram(DECODE_STEP_BUCKETS)
        # KV shipping (docs/KV_TRANSFER.md): fetch latency observed by the
        # fetching worker; bytes/fetches/fallbacks count page traffic on
        # whichever side moved it (a donor's exports land in the same
        # families).  Part of NodeMetrics so every node — gateway included —
        # exposes the series at zero rather than absent.
        self.kv_fetch_seconds = Histogram(TTFT_BUCKETS)
        self.kv_ship = {"bytes": 0, "fetches": 0, "fallbacks": 0,
                        "retries": 0}
        # Graceful drain + live migration (docs/ROBUSTNESS.md): drain_*
        # count control-plane events on the node that drained; the two
        # flat families count the request plane's view of migration —
        # migrated_streams on whichever side moved a stream (the gateway
        # re-routing it, the worker handing it off),
        # replayed_prefill_tokens on the successor worker: prompt tokens a
        # migrate-flagged request recomputed even though the donor could
        # have served them (0 == the KV handoff was complete).
        self.drain = {"initiated": 0, "migrated_slots": 0,
                      "rejected_requests": 0}
        self.migrated_streams = 0
        self.replayed_prefill_tokens = 0
        # Replicated gateway plane (docs/ROBUSTNESS.md "replicated
        # gateway"): gossip anti-entropy traffic + LWW map health, and
        # per-tenant admission outcomes.  In NodeMetrics (not gateway-only
        # state) so both scrape surfaces — gateway /metrics and the
        # worker-side ObsServer — expose the families at zero.
        self.gossip = {"frames_sent": 0, "frames_received": 0,
                       "entries_applied": 0, "entries_stale": 0,
                       "full_syncs": 0, "send_failures": 0,
                       "snapshot_saves": 0,
                       # gauges
                       "map_entries": 0, "snapshot_entries_loaded": 0}
        self.tenant_guard = LabelGuard(max_values=32)
        self.tenant_admitted: dict[str, int] = {}
        self.tenant_shed: dict[str, int] = {}
        self.tenant_inflight: dict[str, int] = {}

    def kv_ship_inc(self, key: str, n: int = 1) -> None:
        self.kv_ship[key] = self.kv_ship.get(key, 0) + int(n)

    def drain_inc(self, key: str, n: int = 1) -> None:
        self.drain[key] = self.drain.get(key, 0) + int(n)

    def gossip_inc(self, key: str, n: int = 1) -> None:
        self.gossip[key] = self.gossip.get(key, 0) + int(n)

    def tenant_inc(self, family: dict, tenant: str, n: int = 1) -> None:
        key = self.tenant_guard.value(tenant or "default")
        family[key] = family.get(key, 0) + int(n)

    def expose(self) -> list[str]:
        ex = self.exemplars
        out = self.request_seconds.expose("crowdllama_request_seconds",
                                          exemplars=ex)
        out.append("# TYPE crowdllama_ttft_seconds histogram")
        out.extend(self.ttft_seconds.lines("crowdllama_ttft_seconds",
                                           exemplars=ex))
        out.append("# TYPE crowdllama_decode_step_seconds histogram")
        out.extend(self.decode_step_seconds.lines(
            "crowdllama_decode_step_seconds", exemplars=ex))
        for key in ("bytes", "fetches", "fallbacks", "retries"):
            name = f"crowdllama_kv_ship_{key}_total"
            out.append(f"# TYPE {name} counter")
            out.append(f"{name} {self.kv_ship.get(key, 0)}")
        out.append("# TYPE crowdllama_kv_fetch_seconds histogram")
        out.extend(self.kv_fetch_seconds.lines("crowdllama_kv_fetch_seconds"))
        for key in ("initiated", "migrated_slots", "rejected_requests"):
            name = f"crowdllama_drain_{key}_total"
            out.append(f"# TYPE {name} counter")
            out.append(f"{name} {self.drain.get(key, 0)}")
        out.append("# TYPE crowdllama_migrated_streams_total counter")
        out.append(f"crowdllama_migrated_streams_total "
                   f"{self.migrated_streams}")
        out.append("# TYPE crowdllama_replayed_prefill_tokens_total counter")
        out.append(f"crowdllama_replayed_prefill_tokens_total "
                   f"{self.replayed_prefill_tokens}")
        for key in ("frames_sent", "frames_received", "entries_applied",
                    "entries_stale", "full_syncs", "send_failures",
                    "snapshot_saves"):
            name = f"crowdllama_gossip_{key}_total"
            out.append(f"# TYPE {name} counter")
            out.append(f"{name} {self.gossip.get(key, 0)}")
        for key in ("map_entries", "snapshot_entries_loaded"):
            name = f"crowdllama_gossip_{key}"
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name} {self.gossip.get(key, 0)}")
        for fam, kind, series in (
            ("crowdllama_tenant_admitted_total", "counter",
             self.tenant_admitted),
            ("crowdllama_tenant_shed_total", "counter", self.tenant_shed),
            ("crowdllama_tenant_inflight", "gauge", self.tenant_inflight),
        ):
            out.append(f"# TYPE {fam} {kind}")
            if not series:
                out.append(f'{fam}{{tenant="default"}} 0')
            for tenant in sorted(series):
                out.append(f'{fam}{{tenant="{tenant}"}} {series[tenant]}')
        return out


def engine_gauge_lines(gauges: dict) -> list[str]:
    """Render Engine.obs_gauges() as crowdllama_engine_* series.

    Keys are gauges except ``*_total``, which declare as counters (the
    Prometheus suffix convention — e.g. host_dispatches_total counts
    device programs launched and only ever grows).  A ``base|label=value``
    key renders as a labeled child of the ``base`` family (one TYPE line
    per family) — the duty-cycle gauges use this to keep one family
    across the four dispatch classes."""
    out: list[str] = []
    typed: set[str] = set()
    for key in sorted(gauges):
        try:
            val = float(gauges[key])
        except (TypeError, ValueError):
            continue
        base, _, label = key.partition("|")
        # Autopilot keys are their own exposition plane
        # (docs/AUTOTUNE.md): crowdllama_autotune_* rather than an
        # engine_-prefixed family, because the dials belong to the
        # control loop, not the batch-shape gauges dashboards rate().
        name = (f"crowdllama_{base}" if base.startswith("autotune_")
                else f"crowdllama_engine_{base}")
        kind = "counter" if base.endswith("_total") else "gauge"
        if name not in typed:
            typed.add(name)
            out.append(f"# TYPE {name} {kind}")
        if label:
            lname, _, lval = label.partition("=")
            out.append(f'{name}{{{lname}="{lval}"}} {_fmt(val)}')
        else:
            out.append(f"{name} {_fmt(val)}")
    return out


class EngineTelemetry:
    """Process-wide compile, padding and host-gap accounting, under the
    JAX package's family names so a scraper sees one schema swarm-wide.

    Module-level (like net/secure's aead counters) rather than hung off
    NodeObs: an engine builds before the peer wires ``engine.obs``.
    Thread-safe: a dispatch thread may record while the event loop
    scrapes.  Compile detection is first-dispatch timing per (program,
    bucket) signature; the port's kernels are built once at warmup, so on
    a torch worker the compile families stay at their zero series.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.compile_seconds = Histogram(COMPILE_BUCKETS)
        self.program_guard = LabelGuard(max_values=64)
        self.bucket_guard = LabelGuard(max_values=256)
        self._compiles: dict[tuple[str, str], int] = {}
        self._seen: set[tuple[str, str]] = set()
        # Cached-hit witness: dispatches whose
        # (program, bucket) signature was already claimed — the proof
        # that flipping a dial BACK is free (no recompile).  Keyed by
        # program only: the interesting fact is "this entry point reused
        # a signature", not which bucket did.
        self._cache_hits: dict[str, int] = {}
        self._padding = {"waste": 0, "useful": 0}
        # Unified ragged batch (docs/RAGGED_BATCH.md): wall time per
        # prefill chunk carried inside a decode dispatch.  Engine-plane
        # like the compile histogram (the scheduler's dispatch loop
        # records it), rendered on both scrape surfaces.
        self.prefill_chunk_seconds = Histogram(DECODE_STEP_BUCKETS)
        # Decode duty-cycle profiler (docs/OBSERVABILITY.md): the
        # host-side gap between one flight's retire and the next flight's
        # dispatch, per dispatch class.  Children pre-created so every
        # class renders a zero histogram from the first scrape (absent()-
        # style alerts, and the fixed allowlist IS the LabelGuard).
        self.host_gap_seconds = HistogramVec(
            DECODE_STEP_BUCKETS, "dispatch",
            LabelGuard(allowed=DISPATCH_CLASSES))
        for cls in DISPATCH_CLASSES:
            self.host_gap_seconds.labels(cls)

    def _key(self, program: str, bucket: object) -> tuple[str, str]:
        return (self.program_guard.value(program),
                self.bucket_guard.value(str(bucket)))

    def compile_begin(self, program: str, bucket: object) -> float:
        """0.0 when (program, bucket) already dispatched; otherwise claim
        the signature and return a perf_counter() start for compile_end.
        The membership probe is the only cost on the steady-state path."""
        key = self._key(program, bucket)
        with self._lock:
            if key in self._seen:
                self._cache_hits[key[0]] = \
                    self._cache_hits.get(key[0], 0) + 1
                return 0.0
            self._seen.add(key)
        return time.perf_counter()

    def compile_end(self, program: str, bucket: object, t0: float) -> None:
        if not t0:
            return
        dt = max(0.0, time.perf_counter() - t0)
        key = self._key(program, bucket)
        with self._lock:
            self._compiles[key] = self._compiles.get(key, 0) + 1
        self.compile_seconds.observe(dt)

    def padding_inc(self, useful: int, waste: int) -> None:
        """Account one padded dispatch: ``useful`` real tokens rode it,
        ``waste`` were padding (bucket rounding, inactive decode slots)."""
        with self._lock:
            self._padding["useful"] += max(0, int(useful))
            self._padding["waste"] += max(0, int(waste))

    def snapshot_compiles(self) -> dict[tuple[str, str], int]:
        """(program, bucket) -> count; tests diff two snapshots to assert
        e.g. a draft_len retune added exactly one new decode bucket."""
        with self._lock:
            return dict(self._compiles)

    def snapshot_cache_hits(self) -> dict[str, int]:
        """program -> cached-signature dispatch count; the retune test
        diffs two snapshots to prove a dial revert recompiled nothing."""
        with self._lock:
            return dict(self._cache_hits)

    def padding_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._padding)

    def expose(self) -> list[str]:
        out = ["# TYPE crowdllama_xla_compile_seconds histogram"]
        out.extend(self.compile_seconds.lines(
            "crowdllama_xla_compile_seconds"))
        with self._lock:
            compiles = sorted(self._compiles.items())
            padding = dict(self._padding)
            cache_hits = sorted(self._cache_hits.items())
        out.append("# TYPE crowdllama_xla_compiles_total counter")
        if not compiles:
            out.append('crowdllama_xla_compiles_total{program="none",'
                       'bucket="0"} 0')
        for (program, bucket), n in compiles:
            out.append(f'crowdllama_xla_compiles_total{{'
                       f'program="{program}",bucket="{bucket}"}} {n}')
        # Cached-hit witness (docs/AUTOTUNE.md): signature reuse per jit
        # entry point — a dial revert shows up here instead of as a new
        # crowdllama_xla_compiles_total child.
        out.append("# TYPE crowdllama_xla_compile_cache_hits_total counter")
        if not cache_hits:
            out.append('crowdllama_xla_compile_cache_hits_total{'
                       'program="none"} 0')
        for program, n in cache_hits:
            out.append(f'crowdllama_xla_compile_cache_hits_total{{'
                       f'program="{program}"}} {n}')
        out.append("# TYPE crowdllama_padding_waste_tokens_total counter")
        out.append(f"crowdllama_padding_waste_tokens_total "
                   f"{padding['waste']}")
        out.append("# TYPE crowdllama_useful_tokens_total counter")
        out.append(f"crowdllama_useful_tokens_total {padding['useful']}")
        out.append("# TYPE crowdllama_prefill_chunk_seconds histogram")
        out.extend(self.prefill_chunk_seconds.lines(
            "crowdllama_prefill_chunk_seconds"))
        out.extend(self.host_gap_seconds.expose(
            "crowdllama_host_gap_seconds"))
        return out


# The process-wide engine profiling plane; runners and schedulers record
# into it directly, both scrape surfaces render it.
ENGINE_TELEMETRY = EngineTelemetry()


def device_memory_lines() -> list[str]:
    """Per-device memory gauges from ``torch.cuda.memory_stats`` (bytes in
    use by the caching allocator) and the card's total memory, sampled at
    scrape time.  Without CUDA the series read 0: they must exist for
    absent()-style alerts either way."""
    out = ["# TYPE crowdllama_device_memory_bytes_in_use gauge",
           "# TYPE crowdllama_device_memory_bytes_limit gauge"]
    n = 0
    try:
        import torch

        if torch.cuda.is_available():
            n = torch.cuda.device_count()
    except Exception:
        n = 0
    if not n:
        out.append('crowdllama_device_memory_bytes_in_use{device="0"} 0')
        out.append('crowdllama_device_memory_bytes_limit{device="0"} 0')
        return out
    import torch

    for i in range(n):
        stats = torch.cuda.memory_stats(i)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        limit = int(torch.cuda.get_device_properties(i).total_memory)
        out.append(f'crowdllama_device_memory_bytes_in_use{{'
                   f'device="{i}"}} {in_use}')
        out.append(f'crowdllama_device_memory_bytes_limit{{'
                   f'device="{i}"}} {limit}')
    return out
