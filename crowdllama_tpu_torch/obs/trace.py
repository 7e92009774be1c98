"""Bounded per-node ring buffer of request span trees.

Counterpart of ``crowdllama_tpu/obs/trace.py``: one :class:`TraceBuffer`
per node; the worker records worker_queue / prefill / decode_step /
stream_flush spans keyed by the ``trace_id`` on the llama.v1 envelope, so
joining every node's records on that id reconstructs the request path.
Thread-safe: the event loop and a scheduler thread may record at once.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any


def new_trace_id() -> str:
    """64-bit random hex id, minted at the gateway per inference request."""
    return os.urandom(8).hex()


@dataclass
class Span:
    name: str
    dur_ns: int
    parent: str = ""
    start_ns: int = 0  # offset from trace start (monotonic), best-effort
    meta: dict = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "dur_us": round(self.dur_ns / 1e3, 1),
            "start_us": round(self.start_ns / 1e3, 1),
        }
        if self.parent:
            d["parent"] = self.parent
        if self.meta:
            d["meta"] = self.meta
        return d


class _TraceRecord:
    __slots__ = ("trace_id", "started_unix", "t0_ns", "total_ns", "meta",
                 "spans", "done")

    def __init__(self, trace_id: str, meta: dict) -> None:
        self.trace_id = trace_id
        self.started_unix = time.time()
        self.t0_ns = time.monotonic_ns()
        self.total_ns = 0
        self.meta = meta
        self.spans: list[Span] = []
        self.done = False

    def to_json(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "started_at": round(self.started_unix, 3),
            "total_us": round(self.total_ns / 1e3, 1),
            "done": self.done,
            "meta": self.meta,
            "spans": [s.to_json() for s in self.spans],
        }


# Spans per trace are bounded so a pathological request (or a decode loop
# recording per-step spans by mistake) cannot grow a record without limit.
_MAX_SPANS_PER_TRACE = 64


class TraceBuffer:
    """Bounded ring of the last N requests' span trees, oldest evicted.

    ``ttl`` (seconds, 0 = off) additionally age-evicts: a long-lived,
    lightly-loaded worker must not serve week-old fragments to the trace
    collector as if they described the request being debugged."""

    def __init__(self, capacity: int = 64, node: str = "",
                 ttl: float = 0.0) -> None:
        self.capacity = max(1, int(capacity))
        self.node = node
        self.ttl = max(0.0, float(ttl))
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, _TraceRecord] = OrderedDict()

    def _evict_expired(self) -> None:
        """Drop records older than the TTL (caller holds the lock).  The
        ring is insertion-ordered, so expiry scans stop at the first
        still-fresh record."""
        if not self.ttl:
            return
        cutoff = time.time() - self.ttl
        while self._traces:
            oldest = next(iter(self._traces.values()))
            if oldest.started_unix >= cutoff:
                break
            self._traces.popitem(last=False)

    def _get_or_create(self, trace_id: str, meta: dict) -> _TraceRecord:
        self._evict_expired()
        rec = self._traces.get(trace_id)
        if rec is None:
            rec = _TraceRecord(trace_id, meta)
            self._traces[trace_id] = rec
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)
        elif meta:
            rec.meta.update(meta)
        return rec

    def begin(self, trace_id: str, **meta) -> None:
        if not trace_id:
            return
        with self._lock:
            self._get_or_create(trace_id, meta)

    def record(self, trace_id: str, name: str, dur_ns: int | float,
               parent: str = "", start_ns: int | None = None, **meta) -> None:
        """Append one span; creates the trace record if begin() was skipped.

        ``start_ns`` is the span's absolute monotonic_ns start; when omitted
        the span is assumed to have just ended (offset = now - dur - t0).
        """
        if not trace_id:
            return
        dur = max(0, int(dur_ns))
        now = time.monotonic_ns()
        with self._lock:
            rec = self._get_or_create(trace_id, {})
            if len(rec.spans) >= _MAX_SPANS_PER_TRACE:
                return
            abs_start = now - dur if start_ns is None else int(start_ns)
            rec.spans.append(Span(name=name, dur_ns=dur, parent=parent,
                                  start_ns=max(0, abs_start - rec.t0_ns),
                                  meta=dict(meta) if meta else {}))

    def finish(self, trace_id: str, total_ns: int | float = 0, **meta) -> None:
        if not trace_id:
            return
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return
            rec.done = True
            rec.total_ns = int(total_ns) or (time.monotonic_ns() - rec.t0_ns)
            if meta:
                rec.meta.update(meta)

    def get(self, trace_id: str) -> dict[str, Any] | None:
        with self._lock:
            self._evict_expired()
            rec = self._traces.get(trace_id)
            return rec.to_json() if rec is not None else None

    def snapshot(self, trace_id: str = "",
                 limit: int = 0) -> dict[str, Any]:
        """JSON-ready dump, oldest first, for ``GET /debug/trace``.

        ``trace_id`` filters to one trace; ``limit`` keeps only the N
        NEWEST records (the ones a debugging operator is after)."""
        with self._lock:
            self._evict_expired()
            if trace_id:
                rec = self._traces.get(trace_id)
                traces = [rec.to_json()] if rec is not None else []
            else:
                traces = [rec.to_json() for rec in self._traces.values()]
        if limit > 0:
            traces = traces[-limit:]
        return {"node": self.node, "capacity": self.capacity,
                "traces": traces}
