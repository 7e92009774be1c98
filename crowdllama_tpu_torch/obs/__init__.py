"""Per-node observability plane: request tracing + histogram metrics.

Counterpart of ``crowdllama_tpu/obs/__init__.py``: every node owns one
:class:`NodeObs` holding a bounded :class:`~.trace.TraceBuffer` of
per-request span trees and a :class:`~.metrics.NodeMetrics` bundle, both
served over the p2p plane (``trace_fetch`` / ``metrics_fetch`` on the
inference stream).  Trace ids ride the llama.v1 envelope (``trace_id`` /
``parent_span``), so one id follows a request gateway -> peer -> engine.
``GATEWAY_ROOT_SPAN`` names the gateway's root span, the parent every
worker-side span of a routed request points at.  The HTTP listeners are
the gateway's and ``obs/http.py``'s ``ObsServer`` (a worker's
``--worker-metrics-port``); ``obs/collector.py`` stitches traces across
nodes, ``obs/cluster.py`` scrapes the swarm's metrics and ``obs/slo.py``
keeps the gateway's burn rates.
"""

from __future__ import annotations

from crowdllama_tpu_torch.obs.metrics import NodeMetrics
from crowdllama_tpu_torch.obs.trace import TraceBuffer, new_trace_id

__all__ = ["GATEWAY_ROOT_SPAN", "NodeObs", "new_trace_id"]

GATEWAY_ROOT_SPAN = "gateway"


class NodeObs:
    """One node's tracing + metrics state.  ``trace_ttl`` (seconds, 0 =
    off) age-evicts span fragments; ``exemplars`` enables the OpenMetrics
    trace_id exemplar suffix on the request-path histograms."""

    def __init__(self, trace_capacity: int = 64, node: str = "",
                 trace_ttl: float = 0.0, exemplars: bool = False) -> None:
        self.node = node
        self.trace = TraceBuffer(capacity=trace_capacity, node=node,
                                 ttl=trace_ttl)
        self.metrics = NodeMetrics(exemplars=exemplars)

    def observe_generate(self, trace_id: str, parent: str, model: str,
                         queue_ns: int, prefill_ns: int, decode_ns: int,
                         steps: int, total_ns: int, **meta) -> None:
        """Record one served generate exchange: the worker-side spans
        (worker_queue / prefill / decode_step) and the histograms."""
        self.metrics.request_seconds.labels(model).observe(
            total_ns / 1e9, exemplar=trace_id)
        self.metrics.ttft_seconds.observe(
            (queue_ns + prefill_ns) / 1e9, exemplar=trace_id)
        if trace_id:
            t = self.trace
            t.begin(trace_id, model=model, **meta)
            t.record(trace_id, "worker_queue", queue_ns, parent=parent)
            t.record(trace_id, "prefill", prefill_ns, parent=parent)
            t.record(trace_id, "decode_step", decode_ns, parent=parent,
                     steps=steps)
            t.finish(trace_id, total_ns)
