"""A worker's metric exposition and its HTTP listener.

Counterpart of ``crowdllama_tpu/obs/http.py``: ``node_metric_lines`` is
one composition for both scrape surfaces, the payload a
``MetricsSnapshot`` carries over the p2p plane (the gateway's cluster
scrape) and :class:`ObsServer`'s ``/metrics``, in the JAX worker's
families: the node's histograms, the engine gauges, the engine telemetry
plane, device memory and the host's stream counters.  ``ObsServer`` (a
worker's ``--worker-metrics-port``) also serves ``/debug/trace`` and
``POST /drain``, on the port's own HTTP plane (``net/http.py``).

``native_metric_lines`` (the ``crowdllama_native_*`` families: whether
the native data plane serves this process, and its Python-path dispatches
per component) closes both the worker's and the gateway's exposition.
"""

from __future__ import annotations

import logging

from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.net import http
from crowdllama_tpu_torch.obs.metrics import (
    ENGINE_TELEMETRY,
    device_memory_lines,
    engine_gauge_lines,
)

log = logging.getLogger("crowdllama.torch.obs")


def native_metric_lines() -> list[str]:
    """Native data-plane health: a gauge for whether the C++ path serves
    this process, and a counter of every dispatch to the Python path per
    component (each label always present, so dashboards rate() without
    sparse-series gaps)."""
    st = native.stats()
    lines = [
        "# TYPE crowdllama_native_enabled gauge",
        f"crowdllama_native_enabled {1 if st['enabled'] else 0}",
        "# TYPE crowdllama_native_fallbacks_total counter",
    ]
    components = {"aead": 0, "envelope": 0, "frame_scan": 0}
    components.update(st["fallbacks"])
    for comp, v in sorted(components.items()):
        lines.append(
            f'crowdllama_native_fallbacks_total{{component="{comp}"}} {v}')
    return lines


def host_stat_lines(host) -> list[str]:
    """Host stream-path counters, the JAX worker's series."""
    lines = ["# TYPE crowdllama_host_streams_total counter"]
    for k, v in sorted(host.stats.items()):
        if k.startswith("streams_"):
            lines.append(f'crowdllama_host_streams_total{{kind="{k}"}} {v}')
    lines.append("# TYPE crowdllama_host_rejected_total counter")
    lines.append(
        f"crowdllama_host_rejected_total {host.stats.get('rejected', 0)}")
    lines.append("# TYPE crowdllama_host_handshake_seconds_total counter")
    lines.append(
        f"crowdllama_host_handshake_seconds_total "
        f"{host.stats.get('handshake_ns', 0) / 1e9:.6f}")
    # Every rung at zero too, so dashboards rate() without sparse-series
    # gaps.
    lines.append("# TYPE crowdllama_dial_ladder_attempts_total counter")
    for rung in ("direct", "reverse", "punch", "splice"):
        for outcome in ("ok", "fail"):
            v = host.dial_ladder.get((rung, outcome), 0)
            lines.append(
                f'crowdllama_dial_ladder_attempts_total'
                f'{{rung="{rung}",outcome="{outcome}"}} {v}')
    return lines


def node_metric_lines(peer) -> list[str]:
    """The full worker-side exposition."""
    lines = peer.obs.metrics.expose()
    engine = getattr(peer, "engine", None)
    if engine is not None:
        try:
            lines.extend(engine_gauge_lines(engine.obs_gauges()))
        except Exception as e:  # a sick engine must not break the scrape
            log.debug("engine gauges unavailable: %s", e)
    lines.extend(ENGINE_TELEMETRY.expose())
    lines.extend(device_memory_lines())
    lines.extend(host_stat_lines(peer.host))
    lines.extend(native_metric_lines())
    return lines


class ObsServer:
    """A worker's metrics / trace / drain endpoint."""

    def __init__(self, peer, host: str = "127.0.0.1", port: int = 0) -> None:
        self.peer = peer
        self.host = host
        self.port = port
        self._server: http.Server | None = None
        self.app = http.Application()
        self.app.router.add_get("/metrics", self.handle_metrics)
        self.app.router.add_get("/debug/trace", self.handle_trace)
        # The operator's drain hook: SIGTERM's graceful path over HTTP.
        self.app.router.add_post("/drain", self.handle_drain)

    async def start(self) -> None:
        self._server = http.Server(self.app, self.host, self.port)
        await self._server.start()
        self.port = self._server.port  # port=0 binds an ephemeral one
        log.info("worker obs endpoint on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None

    async def handle_metrics(self, request: http.Request) -> http.Response:
        return http.Response(
            text="\n".join(node_metric_lines(self.peer)) + "\n",
            content_type="text/plain")

    async def handle_trace(self, request: http.Request) -> http.Response:
        """``?trace_id=`` filters to one trace, ``?limit=N`` keeps the N
        newest records, as the gateway's."""
        try:
            limit = max(0, int(request.query.get("limit", "0") or 0))
        except ValueError:
            limit = 0
        return http.json_response(self.peer.obs.trace.snapshot(
            trace_id=request.query.get("trace_id", ""), limit=limit))

    async def handle_drain(self, request: http.Request) -> http.Response:
        already = bool(self.peer._draining)
        migrated = await self.peer.drain()
        return http.json_response({
            "draining": True,
            "already_draining": already,
            "migrated_streams": migrated,
        })
