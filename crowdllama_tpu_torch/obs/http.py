"""A worker's metric exposition, one composition for every scrape surface.

Counterpart of ``crowdllama_tpu/obs/http.py``'s line builders:
``node_metric_lines`` is the payload a ``MetricsSnapshot`` carries over
the p2p plane (the gateway's cluster scrape), in the JAX worker's
families: the node's histograms, the engine gauges, the engine telemetry
plane, device memory and the host's stream counters.  The native data
plane is not ported, so ``crowdllama_native_enabled`` reads 0 and there
is no fallback counter.  The aiohttp listener (``ObsServer``) is not
ported.
"""

from __future__ import annotations

import logging

from crowdllama_tpu_torch.obs.metrics import (
    ENGINE_TELEMETRY,
    device_memory_lines,
    engine_gauge_lines,
)

log = logging.getLogger("crowdllama.torch.obs")


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
    # Every rung at zero too (the port climbs only "direct"), so
    # dashboards rate() without sparse-series gaps.
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
    lines.extend(["# TYPE crowdllama_native_enabled gauge",
                  "crowdllama_native_enabled 0"])
    return lines
