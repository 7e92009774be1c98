"""Swarm-level control loops: the elastic drain/scale controller."""

from crowdllama_tpu_torch.swarm.autoscale import (
    AutoscaleConfig,
    AutoscaleController,
    Decision,
    Sample,
    parse_gauges,
    pick_drain_candidate,
    simulate,
)

__all__ = [
    "AutoscaleConfig",
    "AutoscaleController",
    "Decision",
    "Sample",
    "parse_gauges",
    "pick_drain_candidate",
    "simulate",
]
