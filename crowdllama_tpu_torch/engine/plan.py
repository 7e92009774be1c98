"""Serving-plan resolution: which runner a Configuration builds.

Counterpart of the one-device subset of ``crowdllama_tpu/engine/plan.py``
``resolve_serving_plan``: the paged and the contiguous layout with a bf16
or int8 KV cache, bf16 weights and no speculation.  Every other
combination raises ``NotImplementedError`` naming the ROADMAP item that
will port it; nothing falls back silently.
"""

from __future__ import annotations

from dataclasses import dataclass

# What is not ported yet, and the ROADMAP Queue 1 item that ports it.
_NOT_PORTED = {
    "quantize": ("", "quantized weights (ROADMAP Queue 1 item 10)"),
    "spec_decode": ("", "speculative decoding (ROADMAP Queue 1 item 4)"),
    "mesh_shape": ("", "multi-device meshes (ROADMAP Queue 1 item 8)"),
}


@dataclass
class ServingPlan:
    """What the engine builds for a Configuration."""

    runner: str       # "ModelRunner" | "PagedModelRunner"
    kv_layout: str
    kv_dtype: str = "bf16"


def resolve_serving_plan(config) -> ServingPlan:
    """The runner ``config`` serves with on one device; raises
    ``NotImplementedError`` for an axis the port does not carry yet."""
    for axis, (ported, what) in _NOT_PORTED.items():
        value = getattr(config, axis)
        if value != ported:
            raise NotImplementedError(
                f"{axis}={value!r} is not ported to crowdllama_tpu_torch "
                f"yet: {what}")
    runner = {"paged": "PagedModelRunner",
              "contiguous": "ModelRunner"}[config.kv_layout]
    return ServingPlan(runner=runner, kv_layout=config.kv_layout,
                       kv_dtype=config.kv_dtype)
