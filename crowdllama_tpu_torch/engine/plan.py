"""Serving-plan resolution: which runner a Configuration builds.

Counterpart of the ported subset of ``crowdllama_tpu/engine/plan.py``
``resolve_serving_plan``: the paged and the contiguous layout with a bf16
or int8 KV cache, bf16 weights and no speculation, on one device, and the
paged layout tensor-parallel over a tp mesh (``mesh_shape="2"``).  Every
other combination raises ``NotImplementedError`` naming the ROADMAP item
that will port it; nothing falls back silently (the JAX package moves a
paged request on a dp/sp/pp mesh to the contiguous layout; the port
refuses it).
"""

from __future__ import annotations

from dataclasses import dataclass

from crowdllama_tpu_torch.parallel.mesh import AXES, mesh_axes

# What is not ported yet, and the ROADMAP Queue 1 item that ports it.
_NOT_PORTED = {
    "quantize": ("", "quantized weights (ROADMAP Queue 1 item 10)"),
    "spec_decode": ("", "speculative decoding (ROADMAP Queue 1 item 4)"),
}
_MESHES = ("meshes other than tp on the paged layout (contiguous tp, dp, "
           "sp, pp, ep: ROADMAP Queue 1 item 8)")


@dataclass
class ServingPlan:
    """What the engine builds for a Configuration."""

    runner: str       # "ModelRunner" | "PagedModelRunner"
    kv_layout: str
    kv_dtype: str = "bf16"
    mesh_shape: str = ""  # "" = one device, or the paged default mesh


def resolve_serving_plan(config) -> ServingPlan:
    """The runner ``config`` serves with; raises ``NotImplementedError``
    for an axis the port does not carry yet.  A mesh spec is checked for
    its axes only; the runner checks it against the devices."""
    for axis, (ported, what) in _NOT_PORTED.items():
        value = getattr(config, axis)
        if value != ported:
            raise NotImplementedError(
                f"{axis}={value!r} is not ported to crowdllama_tpu_torch "
                f"yet: {what}")
    shape = mesh_axes(config.mesh_shape)
    if shape is not None:
        axes = dict(zip(AXES, shape))
        if max(shape[:-1]) > 1 or (shape[-1] > 1
                                   and config.kv_layout != "paged"):
            raise NotImplementedError(
                f"mesh_shape={config.mesh_shape!r} {axes} on the "
                f"{config.kv_layout} layout is not ported to "
                f"crowdllama_tpu_torch yet: {_MESHES}")
    runner = {"paged": "PagedModelRunner",
              "contiguous": "ModelRunner"}[config.kv_layout]
    return ServingPlan(runner=runner, kv_layout=config.kv_layout,
                       kv_dtype=config.kv_dtype,
                       mesh_shape=config.mesh_shape)
