"""Serving-plan resolution: which runner a Configuration builds.

Counterpart of the ported subset of ``crowdllama_tpu/engine/plan.py``
``resolve_serving_plan``: the paged and the contiguous layout with a bf16
or int8 KV cache and bf16, int8 or int4 weights (``quantize``), on one
device, and the paged layout tensor-parallel over a tp mesh
(``mesh_shape="2"``); the spec axis as the
JAX plan composes it (paged + ngram: ``SpecPagedModelRunner``, paged +
draft: ``DraftSpecPagedModelRunner``, contiguous + ngram:
``SpecModelRunner``; draft on the contiguous layout and ngram on the
contiguous int8 cache raise ``ValueError``).  Every other mesh raises
``NotImplementedError`` naming the ROADMAP item that will port it;
nothing falls back silently (the JAX package moves a paged request on a
dp/sp/pp mesh to the contiguous layout; the port refuses it).  ``megastep_k > 0`` needs every tp rank on one device (each
flight is one CUDA graph there): :func:`check_megastep` refuses ranks on
distinct devices.
"""

from __future__ import annotations

from dataclasses import dataclass

from crowdllama_tpu_torch.parallel.mesh import AXES, mesh_axes

_RUNNERS = {("paged", ""): "PagedModelRunner",
            ("paged", "ngram"): "SpecPagedModelRunner",
            ("paged", "draft"): "DraftSpecPagedModelRunner",
            ("contiguous", ""): "ModelRunner",
            ("contiguous", "ngram"): "SpecModelRunner"}
_MESHES = ("meshes other than tp on the paged layout (contiguous tp, dp, "
           "sp, pp, ep: ROADMAP Queue 1 item 8)")


@dataclass
class ServingPlan:
    """What the engine builds for a Configuration."""

    runner: str       # a name of ``_RUNNERS``
    kv_layout: str
    kv_dtype: str = "bf16"
    quantize: str = ""  # "" (the compute dtype) | "int8" | "int4" weights
    mesh_shape: str = ""  # "" = one device, or the paged default mesh
    spec: str = ""    # "" | "ngram" | "draft"


def megastep_allowed(devices) -> bool:
    """False when the tp ranks (``devices``) sit on distinct devices: a
    megastep flight is one CUDA graph on one device, and graphs across
    devices are not ported."""
    return len({str(d) for d in devices or ()}) <= 1


def check_megastep(megastep_k: int, devices) -> None:
    """Refuse ``megastep_k > 0`` where :func:`megastep_allowed` is
    false."""
    if megastep_k > 0 and not megastep_allowed(devices):
        names = {str(d) for d in devices}
        raise ValueError(
            f"megastep_k={megastep_k} with tp ranks on distinct devices "
            f"{sorted(names)} is not ported to crowdllama_tpu_torch yet: "
            f"{_MESHES}")


def resolve_serving_plan(config, devices=None) -> ServingPlan:
    """The runner ``config`` serves with; raises ``NotImplementedError``
    for an axis the port does not carry yet.  A mesh spec is checked for
    its axes only; the runner checks it against the devices.  With
    ``megastep_k > 0`` the tp ranks must share one device: ``devices`` as
    the engine places them, or, without a list, a tp mesh (its default
    ranks are distinct devices) is refused with a ``ValueError``."""
    shape = mesh_axes(config.mesh_shape)
    if shape is not None:
        axes = dict(zip(AXES, shape))
        if max(shape[:-1]) > 1 or (shape[-1] > 1
                                   and config.kv_layout != "paged"):
            raise NotImplementedError(
                f"mesh_shape={config.mesh_shape!r} {axes} on the "
                f"{config.kv_layout} layout is not ported to "
                f"crowdllama_tpu_torch yet: {_MESHES}")
    megastep_k = getattr(config, "megastep_k", 0)
    if devices is not None:
        check_megastep(megastep_k, devices)
    elif megastep_k > 0 and shape is not None and shape[-1] > 1:
        raise ValueError(
            f"megastep_k={megastep_k} on mesh_shape={config.mesh_shape!r} "
            f"(its tp ranks take distinct devices) is not ported to "
            f"crowdllama_tpu_torch yet: {_MESHES}")
    spec = config.spec_decode
    if config.kv_layout == "contiguous":
        if spec == "draft":
            raise ValueError(
                "draft-model speculation runs on the paged layout only")
        if spec == "ngram" and config.kv_dtype != "bf16":
            raise ValueError(
                "spec_decode on the contiguous layout requires the bf16 KV "
                "cache (the verify forward reads the cache as bf16 context)")
    return ServingPlan(runner=_RUNNERS[(config.kv_layout, spec)],
                       kv_layout=config.kv_layout, kv_dtype=config.kv_dtype,
                       quantize=config.quantize,
                       mesh_shape=config.mesh_shape, spec=spec)
