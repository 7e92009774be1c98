"""Serving-plan resolution: which runner a Configuration builds.

Counterpart of ``crowdllama_tpu/engine/plan.py``, line for line: the
layout x kv_dtype x quantize x spec x mesh composition as one table.  A
paged request on a dp/sp/pp mesh falls back LOUDLY to the contiguous
layout (the shared page pool cannot shard over dp; sp and pp run on the
contiguous layout): the plan records the reason in ``notes`` and the
engine logs it.  Draft-model speculation on such a mesh, ngram
speculation with an int8 KV cache there, and int8 KV or speculation on an
sp/pp mesh raise ``ValueError``, as in the JAX package.  ``MESH_KINDS``,
:func:`sweep` and :func:`render_markdown` are JAX's; ``python -m
crowdllama_tpu_torch.engine.plan`` prints the port's composition table.

Multi-process serving (``n_processes > 1``, leader-replicated dispatch
through ``parallel/replicated.py``) imposes no composition rule of its
own, as in JAX: the ``multihost-tp`` rows equal the ``tp`` rows.  Which
axes of a mesh may cross processes is the runner's check
(``engine/runner.py``).  One rule is the port's own: ``megastep_k > 0``
needs every rank of the mesh on one device (each flight is one CUDA
graph there): :func:`check_megastep` refuses ranks on distinct devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from crowdllama_tpu_torch.parallel.mesh import mesh_axes

_RUNNERS = {("paged", ""): "PagedModelRunner",
            ("paged", "ngram"): "SpecPagedModelRunner",
            ("paged", "draft"): "DraftSpecPagedModelRunner",
            ("contiguous", ""): "ModelRunner",
            ("contiguous", "ngram"): "SpecModelRunner"}
GRAPHS_ACROSS_DEVICES = ("megastep graphs across distinct devices "
                         "(ROADMAP Queue 1 item 8.3)")
ACROSS_PROCESSES = ("sp, pp and ep groups, and speculation on a dp axis, "
                    "across processes (ROADMAP Queue 1 item 8.2b)")


@dataclass
class ServingPlan:
    """What the engine builds for a Configuration."""

    runner: str       # a name of ``_RUNNERS``
    kv_layout: str    # the effective layout ("paged" may fall back)
    kv_dtype: str = "bf16"
    quantize: str = ""  # "" (the compute dtype) | "int8" | "int4" weights
    mesh_shape: str = ""  # "" = one device, or the paged default mesh
    spec: str = ""    # "" | "ngram" | "draft"
    notes: list[str] = field(default_factory=list)  # loud fallbacks

    @property
    def fallback(self) -> bool:
        return bool(self.notes)


def megastep_allowed(devices) -> bool:
    """False when the mesh's ranks (``devices``) sit on distinct devices:
    a megastep flight is one CUDA graph on one device."""
    return len({str(d) for d in devices or ()}) <= 1


def check_megastep(megastep_k: int, devices) -> None:
    """Refuse ``megastep_k > 0`` where :func:`megastep_allowed` is
    false."""
    if megastep_k > 0 and not megastep_allowed(devices):
        names = {str(d) for d in devices}
        raise ValueError(
            f"megastep_k={megastep_k} with mesh ranks on distinct devices "
            f"{sorted(names)} is not ported to crowdllama_tpu_torch yet: "
            f"{GRAPHS_ACROSS_DEVICES}")


def resolve_serving_plan(config, devices=None,
                         n_processes: int = 1) -> ServingPlan:
    """Decide the runner class and the effective KV layout for ``config``.

    Raises ``ValueError`` for the combinations that must not serve (the
    table's error cells), appends to ``notes`` for the documented loud
    fallback; ``n_processes`` changes nothing (every runner the
    one-process table serves is framed).  A mesh spec is checked for its axes only; the runner checks it against
    the devices.  With ``megastep_k > 0`` the mesh's ranks must share one
    device: ``devices`` as the engine places them, or, without a list, a
    mesh of more than one rank (its default ranks are distinct devices) is
    refused with a ``ValueError``."""
    del n_processes
    shape = mesh_axes(config.mesh_shape) or (1, 1, 1, 1, 1)
    dp, pp, sp, _ep, _tp = shape
    megastep_k = getattr(config, "megastep_k", 0)
    if devices is not None:
        check_megastep(megastep_k, devices)
    elif megastep_k > 0 and math.prod(shape) > 1:
        raise ValueError(
            f"megastep_k={megastep_k} on mesh_shape={config.mesh_shape!r} "
            f"(its ranks take distinct devices) is not ported to "
            f"crowdllama_tpu_torch yet: {GRAPHS_ACROSS_DEVICES}")

    notes: list[str] = []
    kv_layout = config.kv_layout
    spec = config.spec_decode
    if kv_layout == "paged" and (dp > 1 or pp > 1 or sp > 1):
        # The shared page pool cannot shard over dp (pages belong to no
        # fixed slot) and sp/pp operate on the contiguous layout.
        if spec == "draft":
            raise ValueError(
                f"draft-model speculation needs the paged layout, which "
                f"does not compose with mesh {config.mesh_shape} "
                f"(dp/sp/pp > 1)")
        if spec == "ngram" and config.kv_dtype != "bf16":
            raise ValueError(
                f"spec_decode + kv_dtype=int8 needs the paged layout, "
                f"which does not compose with mesh {config.mesh_shape} "
                f"(dp/sp/pp > 1); drop one of spec_decode / int8 KV / "
                f"the mesh")
        notes.append(f"paged layout does not compose with mesh "
                     f"{config.mesh_shape} (dp/sp/pp > 1); using the "
                     f"contiguous layout")
        kv_layout = "contiguous"

    if kv_layout == "contiguous":
        if spec == "draft":
            raise ValueError(
                "draft-model speculation runs on the paged layout only")
        if config.kv_dtype == "int8" and (pp > 1 or sp > 1):
            raise ValueError(
                "int8 KV cache does not compose with sp/pp meshes yet")
        if spec == "ngram" and (pp > 1 or sp > 1):
            raise ValueError(
                "speculative decode does not compose with sp/pp meshes yet")
        if spec == "ngram" and config.kv_dtype != "bf16":
            raise ValueError(
                "spec_decode on the contiguous layout requires the bf16 KV "
                "cache (the verify forward reads the cache as bf16 context)")
    return ServingPlan(runner=_RUNNERS[(kv_layout, spec)],
                       kv_layout=kv_layout, kv_dtype=config.kv_dtype,
                       quantize=config.quantize,
                       mesh_shape=config.mesh_shape, spec=spec, notes=notes)


# --------------------------------------------------------- table generator

#: Representative mesh per kind, JAX's: ep rides along with tp for MoE
#: models and changes nothing about the KV axes, so it is not a row.  The
#: multihost-tp kind runs the tp mesh with n_processes=2.
MESH_KINDS = (
    ("single", "1"),
    ("tp", "2"),
    ("dp", "2x1x1x1x1"),
    ("pp", "1x2x1x1x1"),
    ("sp", "1x1x2x1x1"),
    ("multihost-tp", "2"),
)


def sweep():
    """Yield (axes, outcome) for the full composition product: outcome is
    ("ok" | "fallback", ServingPlan) or ("error", message)."""
    from crowdllama_tpu_torch.config import Configuration

    for mesh_kind, mesh in MESH_KINDS:
        for layout in ("paged", "contiguous"):
            for kv_dtype in ("bf16", "int8"):
                for quantize in ("", "int8"):
                    for spec in ("", "ngram", "draft"):
                        axes = dict(mesh_kind=mesh_kind, mesh=mesh,
                                    layout=layout, kv_dtype=kv_dtype,
                                    quantize=quantize, spec=spec)
                        try:
                            cfg = Configuration.from_environment(
                                kv_layout=layout, kv_dtype=kv_dtype,
                                quantize=quantize, spec_decode=spec,
                                spec_draft_model=(
                                    "tiny-test" if spec == "draft" else ""),
                                mesh_shape=mesh)
                            plan = resolve_serving_plan(
                                cfg, n_processes=(
                                    2 if mesh_kind.startswith("multihost")
                                    else 1))
                        except ValueError as e:
                            yield axes, ("error", str(e))
                            continue
                        yield axes, ("fallback" if plan.fallback else "ok",
                                     plan)


def render_markdown() -> str:
    """The composition table, generated from the live sweep."""
    lines = [
        "| mesh | layout | KV dtype | weights | spec | outcome |",
        "|---|---|---|---|---|---|",
    ]
    for axes, (status, detail) in sweep():
        if status == "error":
            outcome = f"✗ error: {detail}"
        elif status == "fallback":
            outcome = f"⚠ {detail.runner} — {'; '.join(detail.notes)}"
        else:
            outcome = f"✓ {detail.runner}"
        lines.append(
            f"| {axes['mesh_kind']} | {axes['layout']} | {axes['kv_dtype']} "
            f"| {axes['quantize'] or 'bf16'} | {axes['spec'] or '—'} "
            f"| {outcome} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(render_markdown())
