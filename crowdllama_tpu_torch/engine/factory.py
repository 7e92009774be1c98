"""Runner construction from a Configuration and its ServingPlan.

Counterpart of ``crowdllama_tpu/engine/factory.py``: ONE builder shared
by the leader engine (``engine/engine.py``) and the multi-process
follower loop (``parallel/replicated.py run_follower``), because the
leader-replicated dispatch depends on every process building the same
runner (class, mesh, pool geometry, params):
:func:`build_process_runner` resolves the plan, the model config and the
params, then :func:`build_runner` builds the plan's runner (its layout after a fallback) on one
device or over the mesh ``config.mesh_shape`` names (ranks on
``devices``, else the visible CUDA devices), quantizing the weights as
the plan says.  The draft-model
runner's draft comes from ``spec_draft_path`` (a native checkpoint, which
carries its own
architecture, or an HF checkpoint of ``spec_draft_model``'s
architecture) or, without one, is ``spec_draft_model`` from the registry
on random weights (seed 0).
"""

from __future__ import annotations

import dataclasses

import torch


def draft_model(config, cfg, dtype: torch.dtype = torch.bfloat16):
    """(draft ModelConfig, its parameter dict on the host or None for a
    random init) for ``spec_decode="draft"``, at the main model's
    context: a native checkpoint carries its own architecture; otherwise
    the architecture is ``spec_draft_model``'s registry entry, with an HF
    ``spec_draft_path``'s weights."""
    from crowdllama_tpu_torch.engine.weights import (
        is_native_checkpoint,
        load_or_init_params,
        native_config_from_dir,
    )
    from crowdllama_tpu_torch.models.config import get_config

    path = config.spec_draft_path
    if path and is_native_checkpoint(path):
        draft_cfg = dataclasses.replace(
            native_config_from_dir(path),
            max_context_length=cfg.max_context_length)
    else:
        draft_cfg = get_config(config.spec_draft_model,
                               max_context_length=cfg.max_context_length)
    if not path:
        return draft_cfg, None
    return draft_cfg, load_or_init_params(draft_cfg, path, dtype=dtype)


def process_devices(config, device=None) -> list | None:
    """This process's devices under multi-process serving (None in one
    process): on the CPU (``device`` or ``config.device`` "cpu") the
    ``size / n`` ranks of the mesh ``config.mesh_shape`` names (one
    without a spec), else the visible CUDA devices (the mesh takes a
    prefix)."""
    import math

    from crowdllama_tpu_torch.parallel import multihost
    from crowdllama_tpu_torch.parallel.mesh import mesh_axes, visible_devices

    n = multihost.process_count()
    if n == 1:
        return None
    if str(device or getattr(config, "device", "cuda")).startswith("cpu"):
        shape = mesh_axes(config.mesh_shape)
        return ["cpu"] * (math.prod(shape) // n if shape else 1)
    devs = visible_devices()
    if not devs:
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return devs


def build_process_runner(config, *, devices=None, device=None, params=None,
                         dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                         model_config=None):
    """(runner, plan, model config, host seconds to load ``model_path``):
    the serving plan for this process count, the model config (the
    registry's, clamped to ``max_context_length``, or ``model_config``
    clamped the same way), the params (``params``, else ``model_path``'s,
    else the runner's seeded init) and the plan's runner over
    ``devices``."""
    import time

    from crowdllama_tpu_torch.engine.plan import resolve_serving_plan
    from crowdllama_tpu_torch.engine.weights import (
        load_params_for,
        resolve_clamped_model_config,
    )
    from crowdllama_tpu_torch.parallel import multihost

    plan = resolve_serving_plan(config, devices=devices,
                                n_processes=multihost.process_count())
    if model_config is not None:
        cfg = model_config
        if config.max_context_length:
            cfg = dataclasses.replace(cfg, max_context_length=min(
                cfg.max_context_length, config.max_context_length))
    else:
        cfg = resolve_clamped_model_config(config)
    load_s = 0.0
    if params is None and config.model_path:
        # Loaded on the host; the runner places (and under tp shards) it.
        # Without a path the runner makes its seeded init.
        t0 = time.perf_counter()
        params = load_params_for(config, cfg, dtype=dtype)
        load_s = time.perf_counter() - t0
    runner = build_runner(config, plan, cfg, params, dtype=dtype, seed=seed,
                          device=device, devices=devices)
    return runner, plan, cfg, load_s


def build_runner(config, plan, cfg, params=None, *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device=None, devices: list | None = None):
    """Instantiate the runner ``plan`` names for model ``cfg``."""
    kwargs = dict(params=params, max_slots=config.max_batch_slots,
                  max_seq=cfg.max_context_length, dtype=dtype, seed=seed,
                  device=device, kv_dtype=plan.kv_dtype,
                  quantize=plan.quantize, mesh_shape=plan.mesh_shape,
                  devices=devices)
    if plan.spec:
        kwargs["draft_len"] = config.spec_draft
    if plan.kv_layout == "paged":
        from crowdllama_tpu_torch.engine import spec
        from crowdllama_tpu_torch.engine.paged import PagedModelRunner

        kwargs.update(page_size=config.kv_page_size,
                      pool_tokens=config.kv_pool_tokens,
                      prefix_cache=config.kv_prefix_cache,
                      step_token_budget=config.step_token_budget)
        if plan.runner == "DraftSpecPagedModelRunner":
            draft_cfg, draft_params = draft_model(config, cfg, dtype)
            return spec.DraftSpecPagedModelRunner(
                cfg, draft_cfg=draft_cfg, draft_params=draft_params,
                **kwargs)
        if plan.runner == "SpecPagedModelRunner":
            return spec.SpecPagedModelRunner(cfg, **kwargs)
        return PagedModelRunner(cfg, **kwargs)
    if plan.runner == "SpecModelRunner":
        from crowdllama_tpu_torch.engine.spec import SpecModelRunner

        return SpecModelRunner(cfg, **kwargs)
    from crowdllama_tpu_torch.engine.runner import ModelRunner

    return ModelRunner(cfg, **kwargs)
