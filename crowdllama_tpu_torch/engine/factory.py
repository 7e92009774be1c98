"""Runner construction from a Configuration and its ServingPlan.

Counterpart of the ported subset of ``crowdllama_tpu/engine/factory.py``
``build_runner``: the plan's runner on one device or, paged, over the tp
mesh ``config.mesh_shape`` names (ranks on ``devices``, else the visible
CUDA devices), quantizing the weights as the plan says.  The draft-model
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
