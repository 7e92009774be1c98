"""Runner construction from a Configuration and its ServingPlan.

Counterpart of the ported subset of ``crowdllama_tpu/engine/factory.py``
``build_runner``: the plan's runner on one device or, paged, over the tp
mesh ``config.mesh_shape`` names (ranks on ``devices``, else the visible
CUDA devices).
"""

from __future__ import annotations

import torch


def build_runner(config, plan, cfg, params=None, *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device=None, devices: list | None = None):
    """Instantiate the runner ``plan`` names for model ``cfg``."""
    kwargs = dict(params=params, max_slots=config.max_batch_slots,
                  max_seq=cfg.max_context_length, dtype=dtype, seed=seed,
                  device=device, kv_dtype=plan.kv_dtype,
                  mesh_shape=plan.mesh_shape, devices=devices)
    if plan.kv_layout == "paged":
        from crowdllama_tpu_torch.engine.paged import PagedModelRunner

        return PagedModelRunner(
            cfg, page_size=config.kv_page_size,
            pool_tokens=config.kv_pool_tokens,
            prefix_cache=config.kv_prefix_cache,
            step_token_budget=config.step_token_budget, **kwargs)
    from crowdllama_tpu_torch.engine.runner import ModelRunner

    return ModelRunner(cfg, **kwargs)
