"""Weights: random init from a seed, and weights carried across from numpy.

Counterpart of ``crowdllama_tpu/engine/weights.py``.  Nothing is
downloaded; loading safetensors checkpoints is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cpu") -> dict:
    """Random weights made on ``device`` from ``torch.Generator(seed)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_params(cfg, gen, dtype=dtype, device=device)


def params_from_numpy(flat: dict[str, np.ndarray],
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> dict:
    """Rebuild the parameter dict from the JAX package's flat ``/``-joined
    names (``layers/wq``, ``embed``, ...: its ``_flatten_params``), casting
    to ``dtype`` on ``device``.  The full dict serves a one-device runner
    as it is; a tensor-parallel runner slices it per rank
    (``parallel/sharding.py shard_params``)."""
    params: dict = {}
    for name, arr in flat.items():
        node = params
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr)).to(device=device,
                                                        dtype=dtype)
    return params
