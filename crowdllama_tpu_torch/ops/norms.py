"""Normalization ops (counterpart of ``crowdllama_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to the input dtype.

    ``plus_one`` selects the Gemma convention ``x * (1 + w)``; Llama/Mixtral
    use ``x * w``.
    """
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf / torch.sqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (normed * w).to(dtype)
