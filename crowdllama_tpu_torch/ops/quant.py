"""int8 KV-cache quantization.

Counterpart of ``quantize_kv`` in ``crowdllama_tpu/ops/quant.py``:
symmetric per-vector int8 over the last axis (head_dim), one scale per
(position, kv head).  Bit-identical to the JAX function: the scale is
``max|x| / 127 + 1e-12`` in fp32, ``x`` is divided by that fp32 scale,
rounded half to even, clipped to +-127, and only then is the scale stored
in ``scale_dtype``.  Quantized weights (``QTensor``, ``qeinsum``) are not
ported yet.
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor, scale_dtype: torch.dtype = torch.bfloat16):
    """(int8 values of x's shape, scales of shape x.shape[:-1])."""
    a = x.float()
    s = a.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
    return q, s.squeeze(-1).to(scale_dtype)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values [..., Dh] times their scales [...], in fp32.  Callers
    cast the result to what their path needs (each path casts differently,
    as in the JAX package)."""
    return q.float() * scale.float()[..., None]
