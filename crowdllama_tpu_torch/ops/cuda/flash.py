"""Kernel A: causal GQA prefill attention (``csrc/flash_prefill.cu``).

Counterpart of ``crowdllama_tpu/ops/pallas/flash.py``
``flash_prefill_attention``.  :func:`flash_prefill_attention` launches the
hand-written kernel for CUDA tensors and runs the plain version,
``ops.attention.prefill_attention_ref``, for CPU tensors; there is no other
fallback.
"""

from __future__ import annotations

import torch

from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
from crowdllama_tpu_torch.ops.cuda import check, launch

HEAD_DIM = 64   # the kernel's fixed head dim
BLOCK_ROWS = 128  # query rows x heads per block: G must divide it


def flash_prefill_attention(q, k, v, positions, scale: float,
                            softcap: float = 0.0, sliding_window: int = 0,
                            kv_valid=None) -> torch.Tensor:
    """Causal prefill attention: q [B, T, H, Dh], head-major k/v
    [B, Hkv, T, Dh], positions [B, T] int32, kv_valid [B, T] bool or None;
    returns [B, T, H, Dh].

    The caller guarantees ``positions[b, t] <= t`` (arange, or arange
    clamped at plen-1 with ``kv_valid`` masking the padding): the kernel
    skips key tiles above each query tile's diagonal.
    """
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v, positions, scale,
                                     softcap=softcap,
                                     sliding_window=sliding_window,
                                     kv_valid=kv_valid)
    b, t, h, dh = q.shape
    hkv = k.shape[1]
    check(q.device.type == "cuda", f"unsupported device {q.device}")
    check(all(x.device == q.device for x in (k, v, positions))
          and (kv_valid is None or kv_valid.device == q.device),
          "all operands must be on one device")
    check(q.dtype == k.dtype == v.dtype == torch.bfloat16,
          "q/k/v must be bfloat16")
    check(dh == HEAD_DIM, f"head dim {dh} unsupported (kernel takes {HEAD_DIM})")
    check(h % hkv == 0 and BLOCK_ROWS % (h // hkv) == 0,
          f"heads {h}/{hkv}: group size must divide {BLOCK_ROWS}")
    check(tuple(k.shape) == tuple(v.shape) == (b, hkv, t, dh),
          f"k/v shape {tuple(k.shape)} != {(b, hkv, t, dh)}")
    check(positions.dtype == torch.int32 and tuple(positions.shape) == (b, t),
          "positions must be int32 [B, T]")
    check(kv_valid is None or (kv_valid.dtype == torch.bool
                               and tuple(kv_valid.shape) == (b, t)),
          "kv_valid must be bool [B, T]")
    check(all(x.is_contiguous() for x in (q, k, v, positions))
          and (kv_valid is None or kv_valid.is_contiguous()),
          "operands must be contiguous")
    out = torch.empty_like(q)
    launch("flash_prefill", "flash_prefill", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
           None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(),
           b, t, h, hkv, float(scale), float(softcap or 0.0),
           int(sliding_window))
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
