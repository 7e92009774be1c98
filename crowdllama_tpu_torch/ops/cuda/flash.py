"""Kernels A and D: flash attention over contiguous K/V.

Counterparts of ``crowdllama_tpu/ops/pallas/flash.py``:

- A, :func:`flash_prefill_attention` (``csrc/flash_prefill.cu``): causal
  GQA prefill attention; plain version ``ops.attention.prefill_attention_ref``.
- D, :func:`flash_decode_attention` (``csrc/flash_decode.cu``): one decode
  token per slot over the contiguous ``[B, Hkv, S, Dh]`` cache; plain
  version :data:`decode_attention_plain`.  It runs kernel B's split-KV
  decode stages (``csrc/decode_common.cuh``) over each (slot, kv head)'s
  contiguous plane: the splits of :func:`flash_decode_plan`, from ``S``
  alone, one block each, merged in the same launch through the scratch
  and counters B's calls use on the same device
  (:func:`~crowdllama_tpu_torch.ops.cuda.paged.split_scratch`).

Each wrapper launches its hand-written kernel for CUDA tensors and runs its
plain version for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import torch

from crowdllama_tpu_torch.ops.attention import (
    decode_attention_ref,
    prefill_attention_ref,
)
from crowdllama_tpu_torch.ops.cuda import HEAD_DIMS, check, launch
from crowdllama_tpu_torch.ops.cuda.paged import (
    DECODE_STAGE_KEYS,
    split_plan,
    split_scratch,
)

# Query heads per kv head: kernel D's heads (padded to 4 or 8 in its
# block), and kernel A's groups (7 pads its blocks' 128 rows).
MAX_GROUP = 8

#: kernel D's plain version (reference semantics, any device)
decode_attention_plain = decode_attention_ref


def flash_prefill_attention(q, k, v, positions, scale: float,
                            softcap: float = 0.0, sliding_window: int = 0,
                            kv_valid=None) -> torch.Tensor:
    """Causal prefill attention: q [B, T, H, Dh], head-major k/v
    [B, Hkv, T, Dh], positions [B, T] int32, kv_valid [B, T] bool or None;
    returns [B, T, H, Dh].

    The caller guarantees ``positions[b, t] <= t`` (arange, or arange
    clamped at plen-1 with ``kv_valid`` masking the padding): the kernel
    skips key tiles above each query block's diagonal.  Head dims 64 and
    128, up to 8 query heads per kv head.
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
    check(dh in HEAD_DIMS,
          f"head dim {dh} unsupported (kernel takes {HEAD_DIMS})")
    check(h % hkv == 0 and h // hkv <= MAX_GROUP,
          f"heads {h}/{hkv}: at most {MAX_GROUP} query heads per kv head")
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
    check(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
          "q, k and v must be 16-byte aligned (16-byte copies)")
    out = torch.empty_like(q)
    launch("flash_prefill", "flash_prefill", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
           None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(),
           b, t, h, hkv, float(scale), float(softcap or 0.0),
           int(sliding_window), dh)
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


def flash_decode_plan(s: int) -> tuple[int, int]:
    """Kernel D's split of a (slot, kv head)'s ``s`` cache positions: (keys
    per split, splits).  Split i walks the keys ``[i * span, (i + 1) *
    span)``: kernel B's plan over the cache cut into 64-key decode stages,
    so 256 keys a split, widened by whole stages where more than
    :data:`~crowdllama_tpu_torch.ops.cuda.paged.MAX_SPLITS` splits would
    be needed (past 8,192 keys).  It depends on the cache length alone,
    never on the slots' lengths, so the host sizes the grid without
    reading them."""
    stages, splits = split_plan(-(-s // DECODE_STAGE_KEYS), DECODE_STAGE_KEYS)
    return stages * DECODE_STAGE_KEYS, splits


def flash_decode_launch_shape(q, k_cache) -> dict:
    """Kernel D's launch, from shapes alone: the split plan, the grid (Hkv,
    B, splits), threads a block (8 warps at every group size) and the
    scratch's rows (slot, kv head) and fp32 partials."""
    b, h, dh = q.shape
    _, hkv, s, _ = k_cache.shape
    span, splits = flash_decode_plan(s)
    rows = b * hkv
    return dict(span=span, splits=splits, grid=(hkv, b, splits), threads=256,
                rows=rows, floats=rows * splits * (h // hkv) * (dh + 4))


def flash_decode_attention(q, k_cache, v_cache, seq_lens, scale: float,
                           softcap: float = 0.0,
                           sliding_window: int = 0) -> torch.Tensor:
    """One decode step over the contiguous cache: q [B, H, Dh], k_cache /
    v_cache [B, Hkv, S, Dh], seq_lens [B] int32 (the new token included);
    returns [B, H, Dh].  A slot with seq_len 0 gets zeros from the kernel
    (the plain version averages V there instead)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, seq_lens, scale,
                                      softcap=softcap,
                                      sliding_window=sliding_window)
    check(q.dim() == 3 and k_cache.dim() == 4,
          "q must be [B, H, Dh] and the caches [B, Hkv, S, Dh]")
    b, h, dh = q.shape
    _, hkv, s, _ = k_cache.shape
    check(q.device.type == "cuda", f"unsupported device {q.device}")
    check(all(x.device == q.device for x in (k_cache, v_cache, seq_lens)),
          "all operands must be on one device")
    check(q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16,
          "q and caches must be bfloat16")
    check(dh in HEAD_DIMS,
          f"head dim {dh} unsupported (kernel takes {HEAD_DIMS})")
    check(tuple(k_cache.shape) == tuple(v_cache.shape) == (b, hkv, s, dh),
          f"cache shape {tuple(k_cache.shape)} != {(b, hkv, s, dh)}")
    check(h % hkv == 0 and h // hkv <= MAX_GROUP,
          f"heads {h}/{hkv}: at most {MAX_GROUP} query heads per kv head")
    check(seq_lens.dtype == torch.int32 and tuple(seq_lens.shape) == (b,),
          "seq_lens must be int32 [B]")
    check(all(x.is_contiguous() for x in (q, k_cache, v_cache, seq_lens)),
          "operands must be contiguous")
    check(all(x.data_ptr() % 16 == 0 for x in (q, k_cache, v_cache)),
          "q and the caches must be 16-byte aligned (16-byte loads)")
    shape = flash_decode_launch_shape(q, k_cache)
    scratch, counters = split_scratch(q.device, shape["rows"],
                                      shape["floats"])
    out = torch.empty_like(q)
    launch("flash_decode", "flash_decode", q.device,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           seq_lens.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
           out.data_ptr(), b, h, hkv, s, shape["span"], shape["splits"],
           float(scale), float(softcap or 0.0), int(sliding_window), dh)
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
