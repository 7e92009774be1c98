"""Kernel G: the grouped GEMM over an expert bank, dequantising in the
kernel (``csrc/grouped_gemm.cu``).

It replaces no Pallas kernel: the JAX package leaves ``lax.ragged_dot``
(the MoE expert product) and ``qeinsum``'s dequantisation (every product
against a quantized weight) to XLA.  :func:`grouped_gemm` computes
``y[r] = x[r] @ w[e]`` for the rows ``[offsets[e], offsets[e + 1])`` of
each expert ``e`` (``offsets`` [E + 1] int32 on the device, from the
router; ``None`` for one expert over every row, the dense product),
against the bank ``w`` [E, K, N] as stored: bf16, a ``QTensor`` (int8 and
per-channel scales) or a ``QTensor4`` (packed int4 and group scales); a
2-D weight [K, N] is a bank of one.  The groups must cover every row
(``offsets[0] == 0``, ``offsets[E] == M``): the kernel writes only the
rows of a group.  Its plain version, :func:`grouped_gemm_plain`, is
``ops/quant.py qeinsum`` (a dequantised copy, then the product) for each
expert over every row, the expert's rows selected (a loop over the
experts that reads no offset on the host, so the MoE forward stays free
of host syncs on the CPU too); ``qragged_dot`` is the same over group
sizes.

The wrapper launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; a CUDA operand the kernel does not take (not
bf16 activations, K or N not multiples of 64, scales not bf16, ...)
raises.  Launches are counted by weight format: ``launches`` (bf16),
``launches_int8``, ``launches_int4``.
"""

from __future__ import annotations

import torch

from crowdllama_tpu_torch.ops.cuda import check, launch
from crowdllama_tpu_torch.ops.quant import QTensor, QTensor4, qeinsum

TILE = 64         # the kernel's column tile and staged input rows
PASS_ROWS = 64    # rows of one pass of a block
MAX_MSPLIT = 32   # blocks sharing one (column tile, expert)'s passes

_ENTRIES = {"bf16": ("grouped_gemm_bf16", "launches"),
            "int8": ("grouped_gemm_i8", "launches_int8"),
            "int4": ("grouped_gemm_i4", "launches_int4")}


def weight_format(w) -> str:
    if isinstance(w, QTensor4):
        return "int4"
    if isinstance(w, QTensor):
        return "int8"
    return "bf16"


def msplit_for(m: int, experts: int) -> int:
    """Blocks that share one (column tile, expert)'s 64-row passes: the
    passes an expert holds when the rows spread evenly, from the shapes
    alone (so a captured graph replays the same grid)."""
    passes = -(-m // PASS_ROWS)
    return max(1, min(-(-passes // experts), MAX_MSPLIT))


def grouped_gemm(xs: torch.Tensor, w, offsets: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Rows of ``xs`` [M, K] times their group's expert of ``w``; returns
    [M, N] (bf16 on the card; the plain version's promoted dtype on the
    CPU)."""
    if xs.device.type == "cpu":
        return grouped_gemm_plain(xs, w, offsets)
    fmt = weight_format(w)
    q = w.q if fmt != "bf16" else w
    check(xs.device.type == "cuda", f"unsupported device {xs.device}")
    check(q.dim() in (2, 3), f"weight must be [K, N] or [E, K, N], got "
          f"{tuple(q.shape)}")
    e, k, cols = q.shape if q.dim() == 3 else (1, *q.shape)
    n = cols * 2 if fmt == "int4" else cols
    m = xs.shape[0]
    check(xs.dtype == torch.bfloat16 and xs.dim() == 2 and xs.shape[1] == k,
          f"xs must be bf16 [M, {k}], got {xs.dtype} {tuple(xs.shape)}")
    check(k % TILE == 0 and n % TILE == 0,
          f"K={k} and N={n} must be multiples of {TILE}")
    groups = 1
    if fmt == "bf16":
        check(w.dtype == torch.bfloat16, f"weight dtype {w.dtype} (want bf16)")
        scale = None
    else:
        check(q.dtype == torch.int8, f"quantized values must be int8, got "
              f"{q.dtype}")
        check(w.s.dtype == torch.bfloat16, f"scales must be bf16, got "
              f"{w.s.dtype}")
        if fmt == "int8":
            check(tuple(w.s.shape) == (*q.shape[:-2], n),
                  f"int8 scales {tuple(w.s.shape)} for weight "
                  f"{tuple(w.shape)}")
        else:
            groups = w.s.shape[-2]
            check(tuple(w.s.shape) == (*q.shape[:-2], groups, n)
                  and k % groups == 0,
                  f"int4 scales {tuple(w.s.shape)} for weight "
                  f"{tuple(w.shape)}")
        scale = w.s
    if offsets is None:
        check(e == 1, "a bank of several experts needs offsets")
    else:
        check(offsets.dtype == torch.int32
              and tuple(offsets.shape) == (e + 1,)
              and offsets.is_contiguous(),
              f"offsets must be int32 [{e + 1}], got {offsets.dtype} "
              f"{tuple(offsets.shape)}")
    operands = [xs, q] + ([] if scale is None else [scale]) + (
        [] if offsets is None else [offsets])
    check(all(t.device == xs.device for t in operands),
          "all operands must be on one device")
    check(all(t.is_contiguous() for t in operands),
          "operands must be contiguous")
    check(all(t.data_ptr() % 16 == 0 for t in (xs, q)),
          "xs and the weight must be 16-byte aligned (16-byte copies)")
    check(scale is None or scale.data_ptr() % 16 == 0,
          "scales must be 16-byte aligned")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xs.device)
    if m == 0:
        return y
    symbol, counter = _ENTRIES[fmt]
    launch("grouped_gemm", symbol, xs.device, xs.data_ptr(), q.data_ptr(),
           None if scale is None else scale.data_ptr(),
           None if offsets is None else offsets.data_ptr(), y.data_ptr(),
           m, k, n, e, groups, msplit_for(m, e))
    setattr(grouped_gemm, counter, getattr(grouped_gemm, counter) + 1)
    return y


grouped_gemm.launches = 0
grouped_gemm.launches_int8 = 0
grouped_gemm.launches_int4 = 0


def grouped_gemm_plain(xs: torch.Tensor, w, offsets: torch.Tensor | None
                       = None) -> torch.Tensor:
    """Kernel G's plain version (reference semantics, any device):
    ``qeinsum`` of every row against each expert, the expert's rows kept;
    rows in no group are zeros.  The dtype is the promotion of ``xs``'s
    and the dequantised weight's (fp32 activations against a bf16 weight
    give fp32, as ``lax.ragged_dot`` does)."""
    if offsets is None:
        return qeinsum("mk,kn->mn", xs, w)
    if len(w.shape) == 2:
        w = w[None]
    rows = torch.arange(xs.shape[0], device=xs.device)
    out = None
    for e in range(w.shape[0]):
        ye = qeinsum("mk,kn->mn", xs, w[e])
        if out is None:
            out = torch.zeros_like(ye)
        mine = (rows >= offsets[e]) & (rows < offsets[e + 1])
        out = torch.where(mine[:, None], ye, out)
    return out
