"""Weight-only int8 / int4 quantization and the int8 KV cache.

Counterpart of ``crowdllama_tpu/ops/quant.py``, with its names.  Weights:
``QTensor`` is an int8 weight with one scale per output channel, and
``QTensor4`` a nibble-packed int4 weight with one scale per ``GROUP``
input rows per output channel.  :func:`quantize_weight` and
:func:`quantize_weight_int4` are bit-identical to the JAX functions: the
scale is ``max|w| / 127 + 1e-12`` (``/ 7`` for int4) in fp32, the weight
is divided by that fp32 scale, rounded half to even and clipped, and only
then is the scale stored in ``scale_dtype``.  int4 packs output columns
``2j`` (low nibble) and ``2j + 1`` (high nibble, so the byte stays a
signed int8) into one byte, and falls back to one group when ``d_in`` is
not a multiple of ``GROUP``.  :func:`dequant` multiplies in the scale's
dtype, as the JAX function does (``q.astype(s.dtype) * s``): the
dequantized weight is ``q * s`` rounded to bf16.

The products are routed by ``models/transformer.py``: on the card every
quantized weight goes through kernel G (``ops/cuda/gemm.py``), which
dequantizes in registers and keeps no bf16 copy; its plain version
(``grouped_gemm_plain``, the route on the CPU and a check's reference on
the card) is :func:`qeinsum` over a dequantized copy, and
:func:`qragged_dot` is that plain version over group sizes.  The
unembedding's quantized ``lm_head`` takes :func:`qeinsum` in fp32 on
every device.

The KV cache: :func:`quantize_kv` is symmetric per-vector int8 over the
last axis (head_dim), one scale per (position, kv head), bit-identical to
the JAX function in the same way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

Params = dict[str, Any]

# The large matmul weights, which tolerate int8: norm gains, the MoE
# router and the embedding table stay in the compute dtype.
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
GROUP = 64  # int4 scale group (input rows per scale)
MODES = ("int8", "int4")


@dataclass
class QTensor:
    """int8 weight ``q`` [..., d_in, d_out] and per-output-channel scales
    ``s`` [..., d_out].  Indexing takes leading axes of both (a layer of
    a stacked weight, an expert of a bank)."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def to(self, device) -> "QTensor":
        return type(self)(q=self.q.to(device), s=self.s.to(device))

    def __getitem__(self, idx) -> "QTensor":
        return type(self)(q=self.q[idx], s=self.s[idx])


@dataclass
class QTensor4(QTensor):
    """Nibble-packed int4 weight ``q`` [..., d_in, d_out / 2] (int8; see
    :func:`quantize_weight_int4` for the packing) and group scales ``s``
    [..., d_in / group, d_out].  ``shape`` is the logical (unpacked)
    weight shape, as the JAX class's."""

    @property
    def shape(self) -> torch.Size:
        return torch.Size((*self.q.shape[:-1], self.q.shape[-1] * 2))

    @property
    def group(self) -> int:
        """Input rows per scale."""
        return self.q.shape[-2] // self.s.shape[-2]


def quantize_weight(w: torch.Tensor,
                    scale_dtype: torch.dtype = torch.bfloat16) -> QTensor:
    """Symmetric per-output-channel int8 over the input dim (axis -2)."""
    a = w.float()
    s = a.abs().amax(dim=-2, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s.squeeze(-2).to(scale_dtype))


def quantize_weight_int4(w: torch.Tensor, group: int = GROUP,
                         scale_dtype: torch.dtype = torch.bfloat16
                         ) -> QTensor4:
    """Symmetric group-wise int4 over the input dim (axis -2), packed two
    values a byte along the output dim: column ``2j`` in the low nibble,
    ``2j + 1`` in the high one (sign-extended)."""
    a = w.float()
    *batch, d_in, d_out = a.shape
    if d_out % 2:
        raise ValueError(f"int4 packing needs an even output dim, got {d_out}")
    g = group if d_in % group == 0 else d_in  # fall back to one group
    ar = a.reshape(*batch, d_in // g, g, d_out)
    s = ar.abs().amax(dim=-2, keepdim=True) / 7.0 + 1e-12
    q = torch.clamp(torch.round(ar / s), -7, 7).to(torch.int32)
    q = q.reshape(*batch, d_in, d_out)
    packed = (q[..., 1::2] << 4) | (q[..., 0::2] & 0xF)
    return QTensor4(q=packed.to(torch.int8),
                    s=s.squeeze(-2).to(scale_dtype))


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Packed int4 bytes [..., n / 2] -> their values [..., n] (int16)."""
    qi = q.to(torch.int16)
    lo = ((qi & 0xF) ^ 8) - 8
    hi = qi >> 4
    return torch.stack((lo, hi), dim=-1).reshape(*q.shape[:-1],
                                                 q.shape[-1] * 2)


def dequant(t):
    """QTensor / QTensor4 -> the weight in the scale's dtype (``q * s``
    rounded there); plain tensors pass through."""
    if isinstance(t, QTensor4):
        *batch, d_in, d_out = t.shape
        n_g = t.s.shape[-2]
        w = unpack_int4(t.q).to(t.s.dtype).reshape(*batch, n_g, d_in // n_g,
                                                   d_out)
        return (w * t.s[..., :, None, :]).reshape(*batch, d_in, d_out)
    if isinstance(t, QTensor):
        return t.q.to(t.s.dtype) * t.s[..., None, :]
    return t


def qeinsum(subscript: str, x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """``torch.einsum`` against a possibly-quantized weight, on a
    dequantized copy (the plain version of the products kernel G runs)."""
    wd = dequant(w)
    if dtype is not None:
        wd = wd.to(dtype)
    # One dtype for both, as jnp.einsum promotes a bf16 weight against
    # fp32 activations.
    dt = torch.promote_types(x.dtype, wd.dtype)
    return torch.einsum(subscript, x.to(dt), wd.to(dt))


def qragged_dot(xs: torch.Tensor, w, group_sizes: torch.Tensor
                ) -> torch.Tensor:
    """``lax.ragged_dot`` against a possibly-quantized expert bank
    [E, d_in, d_out]: rows ``[sum(sizes[:e]), sum(sizes[:e+1]))`` of
    ``xs`` times expert ``e``; rows past every group are zeros."""
    from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm_plain

    offsets = torch.nn.functional.pad(torch.cumsum(group_sizes, 0), (1, 0))
    return grouped_gemm_plain(xs, w, offsets)


# ------------------------------------------------------------------ trees

def quantize_leaf(w, mode: str, device=None) -> QTensor:
    """One weight [*lead, d_in, d_out] quantized on ``device`` (its own
    when None) one matrix at a time, each written into the preallocated
    result, so the peak is the result plus one matrix; a quantized leaf
    passes through."""
    if isinstance(w, QTensor):
        return w if device is None else w.to(device)
    device = w.device if device is None else device
    *lead, d_in, d_out = w.shape
    if mode == "int8":
        qfn, cols = quantize_weight, d_out
        cls, n_s = QTensor, ()
    elif mode == "int4":
        if d_out % 2:
            raise ValueError(
                f"int4 packing needs an even output dim, got {d_out}")
        qfn, cols = quantize_weight_int4, d_out // 2
        cls = QTensor4
        n_s = (d_in // (GROUP if d_in % GROUP == 0 else d_in),)
    else:
        raise ValueError(f"unknown quantization mode {mode!r}")
    flat = w.reshape(-1, d_in, d_out)
    q = torch.empty((flat.shape[0], d_in, cols), dtype=torch.int8,
                    device=device)
    s = torch.empty((flat.shape[0], *n_s, d_out), dtype=torch.bfloat16,
                    device=device)
    for j in range(flat.shape[0]):
        part = qfn(flat[j].to(device))
        q[j] = part.q
        s[j] = part.s
    return cls(q=q.reshape(*lead, d_in, cols),
               s=s.reshape(*lead, *n_s, d_out))


def quantize_params(params: Params, extra_keys: tuple[str, ...] = ("lm_head",),
                    mode: str = "int8", device=None) -> Params:
    """The parameter dict with its large matmul weights (``QUANT_KEYS`` of
    the layers, and ``extra_keys``) quantized, leaf by leaf and matrix by
    matrix on ``device`` (each leaf's own when None); every other leaf is
    moved there as it is.  Already quantized leaves pass through."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")

    def move(x):
        return x if device is None else x.to(device)

    out = {k: move(v) for k, v in params.items()
           if k not in ("layers", *extra_keys)}
    out["layers"] = {k: (quantize_leaf(v, mode, device) if k in QUANT_KEYS
                         else move(v))
                     for k, v in params["layers"].items()}
    for k in extra_keys:
        if k in params:
            out[k] = quantize_leaf(params[k], mode, device)
    return out


def random_quantized_params(cfg, generator: torch.Generator,
                            dtype: torch.dtype = torch.bfloat16,
                            mode: str = "int8",
                            device: torch.device | str = "cpu") -> Params:
    """Random parameter dict with the matmul weights *born* quantized, as
    the JAX function makes it: the structure of
    ``quantize_params(init_params(cfg))`` without the full-precision tree
    (each leaf allocated on its own: random int8 values, or packed int4
    bytes in [-112, 127], with the constant scale ``1 / (127 sqrt(d_in))``
    or ``1 / (7 sqrt(d_in))``).  The runner's random init with
    ``quantize`` (``engine/weights.py init_params``): mixtral-8x7b's int8
    tree is made on one card without its 93 GB bf16 tree."""
    from crowdllama_tpu_torch.models import transformer as T

    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    shapes = T.init_params(cfg, None, dtype=dtype, device="meta")
    norm_names = ("ln1", "ln2", "post_ln1", "post_ln2", "q_norm", "k_norm",
                  "final_norm")
    i8 = dict(generator=generator, device=device, dtype=torch.int8)

    def build(name: str, shape: torch.Size):
        if name in QUANT_KEYS or name == "lm_head":
            *lead, d_in, d_out = shape
            if mode == "int4":
                g = GROUP if d_in % GROUP == 0 else d_in
                q = torch.randint(-112, 128, (*lead, d_in, d_out // 2), **i8)
                s = torch.full((*lead, d_in // g, d_out),
                               1.0 / (7.0 * math.sqrt(d_in)), dtype=dtype,
                               device=device)
                return QTensor4(q=q, s=s)
            q = torch.randint(-127, 128, tuple(shape), **i8)
            s = torch.full((*lead, d_out), 1.0 / (127.0 * math.sqrt(d_in)),
                           dtype=dtype, device=device)
            return QTensor(q=q, s=s)
        if name in norm_names:
            return torch.ones(shape, dtype=dtype, device=device)
        if name in ("bq", "bk", "bv"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if len(shape) >= 2:  # embeddings, router, any other dense weight
            w = torch.randn(tuple(shape), generator=generator, device=device,
                            dtype=torch.float32)
            return (w / math.sqrt(shape[-2])).to(dtype)
        return torch.ones(shape, dtype=dtype, device=device)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else build(k, v.shape)
                for k, v in tree.items()}

    return walk(shapes)


def drop_input_axis_spec(spec: tuple, ndim: int) -> tuple:
    """The partition tuple of a QTensor's ``s`` from its weight's: the
    weight's padded to full rank, without the input dim (axis -2)."""
    axes = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return axes[:ndim - 2] + (axes[ndim - 1],)


# ---------------------------------------------------------------- KV cache

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
