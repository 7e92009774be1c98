"""Attention ops: causal prefill and single-step cached decode.

Counterpart of ``crowdllama_tpu/ops/attention.py``, with the same layouts
(q [B, T, H, Dh]; K/V head-major [B, Hkv, T, Dh]) and the same masking:
grouped-query attention with query heads folded into [Hkv, G] groups
(query head ``h`` reads kv head ``h // G``), fp32 softmax, optional logit
softcapping and a sliding window (``<= 0`` disables it), masked logits set
to ``NEG_INF`` so an all-masked row stays finite.

The ``*_ref`` functions, ``prefill_attention_ctx`` and the int8-cache
``decode_attention_q`` are the plain reference semantics.  ``prefill_attention`` (kernel A) and
``decode_attention`` over a contiguous cache (kernel D) dispatch to the
hand-written Hopper kernels (``ops/cuda/flash.py``) for CUDA tensors and to
their references for CPU tensors.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _grouped(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, Hkv, G, Dh]."""
    b, t, h, d = q.shape
    return q.reshape(b, t, num_kv_heads, h // num_kv_heads, d)


def _window_ok(kpos: torch.Tensor, qpos: torch.Tensor,
               window: int) -> torch.Tensor:
    if window > 0:
        return kpos > qpos - window
    return torch.ones_like(kpos > qpos)


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def prefill_attention(q, k, v, positions, scale: float, softcap: float = 0.0,
                      sliding_window: int = 0, kv_valid=None) -> torch.Tensor:
    """Causal self-attention over a full (padded) prompt.

    ``kv_valid`` excludes bucket-padding keys: padded positions are clamped
    to plen-1 by the caller, so the causal mask alone would let the real
    last token attend to padding garbage.  CUDA tensors run kernel A
    (``ops/cuda/flash.py``); CPU tensors run :func:`prefill_attention_ref`.
    """
    from crowdllama_tpu_torch.ops.cuda.flash import flash_prefill_attention

    return flash_prefill_attention(q, k, v, positions, scale, softcap=softcap,
                                   sliding_window=sliding_window,
                                   kv_valid=kv_valid)


def prefill_attention_ref(q, k, v, positions, scale: float,
                          softcap: float = 0.0, sliding_window: int = 0,
                          kv_valid=None) -> torch.Tensor:
    """Plain prefill attention (reference semantics)."""
    num_kv = k.shape[1]
    qg = _grouped(q, num_kv)  # [B,T,Hkv,G,Dh]
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), k.float()) * scale
    logits = _softcap(logits, softcap)
    qpos = positions[:, :, None]  # [B,T,1]
    kpos = positions[:, None, :]  # [B,1,T]
    mask = (kpos <= qpos) & _window_ok(kpos, qpos, int(sliding_window))
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = _softmax_rows(logits)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v.float())
    b, t, hkv, g, d = out.shape
    return out.reshape(b, t, hkv * g, d).to(q.dtype)


def prefill_attention_ctx(q, k, v, positions, ctx_k, ctx_v, ctx_valid,
                          scale: float, softcap: float = 0.0,
                          sliding_window: int = 0,
                          kv_valid=None) -> torch.Tensor:
    """Causal prefill attention with a cached-prefix context (prefix cache).

    q [B, T, H, Dh] suffix queries; k/v [B, Hkv, T, Dh] suffix keys;
    ctx_k/ctx_v [B, Hkv, C, Dh] cached prefix KV at absolute positions
    0..C-1; ctx_valid [B, C] False beyond the prefix length.  Softmax runs
    over the concatenated key axis, so logits equal a from-scratch prefill
    of prefix+suffix.
    """
    num_kv = k.shape[1]
    qf = _grouped(q, num_kv).float()  # [B,T,Hkv,G,Dh]
    window = int(sliding_window)

    lc = torch.einsum("bqhgd,bhcd->bhgqc", qf, ctx_k.float()) * scale
    lc = _softcap(lc, softcap)
    cpos = torch.arange(ctx_k.shape[2], device=q.device)[None, None, :]
    qpos = positions[:, :, None]                         # [B,T,1]
    cmask = ctx_valid[:, None, :] & _window_ok(cpos, qpos, window)
    lc = torch.where(cmask[:, None, None], lc, torch.full_like(lc, NEG_INF))

    ls = torch.einsum("bqhgd,bhkd->bhgqk", qf, k.float()) * scale
    ls = _softcap(ls, softcap)
    kpos = positions[:, None, :]                         # [B,1,T]
    smask = (kpos <= qpos) & _window_ok(kpos, qpos, window)
    if kv_valid is not None:
        smask = smask & kv_valid[:, None, :]
    ls = torch.where(smask[:, None, None], ls, torch.full_like(ls, NEG_INF))

    probs = _softmax_rows(torch.cat([lc, ls], dim=-1))   # [B,Hkv,G,T,C+T]
    c = ctx_k.shape[2]
    out = torch.einsum("bhgqc,bhcd->bqhgd", probs[..., :c], ctx_v.float())
    out = out + torch.einsum("bhgqk,bhkd->bqhgd", probs[..., c:], v.float())
    b, t, hkv, g, d = out.shape
    return out.reshape(b, t, hkv * g, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, seq_lens, scale: float,
                     softcap: float = 0.0,
                     sliding_window: int = 0) -> torch.Tensor:
    """One decode step over a contiguous cache [B, Hkv, S, Dh]; q
    [B, H, Dh], seq_lens [B] valid keys per slot (the new token included).

    CUDA tensors run kernel D (``ops/cuda/flash.py``
    ``flash_decode_attention``); CPU tensors run
    :func:`decode_attention_ref`.  The contiguous-layout runner calls this
    in every layer of every decode step.
    """
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention

    return flash_decode_attention(q, k_cache, v_cache, seq_lens, scale,
                                  softcap=softcap,
                                  sliding_window=sliding_window)


def _decode_probs(logits: torch.Tensor, seq_lens: torch.Tensor, s: int,
                  sliding_window: int) -> torch.Tensor:
    """Decode masking + softmax: logits [B,Hkv,G,S] -> probs (validity by
    seq_len, sliding window relative to the newest position)."""
    kpos = torch.arange(s, device=logits.device)[None, :]  # [1,S]
    newest = seq_lens[:, None] - 1
    valid = (kpos < seq_lens[:, None]) & _window_ok(kpos, newest,
                                                   int(sliding_window))
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    return _softmax_rows(logits)


def decode_attention_ref(q, k_cache, v_cache, seq_lens, scale: float,
                         softcap: float = 0.0,
                         sliding_window: int = 0) -> torch.Tensor:
    """Plain decode attention (reference semantics); q [B, H, Dh]."""
    num_kv = k_cache.shape[1]
    b, h, d = q.shape
    qg = q.reshape(b, num_kv, h // num_kv, d)  # [B,Hkv,G,Dh]
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) * scale
    logits = _softcap(logits, softcap)
    probs = _decode_probs(logits, seq_lens, k_cache.shape[2], sliding_window)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_q(q, k_cache, k_scale, v_cache, v_scale, seq_lens,
                       scale: float, softcap: float = 0.0,
                       sliding_window: int = 0) -> torch.Tensor:
    """Decode attention over an int8 cache [B, Hkv, S, Dh] with
    per-position scales [B, Hkv, S]: the K scale acts on the score plane,
    the V scale is folded into the probabilities, and the masks are
    :func:`_decode_probs`, shared with the bf16 path.  Plain PyTorch: the
    contiguous int8 cache runs it in every decode step (the JAX package
    has no Pallas kernel for it either), and kernel B's int8 plain version
    runs it over the gathered pages."""
    num_kv = k_cache.shape[1]
    b, h, d = q.shape
    qg = q.reshape(b, num_kv, h // num_kv, d)  # [B,Hkv,G,Dh]
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()
                          ) * k_scale[:, :, None, :].float() * scale
    logits = _softcap(logits, softcap)
    probs = _decode_probs(logits, seq_lens, k_cache.shape[2], sliding_window)
    pv = probs * v_scale[:, :, None, :].float()  # fold the V scales
    out = torch.einsum("bhgk,bhkd->bhgd", pv, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
