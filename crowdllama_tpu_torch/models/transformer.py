"""The dense decoder core (Llama / Gemma-2 / Qwen / Mistral switches).

Counterpart of ``crowdllama_tpu/models/transformer.py``: plain functions
over a parameter dict whose layer weights are stacked on a leading layer
axis (``params["layers"][name]`` is ``[L, ...]``), the same names and
shapes as the JAX package's pytree, so weights cross between the packages
through numpy (``engine/weights.py params_from_numpy``).  The JAX layer
``scan`` becomes a Python loop over layers.  Weights are bf16 on the card;
norms and softmax accumulate in fp32.  MoE layers are not ported yet.

Tensor parallelism: the forward functions take ``shards``, the list of
per-rank parameter dicts that ``parallel/sharding.py shard_params`` makes
(one dict on one device).  Each rank computes its heads and its slice of
the MLP on its device; the row-parallel products, the embedding and the
logits go through the sharding module's reductions, which pass a single
rank's tensor through untouched.  The values that are per rank (K/V,
attention inputs and outputs, ``rope`` tables) are per-rank lists too.
The activations between layers are one tensor on rank 0's device.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.ops.attention import (
    decode_attention,
    decode_attention_q,
    prefill_attention,
    prefill_attention_ctx,
)
from crowdllama_tpu_torch.ops.norms import rms_norm
from crowdllama_tpu_torch.ops.quant import quantize_kv
from crowdllama_tpu_torch.ops.rope import apply_rope, rope_table
from crowdllama_tpu_torch.parallel.sharding import (
    row_parallel_sum,
    vocab_embed,
    vocab_gather,
)

Params = dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cpu") -> Params:
    """Random-init a parameter dict (layers stacked on axis 0) from
    ``generator`` (which must live on ``device``)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    dh = cfg.resolved_head_dim()
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, hkv, nl = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def dense(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    layers: Params = {
        "ln1": ones(nl, d), "ln2": ones(nl, d),
        "wq": dense(nl, d, h * dh, fan_in=d),
        "wk": dense(nl, d, hkv * dh, fan_in=d),
        "wv": dense(nl, d, hkv * dh, fan_in=d),
        "wo": dense(nl, h * dh, d, fan_in=h * dh),
        "w_gate": dense(nl, d, f, fan_in=d),
        "w_up": dense(nl, d, f, fan_in=d),
        "w_down": dense(nl, f, d, fan_in=f),
    }
    if cfg.attn_qkv_bias:  # Qwen2/2.5
        layers.update(bq=zeros(nl, h * dh), bk=zeros(nl, hkv * dh),
                      bv=zeros(nl, hkv * dh))
    if cfg.qk_norm:  # Qwen3
        layers.update(q_norm=ones(nl, dh), k_norm=ones(nl, dh))
    if cfg.post_norms:
        layers.update(post_ln1=ones(nl, d), post_ln2=ones(nl, d))
    params: Params = {"embed": dense(v, d, fan_in=d), "layers": layers,
                      "final_norm": ones(d)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(d, v, fan_in=d)
    return params


def layer_sliding_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding-window size (0 = global attention): Gemma-2
    windows even layers, Mistral every layer, other families none."""
    if cfg.sliding_window > 0:
        if cfg.family == "gemma2":
            return [cfg.sliding_window if i % 2 == 0 else 0
                    for i in range(cfg.num_layers)]
        return [cfg.sliding_window] * cfg.num_layers
    return [0] * cfg.num_layers


def attn_scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar > 0:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.resolved_head_dim() ** -0.5


def rope_for(cfg: ModelConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    return rope_table(cfg.max_context_length, cfg.resolved_head_dim(),
                      cfg.rope_theta, scaling=cfg.rope_scaling, device=device)


def layer_stacks(shards: list[Params]) -> list[Params]:
    """Each rank's stacked layer weights."""
    return [p["layers"] for p in shards]


def layer_params(layers: list[Params], i: int) -> list[Params]:
    """Layer ``i`` of each rank's stacked layer weights."""
    return [{k: w[i] for k, w in stack.items()} for stack in layers]


def _ropes(rope, cfg: ModelConfig, layers: list[Params]) -> list:
    """Per-rank (cos, sin): ``rope`` as given, or built on each rank's
    device when None."""
    if rope is None:
        return [rope_for(cfg, stack["wq"].device) for stack in layers]
    return rope


def _norm(x, w, cfg: ModelConfig, plus_one: bool | None = None):
    if plus_one is None:
        plus_one = cfg.family == "gemma2"
    return rms_norm(x, w, cfg.rms_norm_eps, plus_one=plus_one)


def _embed(shards: list[Params], cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = vocab_embed([p["embed"] for p in shards], tokens)
    if cfg.embedding_multiplier > 0:
        x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
    return x


def _unembed(shards: list[Params], cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection in fp32; logits [..., V] fp32 (the
    ranks' vocab slices gathered before the softcap)."""
    x = _norm(x, shards[0]["final_norm"], cfg).float()
    parts = []
    for p in shards:
        xr = x.to(p["embed"].device)
        if cfg.tie_word_embeddings:
            parts.append(xr @ p["embed"].float().T)
        else:
            parts.append(xr @ p["lm_head"].float())
    logits = vocab_gather(parts)
    if cfg.final_logit_softcap > 0:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _mlp(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU (Llama) / GeGLU-tanh (Gemma) MLP. x: [..., D]."""
    gate = x @ lp["w_gate"]
    up = x @ lp["w_up"]
    act = (F.gelu(gate, approximate="tanh") if cfg.family == "gemma2"
           else F.silu(gate))
    return (act * up) @ lp["w_down"]


def _qkv(lp: Params, cfg: ModelConfig, h: torch.Tensor):
    """Projections (+ Qwen bias / qk-norm) for h [..., D] -> q [..., H, Dh],
    k/v [..., Hkv, Dh]."""
    dh = cfg.resolved_head_dim()
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    lead = h.shape[:-1]  # heads: all, or a tp rank's share
    q = q.reshape(*lead, -1, dh)
    k = k.reshape(*lead, -1, dh)
    v = v.reshape(*lead, -1, dh)
    if "q_norm" in lp:
        q = _norm(q, lp["q_norm"], cfg, plus_one=False)
        k = _norm(k, lp["k_norm"], cfg, plus_one=False)
    return q, k, v


def _residual_tail(lps: list[Params], cfg: ModelConfig, x: torch.Tensor,
                   attns: list[torch.Tensor]) -> torch.Tensor:
    """Output projection, residuals and MLP after attention; ``lps`` and
    ``attns`` per rank (the two row-parallel products summed over ranks)."""
    attn = row_parallel_sum([a @ lp["wo"] for a, lp in zip(attns, lps)])
    if cfg.post_norms:
        attn = _norm(attn, lps[0]["post_ln1"], cfg, plus_one=True)
    x = x + attn
    h = _norm(x, lps[0]["ln2"], cfg)
    mlp_out = row_parallel_sum([_mlp(lp, cfg, h.to(lp["w_down"].device))
                                for lp in lps])
    if cfg.post_norms:
        mlp_out = _norm(mlp_out, lps[0]["post_ln2"], cfg, plus_one=True)
    return x + mlp_out


def scan_prefill_layers(layers: list[Params], windows: list[int],
                        cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor,
                        kv_valid: torch.Tensor | None = None,
                        ctx_k: list | None = None, ctx_v: list | None = None,
                        ctx_valid: torch.Tensor | None = None,
                        attention: Callable = prefill_attention,
                        rope: list | None = None):
    """Run every decoder layer over x [B, T, D] (``layers``: each rank's
    stacked weights); returns (x, ks, vs) with ks/vs per rank, each
    [L, B, Hkv/tp, T, Dh] head-major and contiguous on its rank's device.

    With ``ctx_k``/``ctx_v`` (per rank [L, B, Hkv/tp, C, Dh], ``ctx_valid``
    [B, C]) the batch is a suffix continuing a cached prefix: queries
    attend jointly over the context and the causal suffix
    (``prefill_attention_ctx``) and ks/vs cover the suffix only.
    ``attention`` is the no-context attention function (kernel A's
    dispatch by default).  ``rope`` is the per-rank (cos, sin) pairs
    (built here when None; a runner passes its own)."""
    scale = attn_scale(cfg)
    ropes = _ropes(rope, cfg, layers)
    if ctx_k is None:
        ctx_k = ctx_v = [None] * len(layers)
    b, t = x.shape[0], x.shape[1]
    ks = [[] for _ in layers]
    vs = [[] for _ in layers]
    for i, window in enumerate(windows):
        lps = layer_params(layers, i)
        h = _norm(x, lps[0]["ln1"], cfg)
        attns = []
        for r, lp in enumerate(lps):
            dev = lp["wq"].device
            pos = positions.to(dev)
            valid = None if kv_valid is None else kv_valid.to(dev)
            q, k, v = _qkv(lp, cfg, h.to(dev))
            cos, sin = ropes[r]
            q = apply_rope(q, pos, cos, sin)
            k = apply_rope(k, pos, cos, sin)
            kh = k.transpose(1, 2).contiguous()  # [B, Hkv, T, Dh] cache layout
            vh = v.transpose(1, 2).contiguous()
            if ctx_k[r] is not None:
                attn = prefill_attention_ctx(
                    q, kh, vh, pos, ctx_k[r][i], ctx_v[r][i],
                    ctx_valid.to(dev), scale,
                    softcap=cfg.attn_logit_softcap, sliding_window=window,
                    kv_valid=valid)
            else:
                attn = attention(q.contiguous(), kh, vh, pos, scale,
                                 softcap=cfg.attn_logit_softcap,
                                 sliding_window=window, kv_valid=valid)
            attns.append(attn.reshape(b, t, -1))
            ks[r].append(kh)
            vs[r].append(vh)
        x = _residual_tail(lps, cfg, x, attns)
    return x, [torch.stack(k) for k in ks], [torch.stack(v) for v in vs]


def prefill(shards: list[Params], cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv_valid: torch.Tensor | None = None,
            ctx_k=None, ctx_v=None, ctx_valid=None,
            attention: Callable = prefill_attention, rope=None):
    """Full-prompt forward.  Returns (logits [B, T, V] fp32, ks, vs per
    rank [L, B, Hkv/tp, T, Dh]).  ``positions`` are absolute (padding may
    repeat the last position; ``kv_valid`` False for padding)."""
    x = _embed(shards, cfg, tokens)
    x, ks, vs = scan_prefill_layers(
        layer_stacks(shards), layer_sliding_windows(cfg), cfg, x, positions,
        kv_valid=kv_valid, ctx_k=ctx_k, ctx_v=ctx_v, ctx_valid=ctx_valid,
        attention=attention, rope=rope)
    return _unembed(shards, cfg, x), ks, vs


def hidden_states(shards: list[Params], cfg: ModelConfig,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  kv_valid: torch.Tensor | None = None,
                  attention: Callable = prefill_attention,
                  rope=None) -> torch.Tensor:
    """Final-norm hidden states [B, T, D]: the embeddings forward (the
    prefill layer stack without the vocab projection)."""
    x = _embed(shards, cfg, tokens)
    x, _, _ = scan_prefill_layers(layer_stacks(shards),
                                  layer_sliding_windows(cfg), cfg, x,
                                  positions, kv_valid=kv_valid,
                                  attention=attention, rope=rope)
    return _norm(x, shards[0]["final_norm"], cfg)


def decode_layer_body(lps: list[Params], cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, ropes: list,
                      attn_fn: Callable) -> torch.Tensor:
    """One decoder layer's single-token math, minus the KV-cache policy.
    ``lps`` and ``ropes`` ((cos, sin) pairs) are per rank;
    ``attn_fn(qs, ks, vs)`` takes per-rank q [B, H/tp, Dh] and k/v
    [B, Hkv/tp, Dh], writes the cache and returns the per-rank attention
    [B, H/tp, Dh].  x [B, D] residual stream."""
    b = x.shape[0]
    h = _norm(x, lps[0]["ln1"], cfg)
    qs, ks, vs = [], [], []
    for p, (cos, sin) in zip(lps, ropes):
        dev = p["wq"].device
        q, k, v = _qkv(p, cfg, h.to(dev))
        pos = positions.to(dev)[:, None]
        qs.append(apply_rope(q[:, None], pos, cos, sin)[:, 0].contiguous())
        ks.append(apply_rope(k[:, None], pos, cos, sin)[:, 0])
        vs.append(v)
    attns = attn_fn(qs, ks, vs)
    return _residual_tail(lps, cfg, x, [a.reshape(b, -1) for a in attns])


def scan_decode_layers(layers: list[Params], windows: list[int],
                       cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, seq_lens: torch.Tensor,
                       rope: list, attention: Callable = decode_attention,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Every decoder layer over one token per slot, x [B, D], against the
    contiguous cache [L, B, Hkv, S, Dh] on one device (``layers`` and
    ``rope`` are one rank's): each layer writes its token's K/V at
    ``positions`` in place, then attends over ``seq_lens`` keys
    (``attention``: kernel D's dispatch by default).  With ``k_scale`` /
    ``v_scale`` [L, B, Hkv, S] the caches are int8: the token's K/V are
    quantized on write (values and scales at ``positions``) and attention
    is the plain :func:`decode_attention_q`.  Returns x."""
    scale = attn_scale(cfg)
    slot_idx = torch.arange(x.shape[0], device=x.device)
    pos = positions.long()
    quantized = k_scale is not None
    kw = dict(softcap=cfg.attn_logit_softcap)
    for i, window in enumerate(windows):
        kc, vc = k_cache[i], v_cache[i]

        if quantized:
            def attn_fn(qs, ks, vs, kc=kc, vc=vc, k_sc=k_scale[i],
                        v_sc=v_scale[i], window=window):
                (q,), (k,), (v,) = qs, ks, vs
                kq, k_row = quantize_kv(k, k_sc.dtype)  # [B,Hkv,Dh], [B,Hkv]
                vq, v_row = quantize_kv(v, v_sc.dtype)
                kc[slot_idx, :, pos] = kq
                vc[slot_idx, :, pos] = vq
                k_sc[slot_idx, :, pos] = k_row
                v_sc[slot_idx, :, pos] = v_row
                return [decode_attention_q(q, kc, k_sc, vc, v_sc, seq_lens,
                                           scale, sliding_window=window,
                                           **kw)]
        else:
            def attn_fn(qs, ks, vs, kc=kc, vc=vc, window=window):
                (q,), (k,), (v,) = qs, ks, vs
                kc[slot_idx, :, pos] = k.to(kc.dtype)
                vc[slot_idx, :, pos] = v.to(vc.dtype)
                return [attention(q, kc, vc, seq_lens, scale,
                                  sliding_window=window, **kw)]

        x = decode_layer_body(layer_params(layers, i), cfg, x, positions,
                              rope, attn_fn)
    return x


def decode_step(shards: list[Params], cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, seq_lens: torch.Tensor,
                rope: list | None = None,
                attention: Callable = decode_attention,
                k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None):
    """One token per slot over the contiguous cache (updated in place) of
    a one-device model (``shards`` holds one dict).  Returns (logits [B, V]
    fp32, k_cache, v_cache), plus (k_scale, v_scale) when the cache is int8
    (scales passed in); ``seq_lens`` counts the valid cache positions after
    appending this token.  ``rope`` is ``[(cos, sin)]`` on the cache's
    device (built here when None; a serving loop passes its precomputed
    pair)."""
    if rope is None:
        rope = [rope_for(cfg, k_cache.device)]
    x = _embed(shards, cfg, tokens.long())
    x = scan_decode_layers(layer_stacks(shards), layer_sliding_windows(cfg),
                           cfg, x, positions, k_cache, v_cache, seq_lens,
                           rope, attention=attention, k_scale=k_scale,
                           v_scale=v_scale)
    logits = _unembed(shards, cfg, x)
    if k_scale is not None:
        return logits, k_cache, v_cache, k_scale, v_scale
    return logits, k_cache, v_cache
