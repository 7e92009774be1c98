"""The dense decoder core (Llama / Gemma-2 / Qwen / Mistral switches).

Counterpart of ``crowdllama_tpu/models/transformer.py``: plain functions
over a parameter dict whose layer weights are stacked on a leading layer
axis (``params["layers"][name]`` is ``[L, ...]``), the same names and
shapes as the JAX package's pytree, so weights cross between the packages
through numpy (``engine/weights.py params_from_numpy``).  The JAX layer
``scan`` becomes a Python loop over layers.  Weights are bf16 on the card;
norms and softmax accumulate in fp32.  MoE layers are not ported yet.
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


def layer_params(layers: Params, i: int) -> Params:
    return {k: w[i] for k, w in layers.items()}


def _norm(x, w, cfg: ModelConfig, plus_one: bool | None = None):
    if plus_one is None:
        plus_one = cfg.family == "gemma2"
    return rms_norm(x, w, cfg.rms_norm_eps, plus_one=plus_one)


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embedding_multiplier > 0:
        x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
    return x


def _unembed(params: Params, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection in fp32; logits [..., V] fp32."""
    x = _norm(x, params["final_norm"], cfg).float()
    if cfg.tie_word_embeddings:
        logits = x @ params["embed"].float().T
    else:
        logits = x @ params["lm_head"].float()
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
    lead = h.shape[:-1]
    q = q.reshape(*lead, cfg.num_heads, dh)
    k = k.reshape(*lead, cfg.num_kv_heads, dh)
    v = v.reshape(*lead, cfg.num_kv_heads, dh)
    if "q_norm" in lp:
        q = _norm(q, lp["q_norm"], cfg, plus_one=False)
        k = _norm(k, lp["k_norm"], cfg, plus_one=False)
    return q, k, v


def _residual_tail(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Output projection, residuals and MLP after attention."""
    attn = attn @ lp["wo"]
    if cfg.post_norms:
        attn = _norm(attn, lp["post_ln1"], cfg, plus_one=True)
    x = x + attn
    mlp_out = _mlp(lp, cfg, _norm(x, lp["ln2"], cfg))
    if cfg.post_norms:
        mlp_out = _norm(mlp_out, lp["post_ln2"], cfg, plus_one=True)
    return x + mlp_out


def scan_prefill_layers(layers: Params, windows: list[int], cfg: ModelConfig,
                        x: torch.Tensor, positions: torch.Tensor,
                        kv_valid: torch.Tensor | None = None,
                        ctx_k: torch.Tensor | None = None,
                        ctx_v: torch.Tensor | None = None,
                        ctx_valid: torch.Tensor | None = None,
                        attention: Callable = prefill_attention,
                        rope: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Run every decoder layer over x [B, T, D]; returns (x, ks, vs) with
    ks/vs [L, B, Hkv, T, Dh] head-major and contiguous.

    With ``ctx_k``/``ctx_v`` ([L, B, Hkv, C, Dh], ``ctx_valid`` [B, C]) the
    batch is a suffix continuing a cached prefix: queries attend jointly
    over the context and the causal suffix (``prefill_attention_ctx``) and
    ks/vs cover the suffix only.  ``attention`` is the no-context attention
    function (kernel A's dispatch by default).  ``rope`` is the (cos, sin)
    pair on x's device (built here when None; a runner passes its own)."""
    scale = attn_scale(cfg)
    cos, sin = rope if rope is not None else rope_for(cfg, x.device)
    b, t = x.shape[0], x.shape[1]
    ks, vs = [], []
    for i, window in enumerate(windows):
        lp = layer_params(layers, i)
        q, k, v = _qkv(lp, cfg, _norm(x, lp["ln1"], cfg))
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)
        kh = k.transpose(1, 2).contiguous()  # [B, Hkv, T, Dh] cache layout
        vh = v.transpose(1, 2).contiguous()
        if ctx_k is not None:
            attn = prefill_attention_ctx(
                q, kh, vh, positions, ctx_k[i], ctx_v[i], ctx_valid, scale,
                softcap=cfg.attn_logit_softcap, sliding_window=window,
                kv_valid=kv_valid)
        else:
            attn = attention(q.contiguous(), kh, vh, positions, scale,
                             softcap=cfg.attn_logit_softcap,
                             sliding_window=window, kv_valid=kv_valid)
        x = _residual_tail(lp, cfg, x, attn.reshape(b, t, -1))
        ks.append(kh)
        vs.append(vh)
    return x, torch.stack(ks), torch.stack(vs)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv_valid: torch.Tensor | None = None,
            ctx_k=None, ctx_v=None, ctx_valid=None,
            attention: Callable = prefill_attention,
            rope: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full-prompt forward.  Returns (logits [B, T, V] fp32, k, v
    [L, B, Hkv, T, Dh]).  ``positions`` are absolute (padding may repeat
    the last position; ``kv_valid`` False for padding)."""
    x = _embed(params, cfg, tokens)
    x, ks, vs = scan_prefill_layers(
        params["layers"], layer_sliding_windows(cfg), cfg, x, positions,
        kv_valid=kv_valid, ctx_k=ctx_k, ctx_v=ctx_v, ctx_valid=ctx_valid,
        attention=attention, rope=rope)
    return _unembed(params, cfg, x), ks, vs


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor,
                  kv_valid: torch.Tensor | None = None,
                  attention: Callable = prefill_attention,
                  rope: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Final-norm hidden states [B, T, D]: the embeddings forward (the
    prefill layer stack without the vocab projection)."""
    x = _embed(params, cfg, tokens)
    x, _, _ = scan_prefill_layers(params["layers"], layer_sliding_windows(cfg),
                                  cfg, x, positions, kv_valid=kv_valid,
                                  attention=attention, rope=rope)
    return _norm(x, params["final_norm"], cfg)


def decode_layer_body(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, attn_fn: Callable) -> torch.Tensor:
    """One decoder layer's single-token math, minus the KV-cache policy:
    ``attn_fn(q [B, H, Dh], k [B, Hkv, Dh], v)`` writes the cache and
    returns attention [B, H, Dh].  x [B, D] residual stream."""
    b = x.shape[0]
    q, k, v = _qkv(lp, cfg, _norm(x, lp["ln1"], cfg))
    q = apply_rope(q[:, None], positions[:, None], cos, sin)[:, 0]
    k = apply_rope(k[:, None], positions[:, None], cos, sin)[:, 0]
    attn = attn_fn(q.contiguous(), k, v)
    return _residual_tail(lp, cfg, x, attn.reshape(b, -1))


def scan_decode_layers(layers: Params, windows: list[int], cfg: ModelConfig,
                       x: torch.Tensor, positions: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       seq_lens: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor,
                       attention: Callable = decode_attention,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Every decoder layer over one token per slot, x [B, D], against the
    contiguous cache [L, B, Hkv, S, Dh]: each layer writes its token's K/V
    at ``positions`` in place, then attends over ``seq_lens`` keys
    (``attention``: kernel D's dispatch by default).  With ``k_scale`` /
    ``v_scale`` [L, B, Hkv, S] the caches are int8: the token's K/V are
    quantized on write (values and scales at ``positions``) and attention
    is the plain :func:`decode_attention_q`.  ``cos``/``sin`` are the rope
    tables on x's device.  Returns x."""
    scale = attn_scale(cfg)
    slot_idx = torch.arange(x.shape[0], device=x.device)
    pos = positions.long()
    quantized = k_scale is not None
    kw = dict(softcap=cfg.attn_logit_softcap)
    for i, window in enumerate(windows):
        kc, vc = k_cache[i], v_cache[i]

        if quantized:
            def attn_fn(q, k, v, kc=kc, vc=vc, ks=k_scale[i], vs=v_scale[i],
                        window=window):
                kq, k_sc = quantize_kv(k, ks.dtype)  # [B,Hkv,Dh], [B,Hkv]
                vq, v_sc = quantize_kv(v, vs.dtype)
                kc[slot_idx, :, pos] = kq
                vc[slot_idx, :, pos] = vq
                ks[slot_idx, :, pos] = k_sc
                vs[slot_idx, :, pos] = v_sc
                return decode_attention_q(q, kc, ks, vc, vs, seq_lens, scale,
                                          sliding_window=window, **kw)
        else:
            def attn_fn(q, k, v, kc=kc, vc=vc, window=window):
                kc[slot_idx, :, pos] = k.to(kc.dtype)
                vc[slot_idx, :, pos] = v.to(vc.dtype)
                return attention(q, kc, vc, seq_lens, scale,
                                 sliding_window=window, **kw)

        x = decode_layer_body(layer_params(layers, i), cfg, x, positions,
                              cos, sin, attn_fn)
    return x


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, seq_lens: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                attention: Callable = decode_attention,
                k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None):
    """One token per slot over the contiguous cache (updated in place).
    Returns (logits [B, V] fp32, k_cache, v_cache), plus (k_scale,
    v_scale) when the cache is int8 (scales passed in); ``seq_lens``
    counts the valid cache positions after appending this token.  ``rope``
    is the (cos, sin) tables on the cache's device (built here when None; a
    serving loop passes its precomputed pair)."""
    cos, sin = rope if rope is not None else rope_for(cfg, k_cache.device)
    x = _embed(params, cfg, tokens.long())
    x = scan_decode_layers(params["layers"], layer_sliding_windows(cfg), cfg,
                           x, positions, k_cache, v_cache, seq_lens, cos, sin,
                           attention=attention, k_scale=k_scale,
                           v_scale=v_scale)
    logits = _unembed(params, cfg, x)
    if k_scale is not None:
        return logits, k_cache, v_cache, k_scale, v_scale
    return logits, k_cache, v_cache
