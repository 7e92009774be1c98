"""The decoder core (Llama / Gemma-2 / Qwen / Mistral / Mixtral switches).

Counterpart of ``crowdllama_tpu/models/transformer.py``: plain functions
over a parameter dict whose layer weights are stacked on a leading layer
axis (``params["layers"][name]`` is ``[L, ...]``), the same names and
shapes as the JAX package's pytree, so weights cross between the packages
through numpy (``engine/weights.py params_from_numpy``).  The JAX layer
``scan`` becomes a Python loop over layers.  Weights are bf16 on the card;
norms and softmax accumulate in fp32.

Weight products go through :func:`qmatmul` (the JAX package's
``qeinsum``): a plain weight is a ``torch.matmul``; a quantized one
(``ops/quant.py QTensor`` / ``QTensor4``) goes through kernel G on the
card (``ops/cuda/gemm.py``, dequantising in the kernel) and through its
plain version on the CPU.  Mixture-of-experts layers (Mixtral, Qwen3-MoE)
route each token to its top-k experts (:func:`_route_topk`) and run the
experts as grouped products over the tokens sorted by expert
(:func:`_moe_sorted`, kernel G), or over every expert
(:func:`_moe_dense`, ``moe_dispatch="dense"``, the oracle); neither reads
a routing value on the host.  A check that holds the kernel route
against the plain one swaps this module's ``grouped_gemm`` for
``grouped_gemm_plain`` (both products look it up at each call).

Tensor parallelism: the forward functions take ``shards``, the list of
per-rank parameter dicts of one (dp, pp, sp) coordinate that
``parallel/sharding.py rank_groups`` makes (one dict on one device).  Each
rank computes its heads and its slice of the MLP on its device; the
row-parallel products, the embedding and the logits go through the
sharding module's reductions, which pass a single rank's tensor through
untouched.  The values that are per rank (K/V, attention inputs and
outputs, ``rope`` tables) are per-rank lists too.  The activations
between layers are one tensor on rank 0's device.  Expert parallelism: an
expert leaf sharded on ep is an ``ExpertBanks``; each bank runs kernel G
over the rows routed to its experts on its device and the rows join in
the one-device combine order (:func:`_expert_ffn`).  Sequence
parallelism (``sp=True`` in :func:`scan_prefill_layers`,
:func:`hidden_states` and :func:`scan_decode_layers`): prefill runs each
sp rank's token shard on its own parameters with the ring attention of
``ops/ring.py`` between them; decode writes and reads the sequence-
sharded cache through ``sp_cache_update`` / ``sp_decode_attention``.
Pipeline stages run these layer scans over their own layers
(``parallel/pipeline.py``).
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
from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm
from crowdllama_tpu_torch.ops.norms import rms_norm
from crowdllama_tpu_torch.ops.quant import QTensor, qeinsum, quantize_kv
from crowdllama_tpu_torch.ops.ring import (
    ring_prefill_attention,
    sp_cache_update,
    sp_decode_attention,
)
from crowdllama_tpu_torch.ops.rope import apply_rope, rope_table
from crowdllama_tpu_torch.parallel.sharding import (
    ExpertBanks,
    like,
    row_parallel_sum,
    tp_comm,
    vocab_embed,
    vocab_gather,
)

Params = dict[str, Any]

def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``: ``torch.matmul`` for a plain weight,
    kernel G (one expert over every row) for a quantized one."""
    if not isinstance(w, QTensor):
        return x @ w
    lead = x.shape[:-1]
    y = grouped_gemm(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, y.shape[-1])


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cpu") -> Params:
    """Random-init a parameter dict (layers stacked on axis 0) from
    ``generator`` (which must live on ``device``)."""
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
    }
    if cfg.attn_qkv_bias:  # Qwen2/2.5
        layers.update(bq=zeros(nl, h * dh), bk=zeros(nl, hkv * dh),
                      bv=zeros(nl, hkv * dh))
    if cfg.qk_norm:  # Qwen3
        layers.update(q_norm=ones(nl, dh), k_norm=ones(nl, dh))
    if cfg.is_moe:
        e = cfg.num_experts
        layers["router"] = dense(nl, d, e, fan_in=d)
        layers["w_gate"] = dense(nl, e, d, f, fan_in=d)
        layers["w_up"] = dense(nl, e, d, f, fan_in=d)
        layers["w_down"] = dense(nl, e, f, d, fan_in=f)
    else:
        layers["w_gate"] = dense(nl, d, f, fan_in=d)
        layers["w_up"] = dense(nl, d, f, fan_in=d)
        layers["w_down"] = dense(nl, f, d, fan_in=f)
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
    """Each rank's stacked layer weights (a tp group across processes
    keeps its comm)."""
    return like(shards, [p["layers"] for p in shards])


def layer_stacks_sp(groups: list[list[Params]]) -> list[list[Params]]:
    """Each sp rank's :func:`layer_stacks`."""
    return [layer_stacks(g) for g in groups]


def layer_params(layers: list[Params], i: int) -> list[Params]:
    """Layer ``i`` of each rank's stacked layer weights."""
    return like(layers, [{k: w[i] for k, w in stack.items()}
                         for stack in layers])


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
    x = vocab_embed([p["embed"] for p in shards], tokens, tp_comm(shards))
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
        else:  # a quantized lm_head dequantised, as JAX's qeinsum
            parts.append(qeinsum("...d,dv->...v", xr, p["lm_head"],
                                 dtype=torch.float32))
    logits = vocab_gather(parts, tp_comm(shards))
    if cfg.final_logit_softcap > 0:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _mlp(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU (Llama) / GeGLU-tanh (Gemma) MLP. x: [..., D]."""
    gate = qmatmul(x, lp["w_gate"])
    up = qmatmul(x, lp["w_up"])
    act = (F.gelu(gate, approximate="tanh") if cfg.family == "gemma2"
           else F.silu(gate))
    return qmatmul(act * up, lp["w_down"])


def _route_topk(lp: Params, cfg: ModelConfig, x: torch.Tensor):
    """Router top-k: (weights [..., K] fp32 softmaxed, expert ids [..., K]
    int64).  A stable descending sort keeps ``lax.top_k``'s order on
    ties (the lower expert id first)."""
    logits = x.float() @ lp["router"].float()
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    return torch.softmax(top[..., :k], dim=-1), ids[..., :k]


def _bank_ffn(w_gate, w_up, w_down, xs: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """One bank's SwiGLU over rows grouped by expert: three grouped
    products."""
    gate = grouped_gemm(xs, w_gate, offsets)
    up = grouped_gemm(xs, w_up, offsets)
    act = (F.silu(gate) * up).to(xs.dtype)
    return grouped_gemm(act, w_down, offsets)


def _expert_ffn(lp: Params, xs: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over rows grouped by expert (``offsets``
    [E + 1] int32 on the device).  With the banks sharded on ep
    (``ExpertBanks``) each bank runs on its device over the rows of its
    experts (``offsets[lo:hi + 1]``: kernel G writes only the rows of a
    group) and its rows are taken into the result where they lie, so the
    rows, and the combine after, are the one-device ones."""
    if not isinstance(lp["w_gate"], ExpertBanks):
        return _bank_ffn(lp["w_gate"], lp["w_up"], lp["w_down"], xs, offsets)
    n_banks = len(lp["w_gate"])
    per = (offsets.shape[0] - 1) // n_banks
    rows = torch.arange(xs.shape[0], device=xs.device)
    out = None
    for b, (wg, wu, wd) in enumerate(zip(lp["w_gate"].banks,
                                         lp["w_up"].banks,
                                         lp["w_down"].banks)):
        dev = wg.device
        lo, hi = b * per, (b + 1) * per
        y = _bank_ffn(wg, wu, wd, xs.to(dev), offsets[lo:hi + 1].to(dev))
        y = y.to(xs.device)
        mine = ((rows >= offsets[lo]) & (rows < offsets[hi]))[:, None]
        out = torch.where(mine, y, torch.zeros_like(y) if out is None
                          else out)
    return out


def _moe_dense(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, weighted by the router's top-k
    (``moe_dispatch="dense"``; the oracle of :func:`_moe_sorted`, E / K
    times its products).  The tokens are repeated once per expert and run
    as one grouped product of E equal groups."""
    e = cfg.num_experts
    topw, topi = _route_topk(lp, cfg, x)
    experts = torch.arange(e, device=x.device)
    one_hot = (topi[..., None] == experts).float()            # [..., K, E]
    weights = torch.einsum("...ke,...k->...e", one_hot, topw)
    xf = x.reshape(-1, x.shape[-1])
    n = xf.shape[0]
    offsets = torch.arange(e + 1, device=x.device, dtype=torch.int32) * n
    per = _expert_ffn(lp, xf.repeat(e, 1).contiguous(), offsets)
    per = per.float().reshape(e, n, -1)                      # [E, N, D]
    out = torch.einsum("end,ne->nd", per, weights.reshape(n, e))
    return out.reshape(x.shape).to(x.dtype)


def _moe_sorted(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Sorted token-grouping MoE dispatch: the N * K (token, expert) pairs
    sorted by expert (stable, as ``jnp.argsort``), each token row computed
    for exactly its K experts by grouped products, the rows weighted by
    their fp32 router weights and summed per token in ascending expert
    order, the order of the JAX function's scatter-add (so any K gives
    its sums; for K = 2 the order cannot matter).  Group sizes come from
    a comparison sum and offsets from a cumsum, on the device."""
    shape = x.shape
    d = shape[-1]
    xf = x.reshape(-1, d)
    n, k, e = xf.shape[0], cfg.num_experts_per_tok, cfg.num_experts
    topw, topi = _route_topk(lp, cfg, xf)                     # [N, K]
    e_flat = topi.reshape(-1)                                 # [NK]
    order = torch.argsort(e_flat, stable=True)
    xs = xf.index_select(0, order // k)                       # [NK, D]
    experts = torch.arange(e, device=x.device)
    sizes = (e_flat[:, None] == experts).sum(0)
    offsets = F.pad(torch.cumsum(sizes, 0), (1, 0)).to(torch.int32)
    ys = _expert_ffn(lp, xs, offsets)                         # [NK, D]
    contrib = ys.float() * topw.reshape(-1)[order][:, None]
    per = torch.empty_like(contrib).index_copy_(0, order, contrib)
    per = per.reshape(n, k, d)
    by_expert = torch.argsort(topi, dim=-1, stable=True)      # [N, K]
    per = per.gather(1, by_expert[..., None].expand(n, k, d))
    out = per[:, 0]
    for j in range(1, k):
        out = out + per[:, j]
    return out.reshape(shape).to(x.dtype)


def _moe(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Top-k MoE, x [..., D]; dispatches per ``cfg.moe_dispatch``."""
    if cfg.moe_dispatch == "dense":
        return _moe_dense(lp, cfg, x)
    return _moe_sorted(lp, cfg, x)


def _ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _moe(lp, cfg, x) if cfg.is_moe else _mlp(lp, cfg, x)


def _qkv(lp: Params, cfg: ModelConfig, h: torch.Tensor):
    """Projections (+ Qwen bias / qk-norm) for h [..., D] -> q [..., H, Dh],
    k/v [..., Hkv, Dh]."""
    dh = cfg.resolved_head_dim()
    q, k, v = (qmatmul(h, lp["wq"]), qmatmul(h, lp["wk"]),
               qmatmul(h, lp["wv"]))
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
    comm = tp_comm(lps)
    attn = row_parallel_sum([qmatmul(a, lp["wo"])
                             for a, lp in zip(attns, lps)], comm)
    if cfg.post_norms:
        attn = _norm(attn, lps[0]["post_ln1"], cfg, plus_one=True)
    x = x + attn
    h = _norm(x, lps[0]["ln2"], cfg)
    mlp_out = row_parallel_sum([_ffn(lp, cfg, h.to(lp["w_down"].device))
                                for lp in lps], comm)
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
                        rope: list | None = None, sp: bool = False):
    """Run every decoder layer over x [B, T, D] (``layers``: each rank's
    stacked weights); returns (x, ks, vs) with ks/vs per rank, each
    [L, B, Hkv/tp, T, Dh] head-major and contiguous on its rank's device.

    With ``sp`` the sequence is sharded over the sp ranks: ``layers``,
    ``x`` ([B, T/sp, D]), ``positions``, ``kv_valid`` and ``rope`` are
    lists over the sp ranks (each entry what the one-rank call takes),
    attention is :func:`ring_prefill_attention` between the shards, and
    the result is (xs, ks, vs) with ks/vs per sp rank per tp rank
    [L, B, Hkv/tp, T/sp, Dh].  No prefix context under sp.

    With ``ctx_k``/``ctx_v`` (per rank [L, B, Hkv/tp, C, Dh], ``ctx_valid``
    [B, C]) the batch is a suffix continuing a cached prefix: queries
    attend jointly over the context and the causal suffix
    (``prefill_attention_ctx``) and ks/vs cover the suffix only.
    ``attention`` is the no-context attention function (kernel A's
    dispatch by default).  ``rope`` is the per-rank (cos, sin) pairs
    (built here when None; a runner passes its own)."""
    if sp:
        assert ctx_k is None, "prefix-context prefill does not compose with sp"
        return _scan_prefill_sp(layers, windows, cfg, x, positions, kv_valid,
                                rope)
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


def _scan_prefill_sp(layers: list, windows: list[int], cfg: ModelConfig,
                     xs: list, positions: list, kv_valid: list | None,
                     rope: list | None):
    """:func:`scan_prefill_layers` with the sequence on sp (its ``sp``
    branch): each sp rank's token shard through its own layers, the ring
    between the shards of each tp rank."""
    scale = attn_scale(cfg)
    n = len(layers)
    ropes = [_ropes(None if rope is None else rope[s], cfg, layers[s])
             for s in range(n)]
    if kv_valid is None:
        kv_valid = [None] * n
    tp = len(layers[0])
    ks = [[[] for _ in range(tp)] for _ in range(n)]
    vs = [[[] for _ in range(tp)] for _ in range(n)]
    for i, window in enumerate(windows):
        lps = [layer_params(stack, i) for stack in layers]
        qkv = []  # per sp rank, per tp rank: (q, k, v, positions, valid)
        for s in range(n):
            h = _norm(xs[s], lps[s][0]["ln1"], cfg)
            row = []
            for r, lp in enumerate(lps[s]):
                dev = lp["wq"].device
                pos = positions[s].to(dev)
                valid = (torch.ones(pos.shape, dtype=torch.bool, device=dev)
                         if kv_valid[s] is None else kv_valid[s].to(dev))
                q, k, v = _qkv(lp, cfg, h.to(dev))
                cos, sin = ropes[s][r]
                q = apply_rope(q, pos, cos, sin)
                k = apply_rope(k, pos, cos, sin)
                row.append((q, k, v, pos, valid))
                ks[s][r].append(k.transpose(1, 2).contiguous())
                vs[s][r].append(v.transpose(1, 2).contiguous())
            qkv.append(row)
        attns = [[None] * tp for _ in range(n)]
        for r in range(tp):
            outs = ring_prefill_attention(
                [qkv[s][r][0] for s in range(n)],
                [qkv[s][r][1] for s in range(n)],
                [qkv[s][r][2] for s in range(n)],
                [qkv[s][r][3] for s in range(n)], scale,
                softcap=cfg.attn_logit_softcap, sliding_window=window,
                kv_valid=[qkv[s][r][4] for s in range(n)])
            for s in range(n):
                b, t = outs[s].shape[:2]
                attns[s][r] = outs[s].reshape(b, t, -1)
        xs = [_residual_tail(lps[s], cfg, xs[s], attns[s]) for s in range(n)]
    return (xs, [[torch.stack(k) for k in row] for row in ks],
            [[torch.stack(v) for v in row] for row in vs])


def sp_split(x: torch.Tensor, groups: list[list[Params]]) -> list:
    """x [B, T, ...] cut along T into one shard per sp rank, each on its
    rank's device (``groups``: the sp ranks' tp lists)."""
    parts = x.chunk(len(groups), dim=1)
    return [p.to(g[0]["final_norm"].device).contiguous()
            for p, g in zip(parts, groups)]


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
                  rope=None, sp: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, T, D]: the embeddings forward (the
    prefill layer stack without the vocab projection).  With ``sp``,
    ``shards`` and ``rope`` are per sp rank and the sequence is sharded
    over them (ring attention); the shards' states are gathered on the
    first rank's device."""
    if sp:
        groups = shards
        xs = [_embed(g, cfg, t.to(g[0]["final_norm"].device))
              for g, t in zip(groups, sp_split(tokens, groups))]
        xs, _, _ = scan_prefill_layers(
            layer_stacks_sp(groups), layer_sliding_windows(cfg), cfg, xs,
            sp_split(positions, groups),
            kv_valid=None if kv_valid is None else sp_split(kv_valid, groups),
            rope=rope, sp=True)
        dev = groups[0][0]["final_norm"].device
        x = torch.cat([x.to(dev) for x in xs], dim=1)
        return _norm(x, groups[0][0]["final_norm"], cfg)
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
                       positions: torch.Tensor, k_cache, v_cache,
                       seq_lens: torch.Tensor, rope: list,
                       attention: Callable = decode_attention,
                       k_scale=None, v_scale=None,
                       sp: bool = False) -> torch.Tensor:
    """Every decoder layer over one token per slot, x [B, D], against the
    contiguous cache (``layers`` and ``rope``: each tp rank's): each layer
    writes its token's K/V at ``positions`` in place, then attends over
    ``seq_lens`` keys (``attention``: kernel D's dispatch by default).
    ``k_cache``/``v_cache`` are the cache [L, B, Hkv, S, Dh] of a
    one-rank model, or one a tp rank [L, B, Hkv/tp, S, Dh] on the rank's
    device.  With ``k_scale`` / ``v_scale`` (the same per rank, [L, B,
    Hkv, S]) the caches are int8: the token's K/V are quantized on write
    (values and scales at ``positions``) and attention is the plain
    :func:`decode_attention_q`.  With ``sp`` each rank's entry is a list
    of its sequence shards [L, B, Hkv/tp, S/sp, Dh]: the token is written
    by :func:`sp_cache_update` and attention is
    :func:`sp_decode_attention` (no int8 cache under sp).  Returns x."""
    quantized = k_scale is not None
    if quantized:
        assert not sp, "int8 KV cache does not compose with sp yet"
    per_rank = isinstance(k_cache, list)
    kcs = k_cache if per_rank else [k_cache]
    vcs = v_cache if per_rank else [v_cache]
    kss = (k_scale if per_rank else [k_scale]) if quantized else None
    vss = (v_scale if per_rank else [v_scale]) if quantized else None
    scale = attn_scale(cfg)
    kw = dict(softcap=cfg.attn_logit_softcap)
    on_dev: dict = {}  # device -> (slot indices, positions, seq_lens)

    def idx(dev):
        if dev not in on_dev:
            on_dev[dev] = (torch.arange(x.shape[0], device=dev),
                           positions.to(dev).long(), seq_lens.to(dev))
        return on_dev[dev]

    for i, window in enumerate(windows):

        def attn_fn(qs, ks, vs, i=i, window=window):
            outs = []
            for r, (q, k, v) in enumerate(zip(qs, ks, vs)):
                slot_idx, pos, lens = idx(q.device)
                if sp:
                    kc = [c[i] for c in kcs[r]]
                    vc = [c[i] for c in vcs[r]]
                    sp_cache_update(k, v, pos, kc, vc)
                    outs.append(sp_decode_attention(
                        q, kc, vc, lens, scale, sliding_window=window, **kw))
                    continue
                kc, vc = kcs[r][i], vcs[r][i]
                if quantized:
                    k_sc, v_sc = kss[r][i], vss[r][i]
                    kq, k_row = quantize_kv(k, k_sc.dtype)  # [B,Hkv,Dh]
                    vq, v_row = quantize_kv(v, v_sc.dtype)
                    kc[slot_idx, :, pos] = kq
                    vc[slot_idx, :, pos] = vq
                    k_sc[slot_idx, :, pos] = k_row
                    v_sc[slot_idx, :, pos] = v_row
                    outs.append(decode_attention_q(
                        q, kc, k_sc, vc, v_sc, lens, scale,
                        sliding_window=window, **kw))
                else:
                    kc[slot_idx, :, pos] = k.to(kc.dtype)
                    vc[slot_idx, :, pos] = v.to(vc.dtype)
                    outs.append(attention(q, kc, vc, lens, scale,
                                          sliding_window=window, **kw))
            return outs

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
