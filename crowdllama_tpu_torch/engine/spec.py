"""Speculative decoding: n-gram prompt lookup and a draft model.

Counterpart of ``crowdllama_tpu/engine/spec.py``.  Each verify step runs
``1 + draft_len`` tokens a slot through ONE forward: the pending token
plus the drafts, proposed either by matching the trailing bigram against
the slot's own history (:func:`propose_ngram_drafts`) or by a small draft
model rolled out autoregressively (:class:`DraftSpecPagedModelRunner`).
Greedy slots emit exactly what plain greedy decode would (drafts decide
how MANY tokens emit per dispatch, never which); sampled slots take one
token a step from the same logits plain decode computes, with the same
threefry key split, so a seeded stream keeps the JAX package's bits.

The verify forward is the prefill layer stack with the cache as attention
context (``T.scan_prefill_layers`` with ``ctx_k``/``ctx_v``: the plain
``prefill_attention_ctx``, its GEMMs on cuBLAS, as the JAX package's is
its jnp reference).  On the paged layout the context is every slot's
whole page row gathered into a virtual-contiguous view (int8 pages
dequantized in fp32, then cast), exactly what the JAX runner attends
over; the J new KV entries scatter into the pages (the dump page for
inactive slots, whose table rows may alias live pages), quantized on an
int8 pool.  Rejected entries stay masked by ``seq_lens`` until a later
step overwrites them.

Every runner's ``decode_steps_device`` returns the PACKED int32 block
``[K, 2+J, B]`` the scheduler detects by its rank: row 0 the emit count
of the step, rows 1..J the emitted tokens (valid up to the count), the
last row the acceptance source (0 none accepted, 1 prompt echo, 2
generative).  ``draft_len`` is read once per dispatch; the adaptive
controller changes it only between dispatches, and k = 0 dispatches the
parent's plain program (2-D tokens; a CUDA graph under megastep).  State
is updated in place, as every port runner does, so a megastep graph
captured on the state stays valid across speculative flights.

``repeat_penalty`` is not applied on this path (as in the JAX package).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from crowdllama_tpu_torch.engine.paged import PagedModelRunner
from crowdllama_tpu_torch.engine.runner import ModelRunner
from crowdllama_tpu_torch.engine.sampling import sample_with_noise
from crowdllama_tpu_torch.engine.weights import init_params
from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.ops.attention import decode_attention
from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from crowdllama_tpu_torch.parallel.sharding import TPGroup


def propose_ngram_drafts(hist: torch.Tensor, seq_lens: torch.Tensor,
                         draft_len: int, max_seq: int,
                         prompt_lens: torch.Tensor | None = None):
    """Bigram prompt-lookup drafts from per-slot history ``hist`` [B, S].

    For each slot: the LATEST j with hist[j] == hist[cur-1] and
    hist[j+1] == hist[cur] (cur = seq_lens, the pending token's position),
    j+1 < cur; the drafts are the ``draft_len`` tokens that followed it
    (no match: the tokens after cur, which the first verify comparison
    rejects).  Returns ``(drafts [B, draft_len] int32, from_prompt [B]
    bool)``: ``from_prompt`` marks matches whose bigram lies inside the
    prompt (positions < ``prompt_lens``)."""
    s, k = max_seq, draft_len
    b = hist.shape[0]
    dev = hist.device
    bidx = torch.arange(b, device=dev)
    idx = torch.arange(s, device=dev)[None, :]
    cur = torch.clamp(seq_lens, max=s - 1).long()
    prev = hist[bidx, torch.clamp(cur - 1, min=0)]
    pend = hist[bidx, cur]
    m = (hist == prev[:, None]) & (torch.roll(hist, -1, dims=1)
                                   == pend[:, None])
    m &= (idx + 1 < cur[:, None]) & (cur[:, None] >= 1)
    j = torch.where(m, idx, torch.full_like(idx, -1)).amax(dim=1)
    start = torch.clamp(torch.where(j >= 0, j + 2, cur + 1), 0, s - k)
    drafts = hist.gather(1, start[:, None] + torch.arange(k, device=dev))
    if prompt_lens is None:
        prompt_lens = torch.zeros_like(cur)
    return drafts, (j >= 0) & (j + 1 < prompt_lens)


def verify_accept_emit(st, logits: torch.Tensor, drafts: torch.Tensor,
                       s_max: int, noise: torch.Tensor | None):
    """The layout-independent half of one verify step, shared by every
    spec runner.  ``logits`` [B, J, V]; ``drafts`` [B, J-1] (the ids the
    acceptance compares); ``noise`` this step's gumbel noise [B, W] (None
    when no slot samples).  Returns ``(counts [B], emit [B, J], pending
    [B], accepted [B])``."""
    model_next = logits.argmax(dim=-1).to(torch.int32)        # [B, J]
    greedy = st.temperature <= 0.0
    match = (drafts == model_next[:, :-1]) & greedy[:, None]
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    # Never speculate past the context window.
    room = torch.clamp(s_max - 1 - st.seq_lens, min=0)
    accepted = torch.minimum(accepted, room).to(torch.int32)
    sampled0 = sample_with_noise(logits[:, 0], st.temperature, st.top_p,
                                 noise, top_k=st.top_k)
    emit = model_next.clone()
    emit[:, 0] = torch.where(greedy, model_next[:, 0], sampled0)
    emit = torch.where(st.active[:, None], emit, torch.zeros_like(emit))
    counts = torch.where(st.active, accepted + 1, torch.zeros_like(accepted))
    pending = emit.gather(1, accepted[:, None].long())[:, 0]
    return counts, emit, pending, accepted


def update_hist(hist: torch.Tensor, seq_lens: torch.Tensor,
                emit: torch.Tensor, accepted: torch.Tensor,
                s_max: int) -> None:
    """Write a verify step's emitted tokens into the n-gram history in
    place: sequence position seq_lens + 1 + i holds emit[i], for i up to
    the accepted count."""
    j = emit.shape[1]
    dev = hist.device
    bidx = torch.arange(hist.shape[0], device=dev)[:, None]
    hpos = torch.clamp(seq_lens[:, None].long() + 1
                       + torch.arange(j, device=dev), max=s_max - 1)
    keep = torch.arange(j, device=dev)[None, :] <= accepted[:, None]
    hist[bidx, hpos] = torch.where(keep, emit, hist[bidx, hpos])


class _AdaptiveDraftLen:
    """The adaptive-k hook every spec runner shares: the scheduler
    retunes ``draft_len`` between dispatches; 0 pauses speculation (the
    runner dispatches its parent's plain program).  Any k schedule emits
    the same greedy stream."""

    supports_adaptive_draft = True

    def set_draft_len(self, k: int) -> None:
        self.draft_len = max(0, int(k))

    # ------------------------------------------------------------- state

    def _spec_setup(self, draft_len: int) -> None:
        self.draft_len = max(1, draft_len)
        # Per-slot prompt lengths (host, set at insert) attribute n-gram
        # matches to prompt echo or to generated history.
        self._spec_plens = np.zeros((self.max_slots,), np.int32)

    def _spec_state(self, state):
        """Give a new ``state`` its n-gram history [B, S] (a state kept for
        the megastep graphs holds it already, zeroed by ``init_state``)."""
        if state.hist is None:
            state.hist = torch.zeros((self.max_slots, self.max_seq),
                                     dtype=torch.int32, device=self.device)
        return state

    def _set_hist(self, state, slot: int, prompt: list[int], plen: int,
                  first_token: int) -> None:
        """Record the prompt's slot history: the prompt, then the pending
        token at its sequence position ``plen``."""
        self._spec_plens[slot] = plen
        if state.hist is None:
            return
        row = np.zeros((self.max_seq,), np.int32)
        if prompt:
            row[:plen] = prompt[:plen]
        if plen < self.max_seq:
            row[plen] = first_token
        state.hist[slot] = torch.from_numpy(row).to(self.device)

    # ----------------------------------------------------------- verify

    def _propose(self, st, draft_len: int):
        """(drafts [B, k], from_prompt [B]) for one verify step: n-gram
        lookup over the history."""
        plens = torch.from_numpy(self._spec_plens).to(self.device)
        return propose_ngram_drafts(st.hist, st.seq_lens, draft_len,
                                    self.max_seq, plens)

    def _verify_context(self, st, table):
        """Per rank (ctx_k, ctx_v) the verify forward attends over, and
        ctx_valid [B, C]."""
        raise NotImplementedError

    def _verify_scatter(self, st, table, positions, ks, vs) -> None:
        """Write the J new KV entries a slot (per rank [L, B, Hkv, J, Dh])
        at ``positions`` [B, J]."""
        raise NotImplementedError

    def verify_forward(self, st, table, seq_drafts: torch.Tensor):
        """The verify forward of the pending tokens and ``seq_drafts``
        [B, k] (valid ids) over the cache as context; writes nothing.
        Returns (logits [B, J, V] fp32, positions [B, J], per-rank ks and
        vs [L, B, Hkv, J, Dh])."""
        cfg, dev = self.cfg, self.device
        j = 1 + seq_drafts.shape[1]
        positions = torch.clamp(
            st.seq_lens[:, None] + torch.arange(j, device=dev,
                                                dtype=torch.int32),
            max=self.max_seq - 1)                               # [B, J]
        seq_tok = torch.cat([st.tokens[:, None], seq_drafts], dim=1)
        ctx_k, ctx_v, ctx_valid = self._verify_context(st, table)
        x = T._embed(self.params, cfg, seq_tok.long())
        x, ks, vs = T.scan_prefill_layers(
            T.layer_stacks(self.params), self.windows, cfg, x, positions,
            ctx_k=ctx_k, ctx_v=ctx_v, ctx_valid=ctx_valid, rope=self.ropes)
        return T._unembed(self.params, cfg, x), positions, ks, vs

    def _verify_step(self, st, table, seq_drafts: torch.Tensor,
                     match_drafts: torch.Tensor,
                     from_prompt: torch.Tensor) -> torch.Tensor:
        """One verify step over explicit drafts, in place on ``st``:
        ``seq_drafts`` [b, k] feed the forward (valid ids), ``match_drafts``
        the acceptance compare (the hosted path matches the raw ids, so a
        -1 sentinel is never accepted).  The rows are the slots of
        ``slot_rows`` (every slot unless dp spans processes, where each
        process verifies its own dp ranks' slots; every slot's key still
        splits).  Returns the packed [2+J, b]."""
        s_max = self.max_seq
        r = self.slot_rows
        logits, positions, ks, vs = self.verify_forward(st, table,
                                                        seq_drafts)
        self._verify_scatter(st, table, positions, ks, vs)
        noise = self._step_noise(st, 1)
        rows = _rows_of(st, r)
        counts, emit, pending, accepted = verify_accept_emit(
            rows, logits, match_drafts, s_max,
            None if noise is None else noise[0][r])
        if st.hist is not None:
            update_hist(st.hist[r], rows.seq_lens, emit, accepted, s_max)
        rows.seq_lens.add_(counts)
        rows.tokens.copy_(torch.where(rows.active, pending, rows.tokens))
        src = torch.where(counts > 1,
                          torch.where(from_prompt, 1, 2),
                          0).to(torch.int32)
        return torch.cat([counts[None], emit.T, src[None]], dim=0)

    def _spec_steps(self, state, table, num_steps: int,
                    draft_len: int) -> torch.Tensor:
        """``num_steps`` verify steps with local drafts: packed
        [K, 2+J, b] over the slots of ``slot_rows``."""
        r = self.slot_rows
        out = []
        for _ in range(num_steps):
            drafts, from_prompt = self._propose(state, draft_len)
            out.append(self._verify_step(state, table, drafts[r], drafts[r],
                                         from_prompt[r]))
        return torch.stack(out)


def _rows_of(st, r: slice) -> SimpleNamespace:
    """The per-slot fields a verify step reads and advances, as views of
    ``st``'s rows ``r`` (an update in place lands in ``st``)."""
    return SimpleNamespace(**{name: getattr(st, name)[r] for name in (
        "seq_lens", "tokens", "active", "temperature", "top_p", "top_k")})


class SpecModelRunner(_AdaptiveDraftLen, ModelRunner):
    """n-gram speculation on the contiguous cache (bf16 only: the verify
    forward reads the cache directly as attention context), on one device
    or a dp / tp mesh: each dp rank verifies its slots on its own
    parameters over its cache shards (one a tp rank).  With dp across
    processes each process verifies its own dp ranks' slots
    (``slot_rows``) and returns their packed block, which the
    leader-replicated readback gathers by dp rows, as the plain decode's
    tokens.  sp and pp meshes are refused, as in the JAX package."""

    def __init__(self, cfg, *args, draft_len: int = 4, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if self.sp > 1 or self.pp > 1:
            raise ValueError(
                "speculative decode does not compose with sp/pp meshes yet")
        if self.kv_dtype != "bf16":
            raise ValueError("speculative decode on the contiguous layout "
                             "requires the bf16 KV cache")
        self._spec_setup(draft_len)

    @torch.inference_mode()
    def init_state(self):
        return self._spec_state(super().init_state())

    @torch.inference_mode()
    def insert(self, state, slot, ks, vs, plen, first_token, temperature,
               top_p, prompt_tokens=None, slot_key=None, top_k: int = 0,
               repeat_penalty: float = 1.0):
        state = super().insert(state, slot, ks, vs, plen, first_token,
                               temperature, top_p,
                               prompt_tokens=prompt_tokens,
                               slot_key=slot_key, top_k=top_k,
                               repeat_penalty=repeat_penalty)
        self._set_hist(state, slot, list(prompt_tokens or []), plen,
                       first_token)
        return state

    def _dp_ranks(self):
        """Per dp rank of this process: (the rank, its slots' rows among
        ``slot_rows``, its tp ranks' cache indices; this process's tp
        ranks)."""
        per = self.max_slots // self.dp
        base = self.slot_rows.start
        return [(d, slice(d * per - base, (d + 1) * per - base),
                 [self._cache_index(d, 0, 0, t) for t in self.local_tp])
                for d in self.local_dp]

    def _verify_context(self, st, table):
        """Per dp rank, per tp rank, the cache shards (ctx_k, ctx_v), and
        ctx_valid [b, S] over ``slot_rows``."""
        kcs, vcs = self._ranks(st.k_cache), self._ranks(st.v_cache)
        valid = (torch.arange(self.max_seq, device=self.device)[None, :]
                 < st.seq_lens[self.slot_rows][:, None])
        ranks = self._dp_ranks()
        return ([[kcs[i] for i in idx] for _, _, idx in ranks],
                [[vcs[i] for i in idx] for _, _, idx in ranks], valid)

    def verify_forward(self, st, table, seq_drafts: torch.Tensor):
        """The mixin's verify forward over the slots of ``slot_rows``, each
        dp rank's slots on its own group: ks/vs per dp rank, per tp rank
        [L, B/dp, Hkv/tp, J, Dh]."""
        cfg, dev, r = self.cfg, self.device, self.slot_rows
        j = 1 + seq_drafts.shape[1]
        positions = torch.clamp(
            st.seq_lens[r][:, None] + torch.arange(j, device=dev,
                                                   dtype=torch.int32),
            max=self.max_seq - 1)                               # [b, J]
        seq_tok = torch.cat([st.tokens[r][:, None], seq_drafts], dim=1)
        ctx_k, ctx_v, ctx_valid = self._verify_context(st, table)
        logits, ks, vs = [], [], []
        for (d, rows, _), ck, cv in zip(self._dp_ranks(), ctx_k, ctx_v):
            group = self.groups[(d, 0, 0)]
            gdev = self._group_device(d)
            x = T._embed(group, cfg, seq_tok[rows].long().to(gdev))
            x, k, v = T.scan_prefill_layers(
                T.layer_stacks(group), self.windows, cfg, x,
                positions[rows].to(gdev), ctx_k=ck, ctx_v=cv,
                ctx_valid=ctx_valid[rows].to(gdev),
                rope=self._group_ropes(group))
            logits.append(T._unembed(group, cfg, x).to(dev))
            ks.append(k)
            vs.append(v)
        return torch.cat(logits), positions, ks, vs

    def _verify_scatter(self, st, table, positions, ks, vs) -> None:
        kcs, vcs = self._ranks(st.k_cache), self._ranks(st.v_cache)
        pos = positions.long()
        for (_, rows, idx), kd, vd in zip(self._dp_ranks(), ks, vs):
            for i, k, v in zip(idx, kd, vd):
                kc, vc = kcs[i], vcs[i]
                p = pos[rows].to(kc.device)
                bidx = torch.arange(p.shape[0], device=kc.device)[:, None]
                kc[:, bidx, :, p] = k.permute(1, 3, 0, 2, 4).to(kc.dtype)
                vc[:, bidx, :, p] = v.permute(1, 3, 0, 2, 4).to(vc.dtype)

    @torch.inference_mode()
    def decode_steps_device(self, state, num_steps: int = 1):
        k = self.draft_len
        if k == 0:
            # Paused: the plain program (2-D [K, B]); hist goes stale,
            # which costs proposal quality after a resume, never tokens.
            return ModelRunner.decode_steps_device(self, state, num_steps)
        return self._spec_steps(state, None, num_steps, k), state


class SpecPagedModelRunner(_AdaptiveDraftLen, PagedModelRunner):
    """n-gram speculation on the paged pools, bf16 or int8, one device or
    tensor-parallel (the context gather, the forward and the scatter run
    per rank).  Capacity grows by ``1 + draft_len`` a step.  It also
    verifies drafts proposed by a remote drafter (the gateway-drafted
    pipeline): :meth:`decode_steps_hosted`."""

    supports_remote_draft = True

    def __init__(self, cfg, *args, draft_len: int = 4, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self._spec_setup(draft_len)

    @torch.inference_mode()
    def init_state(self):
        return self._spec_state(super().init_state())

    @torch.inference_mode()
    def insert(self, state, slot, ks, vs, plen, first_token, temperature,
               top_p, prompt_tokens=None, slot_key=None, top_k: int = 0,
               repeat_penalty: float = 1.0):
        state = super().insert(state, slot, ks, vs, plen, first_token,
                               temperature, top_p,
                               prompt_tokens=prompt_tokens,
                               slot_key=slot_key, top_k=top_k,
                               repeat_penalty=repeat_penalty)
        self._set_hist(state, slot, list(prompt_tokens or []), plen,
                       first_token)
        return state

    def _verify_context(self, st, table):
        """Every slot's whole page row, per rank, as [L, B, Hkv, NP*page,
        Dh] in the runner's dtype (int8 pages dequantized in fp32 first);
        ctx_valid masks past ``seq_lens``."""
        cfg = self.cfg
        l, dh = cfg.num_layers, cfg.resolved_head_dim()
        hkv = cfg.num_kv_heads // self.tp
        b = self.max_slots
        view = self.max_pages_per_slot * self.page_size
        cks, cvs = [], []
        for pk, pv, ksc, vsc in self._rank_kv(st):
            idx = table.to(pk.device).long()
            ck, cv = pk[:, idx], pv[:, idx]      # [L, B, NP, Hkv, pg, Dh]
            if self.kv_dtype == "int8":
                ck = dequantize_kv(ck, ksc[:, idx])
                cv = dequantize_kv(cv, vsc[:, idx])
            cks.append(ck.permute(0, 1, 3, 2, 4, 5).reshape(
                l, b, hkv, view, dh).to(self.dtype))
            cvs.append(cv.permute(0, 1, 3, 2, 4, 5).reshape(
                l, b, hkv, view, dh).to(self.dtype))
        valid = (torch.arange(view, device=self.device)[None, :]
                 < st.seq_lens[:, None])
        return cks, cvs, valid

    def _verify_scatter(self, st, table, positions, ks, vs) -> None:
        bidx = torch.arange(self.max_slots, device=self.device)[:, None]
        pg = self.page_size
        pages = table[bidx, (positions // pg).long()]
        pages = torch.where(st.active[:, None], pages,
                            torch.full_like(pages, self.total_pages))
        for (pk, pv, ksc, vsc), k, v in zip(self._rank_kv(st), ks, vs):
            wp = pages.to(pk.device).long()
            wo = (positions % pg).to(pk.device).long()
            if self.kv_dtype == "int8":
                k, k_sc = quantize_kv(k, ksc.dtype)
                v, v_sc = quantize_kv(v, vsc.dtype)
                ksc[:, wp, :, wo] = k_sc.permute(1, 3, 0, 2)
                vsc[:, wp, :, wo] = v_sc.permute(1, 3, 0, 2)
            pk[:, wp, :, wo] = k.permute(1, 3, 0, 2, 4).to(pk.dtype)
            pv[:, wp, :, wo] = v.permute(1, 3, 0, 2, 4).to(pv.dtype)

    def pre_decode_check(self, steps: int) -> list[int]:
        return super().pre_decode_check(steps * (1 + self.draft_len))

    def _grow(self, tokens: int) -> None:
        for slot in list(self._slot_pages):
            if slot != self._ragged_slot:
                self._ensure_slot(slot, tokens)

    @torch.inference_mode()
    def decode_steps_device(self, state, num_steps: int = 1):
        k = self.draft_len
        if k == 0:
            # Paused: the plain paged program; the history (and a draft
            # cache) goes stale, which only lowers acceptance later.
            return PagedModelRunner.decode_steps_device(self, state,
                                                        num_steps)
        j = 1 + k
        self._grow(num_steps * j)
        packed = self._spec_steps(state, self._table(), num_steps, k)
        self._advance_host(num_steps * j, skip=self._ragged_slot)
        return packed, state

    @torch.inference_mode()
    def decode_steps_hosted(self, state, drafts_np: np.ndarray):
        """One verify step over remotely proposed drafts ``drafts_np``
        [B, k] int32, -1 marking a slot with no draft this round (it
        degrades to one exact greedy token).  ``1 <= k <= draft_len``, so
        ``pre_decode_check(1)``'s reserve covers it.  Returns the packed
        [1, 2+J, B] block one local step makes; the local proposal state
        is untouched (the remote drafter owns it)."""
        k = int(drafts_np.shape[1])
        if not 1 <= k <= self.draft_len:
            raise ValueError(f"hosted chunk k={k} outside "
                             f"[1, {self.draft_len}]")
        self._grow(1 + k)
        drafts = torch.from_numpy(np.ascontiguousarray(
            drafts_np, dtype=np.int32)).to(self.device)
        from_prompt = torch.zeros(self.max_slots, dtype=torch.bool,
                                  device=self.device)
        packed = self._verify_step(state, self._table(),
                                   torch.clamp(drafts, min=0), drafts,
                                   from_prompt)[None]
        self._advance_host(1 + k, skip=self._ragged_slot)
        return packed, state

    # While a ragged prefill runs the scheduler dispatches the inherited
    # plain ragged step: speculation pauses for the batch and resumes at
    # the next ordinary decode dispatch.

    @torch.inference_mode()
    def ragged_finish(self, state, job, temperature, top_p, key=None,
                      slot_key=None, top_k: int = 0,
                      repeat_penalty: float = 1.0):
        first, state = super().ragged_finish(
            state, job, temperature, top_p, key, slot_key=slot_key,
            top_k=top_k, repeat_penalty=repeat_penalty)
        self._set_hist(state, job.slot, list(job.prompt_ids),
                       len(job.prompt_ids), first)
        return first, state


class DraftSpecPagedModelRunner(SpecPagedModelRunner):
    """Draft-model speculation on the paged pools: a small model proposes
    ``draft_len`` tokens autoregressively each verify step (kernel D over
    its own contiguous cache ``draft_k``/``draft_v`` [Ld, B, Hkv_d, S,
    Dh_d], dtype of the draft weights, on rank 0's device), the main
    model verifies them in one forward.  The draft prefills each prompt
    (kernel A) at insert and at ``ragged_finish`` and then extends its
    cache in lockstep with the accepted stream; the correction token the
    main model emits on a miss is the next step's draft input, so the
    caches never diverge.  Needs ``draft_cfg.vocab_size == cfg.vocab_size``."""

    def __init__(self, cfg, *args, draft_cfg, draft_params: dict | None = None,
                 draft_seed: int = 0, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(f"draft vocab {draft_cfg.vocab_size} != main "
                             f"{cfg.vocab_size}")
        self.draft_cfg = draft_cfg
        if draft_params is None:
            draft_params = init_params(draft_cfg, seed=draft_seed,
                                       dtype=self.dtype, device=self.device)

        def place(tree):
            return {k: place(v) if isinstance(v, dict)
                    else v.to(self.device) for k, v in tree.items()}

        #: the draft's parameter dict, as a one-rank shard list (whole,
        #: beside a main model whose tp may span processes)
        self.draft_params = TPGroup([place(draft_params)])
        self._draft_dtype = self.draft_params[0]["embed"].dtype
        self.draft_rope = [T.rope_for(draft_cfg, self.device)]
        #: the draft's decode attention (kernel D); a seam like decode_attn
        self.draft_decode_attn = decode_attention

    @torch.inference_mode()
    def init_state(self):
        state = super().init_state()  # no n-gram history: see _spec_state
        if state.draft_k is None:  # else kept, and zeroed, as the history
            dc = self.draft_cfg
            shape = (dc.num_layers, self.max_slots, dc.num_kv_heads,
                     self.max_seq, dc.resolved_head_dim())
            kw = dict(dtype=self._draft_dtype, device=self.device)
            state.draft_k = torch.zeros(shape, **kw)
            state.draft_v = torch.zeros(shape, **kw)
        return state

    def _spec_state(self, state):
        return state  # no n-gram history

    def _draft_prefill(self, state, slot: int, prompt: list[int]) -> None:
        """Run the draft over one prompt and write its KV into the slot's
        rows of the draft cache."""
        if not prompt:
            return  # no prompt: the first drafts just miss
        plen = len(prompt)
        t = self.bucket_for(plen)
        ar = torch.arange(t, device=self.device, dtype=torch.int32)
        positions = torch.clamp(ar, max=plen - 1)[None]
        kv_valid = (ar < plen)[None]
        _, (ks,), (vs,) = T.prefill(self.draft_params, self.draft_cfg,
                                    self._padded(prompt, t), positions,
                                    kv_valid=kv_valid, rope=self.draft_rope)
        state.draft_k[:, slot, :, :t] = ks[:, 0].to(state.draft_k.dtype)
        state.draft_v[:, slot, :, :t] = vs[:, 0].to(state.draft_v.dtype)

    @torch.inference_mode()
    def insert(self, state, slot, ks, vs, plen, first_token, temperature,
               top_p, prompt_tokens=None, slot_key=None, top_k: int = 0,
               repeat_penalty: float = 1.0):
        state = super().insert(state, slot, ks, vs, plen, first_token,
                               temperature, top_p,
                               prompt_tokens=prompt_tokens,
                               slot_key=slot_key, top_k=top_k,
                               repeat_penalty=repeat_penalty)
        self._draft_prefill(state, slot, list(prompt_tokens or [])[:plen])
        return state

    @torch.inference_mode()
    def ragged_finish(self, state, job, temperature, top_p, key=None,
                      slot_key=None, top_k: int = 0,
                      repeat_penalty: float = 1.0):
        first, state = super().ragged_finish(
            state, job, temperature, top_p, key, slot_key=slot_key,
            top_k=top_k, repeat_penalty=repeat_penalty)
        # Ragged chunks fill only the main pool: the draft needs the whole
        # prompt in its own cache.
        self._draft_prefill(state, job.slot, list(job.prompt_ids))
        return first, state

    def _draft_step(self, st, tok, pos) -> torch.Tensor:
        """One draft decode step for every slot at positions ``pos``
        (extends the draft cache in place); returns its logits."""
        s_max = self.max_seq
        return T.decode_step(
            self.draft_params, self.draft_cfg, tok,
            torch.clamp(pos, max=s_max - 1), st.draft_k, st.draft_v,
            torch.clamp(pos + 1, max=s_max), rope=self.draft_rope,
            attention=self.draft_decode_attn)[0]

    def _propose(self, st, draft_len: int):
        """Greedy draft rollout of ``draft_len`` tokens from the pending
        one, then the last draft token's KV ingested too (a fully accepted
        window advances past it).  Draft-model proposals are generative:
        ``from_prompt`` is all False."""
        tok, pos = st.tokens, st.seq_lens
        drafts = []
        for _ in range(draft_len):
            tok = self._draft_step(st, tok, pos).argmax(dim=-1).to(
                torch.int32)
            pos = pos + 1
            drafts.append(tok)
        self._draft_step(st, tok, pos)
        return (torch.stack(drafts, dim=1),
                torch.zeros(self.max_slots, dtype=torch.bool,
                            device=self.device))
