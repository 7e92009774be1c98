"""ModelRunner: prefill, chunked prefill, embeddings and the contiguous KV
layout.

Counterpart of the one-device part of ``crowdllama_tpu/engine/runner.py``
``ModelRunner``: the parameters, the prefill buckets, bucketed monolithic
prefill with first-token sampling, legacy chunked admission
(``prefill_begin`` / ``prefill_step`` / ``prefill_finish``, the plain
``prefill_attention_ctx`` over the job's KV accumulators), the
embeddings forward (``embed_prompts``, kernel A through
``T.hidden_states``), and the contiguous cache ``[L, B, Hkv, S, Dh]``
whose decode step reads each slot's keys through kernel D.  With
``kv_dtype="int8"`` the cache is int8 with per-(position, kv head) bf16
scales ``[L, B, Hkv, S]``: insert quantizes the prefilled bucket, decode
quantizes each new token and attends with the plain
``decode_attention_q`` (the JAX package has no Pallas kernel for this
path either).  The paged subclass (``engine/paged.py``) replaces the cache
layout and reuses the rest.  The base runner holds the tp mesh and the
per-rank parameters and rope tables (lists of one on one device); only
the paged runner serves over more than one rank.  Sequence/pipeline
parallelism and speculation are not ported yet.

Sampling keys: each slot carries a threefry key ``[2]`` uint32 in the
state (host numpy, ``engine/prng.py``); every decode step splits every
slot's key, live or not, and samples with the sub-key, as the JAX decode
step does, so a seeded request draws the same tokens on both packages.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device, construction raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from crowdllama_tpu_torch.engine import prng
from crowdllama_tpu_torch.engine.sampling import (
    REPEAT_LAST_N,
    apply_repeat_penalty,
    default_slot_key,
    noise_width,
    sample_tokens,
    sample_with_noise,
    split_slot_keys,
)
from crowdllama_tpu_torch.engine.weights import init_params
from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.ops.attention import decode_attention, prefill_attention
from crowdllama_tpu_torch.ops.quant import quantize_kv
from crowdllama_tpu_torch.parallel.mesh import Mesh, build_mesh
from crowdllama_tpu_torch.parallel.sharding import shard_params

KV_DTYPES = ("bf16", "int8")


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device a runner serves on: ``device`` as given, else CUDA.
    Never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def prefill_buckets(max_seq: int) -> list[int]:
    buckets, b = [], 32
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return buckets


@dataclass(kw_only=True)
class SlotState:
    """Per-slot decode state shared by both KV layouts (device tensors,
    plus the host-side sampling keys)."""

    seq_lens: torch.Tensor        # [B] int32 (tokens in cache; last pending)
    tokens: torch.Tensor          # [B] int32 last sampled token per slot
    active: torch.Tensor          # [B] bool
    temperature: torch.Tensor     # [B] f32
    top_p: torch.Tensor           # [B] f32
    top_k: torch.Tensor           # [B] int32 (0 = off)
    repeat_penalty: torch.Tensor  # [B] f32 (1 = off)
    recent: torch.Tensor          # [B, REPEAT_LAST_N] int32 last-N ring
    # Per-slot threefry keys [B, 2] uint32, split every step: a slot's
    # draws depend only on its own key chain, never on batch composition.
    keys: np.ndarray
    # Host mirror of ``active & temperature > 0``: a step where no slot
    # samples makes no noise (its tokens are argmaxes either way).
    sampled: np.ndarray


@dataclass(kw_only=True)
class DecodeState(SlotState):
    """Contiguous-layout decode state."""

    k_cache: torch.Tensor         # [L, B, Hkv, S, Dh] head-major (int8
    v_cache: torch.Tensor         # with kv_dtype="int8")
    k_scale: torch.Tensor | None = None  # [L, B, Hkv, S] bf16, int8 only
    v_scale: torch.Tensor | None = None


class ModelRunner:
    """The contiguous-layout runner, and the base of the paged one."""

    #: the scheduler admits prompts longer than this chunk by chunk
    #: (legacy chunked admission); 0 disables
    prefill_chunk = 512
    #: the contiguous layout has no unified ragged step
    supports_ragged = False
    kv_layout = "contiguous"
    _EMBED_BATCH = (1, 2, 4, 8)  # padded batch sizes of the embed forward

    def __init__(self, cfg: ModelConfig, params: dict | None = None,
                 max_slots: int = 8, max_seq: int = 0,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: torch.device | str | None = None,
                 kv_dtype: str = "bf16", mesh_shape: str = "",
                 devices: list | None = None):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.cfg = cfg
        self.mesh = self._build_mesh(mesh_shape, device, devices)
        #: the tp ranks' devices, rank 0's first; the slot state, the
        #: activations between layers and the logits live on rank 0's
        self.devices = list(self.mesh.devices)
        self.device = self.devices[0]
        self.tp = self.mesh.tp
        self.max_slots = max_slots
        self.max_seq = max_seq or cfg.max_context_length
        if params is None:
            # Under tp the full random init is made on the host, so no
            # card ever holds more than its ranks' slices.
            params = init_params(cfg, seed, dtype=dtype, device=(
                self.device if self.tp == 1 else "cpu"))
        #: the per-rank parameter dicts (one on one device); the full dict
        #: is not kept
        self.params = shard_params(params, cfg, self.mesh)
        self.dtype = self.params[0]["embed"].dtype
        self.buckets = prefill_buckets(self.max_seq)
        self.windows = T.layer_sliding_windows(cfg)
        self.scale = T.attn_scale(cfg)
        #: per-rank (cos, sin) rope tables; ranks on one device share a pair
        tables: dict = {}
        for d in self.devices:
            if d not in tables:
                tables[d] = T.rope_for(cfg, d)
        self.ropes = [tables[d] for d in self.devices]
        self.noise_w = noise_width(cfg.vocab_size)
        #: no-context prefill attention (kernel A) and contiguous decode
        #: attention (kernel D); seams that let a caller run the same step
        #: through the plain versions
        self.prefill_attn = prefill_attention
        self.decode_attn = decode_attention

    def _build_mesh(self, mesh_shape: str, device,
                    devices: list | None) -> Mesh:
        """The runner's mesh: one device (``device``, else CUDA) unless a
        mesh spec or a device list is given.  The contiguous layout serves
        on one device only."""
        if not mesh_shape and devices is None:
            return Mesh.single(resolve_device(device))
        if device is not None:
            raise ValueError("pass device= or a mesh (mesh_shape=/devices=), "
                             "not both")
        mesh = build_mesh(mesh_shape, devices)
        if mesh.size > 1 and self.kv_layout != "paged":
            raise NotImplementedError(
                f"mesh {mesh.axes} on the {self.kv_layout} layout is not "
                f"ported yet: multi-device meshes other than tp on the paged "
                f"layout (ROADMAP Queue 1 item 8)")
        return mesh

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_seq {self.max_seq}")

    # -------------------------------------------------------- slot state

    def _slot_fields(self) -> dict:
        """Fresh per-slot fields of a decode state (every slot free)."""
        dev, b = self.device, self.max_slots
        i32 = dict(dtype=torch.int32, device=dev)
        return dict(
            seq_lens=torch.zeros(b, **i32), tokens=torch.zeros(b, **i32),
            active=torch.zeros(b, dtype=torch.bool, device=dev),
            temperature=torch.zeros(b, dtype=torch.float32, device=dev),
            top_p=torch.ones(b, dtype=torch.float32, device=dev),
            top_k=torch.zeros(b, **i32),
            repeat_penalty=torch.ones(b, dtype=torch.float32, device=dev),
            recent=torch.full((b, REPEAT_LAST_N), self.cfg.vocab_size, **i32),
            # Zero keys: valid carries, overwritten when a slot activates.
            keys=np.zeros((b, 2), np.uint32), sampled=np.zeros((b,), bool))

    def _activate(self, st: SlotState, slot: int, plen: int,
                  first_token: int, temperature: float, top_p: float,
                  top_k: int, repeat_penalty: float, recent_row: np.ndarray,
                  slot_key) -> None:
        """Flip ``slot`` live with its sampling parameters and key."""
        st.seq_lens[slot] = plen
        st.tokens[slot] = first_token
        st.active[slot] = True
        st.temperature[slot] = temperature
        st.top_p[slot] = top_p
        st.top_k[slot] = top_k
        st.repeat_penalty[slot] = repeat_penalty
        st.recent[slot] = torch.as_tensor(recent_row, device=self.device)
        st.keys[slot] = (default_slot_key(slot) if slot_key is None
                         else slot_key)
        st.sampled[slot] = temperature > 0

    def _deactivate(self, st: SlotState, slot: int) -> None:
        """Free ``slot``; its key keeps advancing with the batch."""
        st.seq_lens[slot] = 0
        st.tokens[slot] = 0
        st.active[slot] = False
        st.sampled[slot] = False

    def _step_noise(self, st: SlotState, num_steps: int):
        """Advance every slot's key ``num_steps`` times (one split per
        step) and return the gumbel noise of those steps [K, B, W] on the
        device, or None when no live slot samples."""
        keys, subs = st.keys, []
        for _ in range(num_steps):
            keys, sub = split_slot_keys(keys)
            subs.append(sub)
        st.keys = keys
        if not st.sampled.any():
            return None
        noise = prng.gumbel(np.stack(subs), (self.noise_w,))
        return torch.from_numpy(noise).to(self.device)

    def _sample_decode(self, st: SlotState, logits: torch.Tensor,
                       noise: torch.Tensor | None) -> torch.Tensor:
        """Sample every slot's next token from logits [B, V] with this
        step's ``noise`` [B, W], advance the slot state in place; returns
        the tokens [B] int32."""
        logits = apply_repeat_penalty(logits, st.recent, st.repeat_penalty)
        nxt = sample_with_noise(logits, st.temperature, st.top_p, noise,
                                top_k=st.top_k)
        nxt = torch.where(st.active, nxt, torch.zeros_like(nxt))
        # The sampled token's sequence position is seq_lens + 1 (the
        # pending token occupies seq_lens).
        bidx = torch.arange(st.recent.shape[0], device=self.device)
        cursor = ((st.seq_lens + 1) % REPEAT_LAST_N).long()
        st.recent[bidx, cursor] = torch.where(st.active, nxt,
                                              st.recent[bidx, cursor])
        st.seq_lens.copy_(torch.where(st.active, st.seq_lens + 1,
                                      st.seq_lens))
        st.tokens.copy_(nxt)
        return nxt

    # -------------------------------------------------------------- prefill

    def _recent_from_prompt(self, prompt_ids: list[int],
                            first_token: int | None = None,
                            plen: int | None = None) -> np.ndarray:
        """Last-N ring seeded from the prompt tail (+ the first sampled
        token at sequence position plen), padded with vocab_size (never
        penalized).  Token at position ``pos`` lives in slot ``pos % N``."""
        row = np.full((REPEAT_LAST_N,), self.cfg.vocab_size, np.int32)
        plen = len(prompt_ids) if plen is None else plen
        seq = {plen - len(prompt_ids) + i: t for i, t in enumerate(prompt_ids)}
        if first_token is not None:
            seq[plen] = first_token
        for pos in sorted(seq)[-REPEAT_LAST_N:]:
            row[pos % REPEAT_LAST_N] = seq[pos]
        return row

    def _sample_first(self, logits: torch.Tensor, prompt_ids: list[int],
                      temperature: float, top_p: float, key,
                      top_k: int, repeat_penalty: float) -> int:
        """Sample a prompt's first token from its last logits row [1, V]
        with ``key`` (None: greedy)."""
        dev = self.device
        logits = apply_repeat_penalty(
            logits,
            torch.as_tensor(self._recent_from_prompt(prompt_ids),
                            device=dev)[None],
            torch.tensor([repeat_penalty], dtype=torch.float32, device=dev))
        tok = sample_tokens(
            logits, torch.tensor([temperature], device=dev),
            torch.tensor([top_p], device=dev), key,
            top_k=torch.tensor([top_k], dtype=torch.int32, device=dev))
        return int(tok[0])

    def _padded(self, ids: list[int], width: int) -> torch.Tensor:
        tokens = np.zeros((1, width), np.int64)
        tokens[0, :len(ids)] = ids
        return torch.from_numpy(tokens).to(self.device)

    @torch.inference_mode()
    def prefill(self, prompt_ids: list[int], temperature: float,
                top_p: float, key=None, state=None, top_k: int = 0,
                repeat_penalty: float = 1.0):
        """Bucketed monolithic prefill; returns (first_token, ks, vs, plen)
        with ks/vs per rank [L, 1, Hkv/tp, bucket, Dh].  Padding positions
        clamp to plen-1 and ``kv_valid`` excludes them.  ``state`` is accepted (and
        ignored) so the scheduler passes its live state uniformly."""
        plen = len(prompt_ids)
        bucket = self.bucket_for(plen)
        ar = torch.arange(bucket, device=self.device, dtype=torch.int32)
        positions = torch.clamp(ar, max=plen - 1)[None]
        kv_valid = (ar < plen)[None]
        x = T._embed(self.params, self.cfg, self._padded(prompt_ids, bucket))
        x, ks, vs = T.scan_prefill_layers(
            T.layer_stacks(self.params), self.windows, self.cfg, x, positions,
            kv_valid=kv_valid, attention=self.prefill_attn, rope=self.ropes)
        logits = T._unembed(self.params, self.cfg, x[:, plen - 1])
        tok = self._sample_first(logits, prompt_ids, temperature, top_p,
                                 key, top_k, repeat_penalty)
        return tok, ks, vs, plen

    # ------------------------------------------------------ chunked prefill

    class PrefillJob:
        """Host handle for an in-progress chunked prefill: the prompt's KV
        so far in per-rank accumulators [L, 1, Hkv/tp, width, Dh]
        and the last logits row.  The scheduler runs one chunk per
        decode-loop iteration."""

        def __init__(self, prompt_ids, ctx_k, ctx_v):
            self.prompt_ids = prompt_ids
            self.done_tokens = 0
            self.ctx_k = ctx_k
            self.ctx_v = ctx_v
            self.last_logits = None

        @property
        def finished(self) -> bool:
            return self.done_tokens >= len(self.prompt_ids)

    def prefill_begin(self, prompt_ids: list[int],
                      state=None) -> "ModelRunner.PrefillJob":
        """Start a chunked admission; accumulators are sized to the
        prompt's bucket.  ``state`` is accepted (and ignored) here; the
        paged runner seeds the job from cached prefix pages with it."""
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds max context "
                f"{self.max_seq}")
        cfg = self.cfg
        shape = (cfg.num_layers, 1, cfg.num_kv_heads // self.tp,
                 self.bucket_for(len(prompt_ids)), cfg.resolved_head_dim())
        return self.PrefillJob(list(prompt_ids), *(
            [torch.zeros(shape, dtype=self.dtype, device=d)
             for d in self.devices] for _ in range(2)))

    def prefill_step(self, job: "ModelRunner.PrefillJob") -> bool:
        """Run ONE chunk of the job's prompt; True when the prompt is done."""
        width = job.ctx_k[0].shape[3]
        budget = width - job.done_tokens  # write room left in the buffers
        take = min(self.prefill_chunk, len(job.prompt_ids) - job.done_tokens)
        bucket = min(self.bucket_for(take), self.prefill_chunk)
        if bucket > budget:
            # A non-power-of-two max_seq tail: shrink to the largest bucket
            # that fits, or the exact remainder.
            fitting = [b for b in self.buckets if b <= budget]
            bucket = fitting[-1] if fitting else budget
            take = min(take, bucket)
        ids = job.prompt_ids[job.done_tokens:job.done_tokens + take]
        job.last_logits = self._prefill_chunk(
            self._padded(ids, bucket), take, job.done_tokens, job.ctx_k,
            job.ctx_v)
        job.done_tokens += take
        return job.finished

    @torch.inference_mode()
    def _prefill_chunk(self, tokens, chunk_len: int, ctx_len: int, ctx_k,
                       ctx_v) -> torch.Tensor:
        """One chunk over the accumulated context (plain
        ``prefill_attention_ctx``, per rank under tp); appends the chunk's
        KV to the accumulators in place and returns the last valid row's
        logits [V]."""
        t = tokens.shape[1]
        dev = self.device
        ar = torch.arange(t, device=dev, dtype=torch.int32)
        positions = (ctx_len + torch.clamp(ar, max=chunk_len - 1))[None]
        kv_valid = (ar < chunk_len)[None]
        width = ctx_k[0].shape[3]
        ctx_valid = (torch.arange(width, device=dev) < ctx_len)[None]
        x = T._embed(self.params, self.cfg, tokens)
        x, ks, vs = T.scan_prefill_layers(
            T.layer_stacks(self.params), self.windows, self.cfg, x, positions,
            kv_valid=kv_valid, ctx_k=ctx_k, ctx_v=ctx_v, ctx_valid=ctx_valid,
            rope=self.ropes)
        # Padding rows past chunk_len land beyond the valid region: the
        # next chunk overwrites them or seq_lens masks them.
        for acc, new in ((ctx_k, ks), (ctx_v, vs)):
            for a, n in zip(acc, new):
                a[:, :, :, ctx_len:ctx_len + t] = n.to(a.dtype)
        return T._unembed(self.params, self.cfg, x[0, chunk_len - 1])

    @torch.inference_mode()
    def prefill_finish(self, job: "ModelRunner.PrefillJob",
                       temperature: float, top_p: float, key=None,
                       top_k: int = 0, repeat_penalty: float = 1.0):
        """Sample the first token; returns (tok, ks, vs, plen) like
        :meth:`prefill`."""
        if not job.finished or job.last_logits is None:
            raise RuntimeError("prefill_finish before the prompt is prefilled")
        tok = self._sample_first(job.last_logits[None], job.prompt_ids,
                                 temperature, top_p, key, top_k,
                                 repeat_penalty)
        return tok, job.ctx_k, job.ctx_v, len(job.prompt_ids)

    # ------------------------------------------------------------ embeddings

    def embed_prompt(self, prompt_ids: list[int]) -> np.ndarray:
        """Mean-pooled, L2-normalized embedding of one prompt ([D] fp32)."""
        return self.embed_prompts([prompt_ids])[0]

    def embed_prompts(self, prompts: list[list[int]]) -> np.ndarray:
        """Embeddings for many prompts ([N, D] fp32): same-bucket prompts
        share one forward, padded to 1/2/4/8 rows; padding is excluded
        from attention and from the pooling mask."""
        out = np.zeros((len(prompts), self.cfg.hidden_size), np.float32)
        groups: dict[int, list[int]] = {}
        for i, ids in enumerate(prompts):
            groups.setdefault(self.bucket_for(len(ids)), []).append(i)
        top = self._EMBED_BATCH[-1]
        for bucket, idxs in groups.items():
            for pos in range(0, len(idxs), top):
                chunk = idxs[pos:pos + top]
                bs = next(b for b in self._EMBED_BATCH if b >= len(chunk))
                tokens = np.zeros((bs, bucket), np.int64)
                plens = np.ones((bs,), np.int32)
                for row, i in enumerate(chunk):
                    tokens[row, :len(prompts[i])] = prompts[i]
                    plens[row] = len(prompts[i])
                vecs = self._embed_fwd(torch.from_numpy(tokens).to(self.device),
                                       torch.from_numpy(plens).to(self.device))
                vecs = vecs.cpu().numpy()
                for row, i in enumerate(chunk):
                    out[i] = vecs[row]
        return out

    @torch.inference_mode()
    def _embed_fwd(self, tokens: torch.Tensor,
                   plens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        ar = torch.arange(t, device=self.device, dtype=torch.int32)[None]
        positions = torch.minimum(ar, plens[:, None] - 1).contiguous()
        kv_valid = (ar < plens[:, None]).contiguous()
        h = T.hidden_states(self.params, self.cfg, tokens, positions,
                            kv_valid=kv_valid, attention=self.prefill_attn,
                            rope=self.ropes)
        mask = kv_valid[..., None].float()
        pooled = (h.float() * mask).sum(1) / mask.sum(1).clamp_min(1.0)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)

    # ------------------------------------------------ contiguous KV layout

    def _kv_zeros(self, shape: tuple[int, ...], device=None):
        """Zeroed K and V buffers of ``shape`` in the KV dtype on ``device``
        (default: the runner's), and the zeroed bf16 scales ``shape[:-1]``
        an int8 cache carries as ``k_scale``/``v_scale`` keywords ({} for
        bf16)."""
        device = device or self.device
        quantized = self.kv_dtype == "int8"
        kw = dict(dtype=torch.int8 if quantized else self.dtype,
                  device=device)
        scales = {}
        if quantized:
            scales = {name: torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                        device=device)
                      for name in ("k_scale", "v_scale")}
        return torch.zeros(shape, **kw), torch.zeros(shape, **kw), scales

    @torch.inference_mode()
    def init_state(self) -> DecodeState:
        cfg = self.cfg
        k, v, scales = self._kv_zeros(
            (cfg.num_layers, self.max_slots, cfg.num_kv_heads, self.max_seq,
             cfg.resolved_head_dim()))
        return DecodeState(k_cache=k, v_cache=v, **scales,
                           **self._slot_fields())

    @torch.inference_mode()
    def insert(self, state: DecodeState, slot: int, ks, vs, plen: int,
               first_token: int, temperature: float, top_p: float,
               prompt_tokens: list[int] | None = None, slot_key=None,
               top_k: int = 0, repeat_penalty: float = 1.0) -> DecodeState:
        """Write a prefilled sequence (ks/vs: one rank's [L, 1, Hkv, T, Dh],
        quantized first on an int8 cache) into ``slot``; ``slot_key`` seeds the slot's
        sampling stream (default: ``default_slot_key(slot)``)."""
        (ks,), (vs,) = ks, vs
        t = ks.shape[3]
        if self.kv_dtype == "int8":
            ks, k_sc = quantize_kv(ks, state.k_scale.dtype)
            vs, v_sc = quantize_kv(vs, state.v_scale.dtype)
            state.k_scale[:, slot, :, :t] = k_sc[:, 0]
            state.v_scale[:, slot, :, :t] = v_sc[:, 0]
        state.k_cache[:, slot, :, :t] = ks[:, 0].to(state.k_cache.dtype)
        state.v_cache[:, slot, :, :t] = vs[:, 0].to(state.v_cache.dtype)
        recent_row = self._recent_from_prompt(
            list(prompt_tokens or []), first_token, plen=plen)
        self._activate(state, slot, plen, first_token, temperature, top_p,
                       top_k, repeat_penalty, recent_row, slot_key)
        return state

    @torch.inference_mode()
    def release(self, state: DecodeState, slot: int) -> DecodeState:
        self._deactivate(state, slot)
        return state

    def pre_decode_check(self, steps: int) -> list[int]:
        """The contiguous cache never runs out of room: no slot starves."""
        return []

    def decode_logits(self, st: DecodeState) -> torch.Tensor:
        """One decode step's forward for every slot: writes each token's KV
        into the cache and returns logits [B, V] fp32 (no sampling)."""
        positions = torch.clamp(st.seq_lens, max=self.max_seq - 1)
        lens = torch.clamp(st.seq_lens + 1, max=self.max_seq)
        out = T.decode_step(self.params, self.cfg, st.tokens, positions,
                            st.k_cache, st.v_cache, lens,
                            rope=self.ropes,
                            attention=self.decode_attn, k_scale=st.k_scale,
                            v_scale=st.v_scale)
        return out[0]

    @torch.inference_mode()
    def decode_steps_device(self, state: DecodeState, num_steps: int = 1):
        """``num_steps`` decode steps; returns (tokens [K, B] int32 on the
        device, state)."""
        noise = self._step_noise(state, num_steps)
        out = []
        for i in range(num_steps):
            out.append(self._sample_decode(
                state, self.decode_logits(state),
                None if noise is None else noise[i]))
        return torch.stack(out), state

    def decode_steps(self, state, num_steps: int = 1):
        """Run ``num_steps`` decode steps; returns (tokens [K, B] numpy,
        state)."""
        tokens, state = self.decode_steps_device(state, num_steps)
        return tokens.cpu().numpy(), state
