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
layout and reuses the rest; speculation subclasses both layouts
(``engine/spec.py``).

The mesh (``mesh_shape``, the ranks on ``devices``), as JAX's runner
serves it, single-controller: one process drives every rank, and a rank
may sit on any device, every rank on one card included.  Every rank holds
its parameters (``parallel/sharding.py``); ``groups`` bundles them by
(dp, pp, sp) coordinate into the tp lists the model's forward functions
take, and ``params`` is the group of (0, 0, 0).  The contiguous cache is
one tensor on one device, else one shard a (dp, pp, sp, tp) rank
``[L/pp, B/dp, Hkv/tp, S/sp, Dh]`` on the rank's device, in that
row-major order (ep ranks hold no cache: attention is replicated over
ep, and the port runs it once):

- tp: prefill runs kernel A and decode kernel D per tp rank, on the
  rank's heads; the row-parallel products sum over the ranks;
- dp: slot ``b`` lives on dp rank ``b // (B/dp)`` (``max_slots`` rounds
  down to a multiple of dp); each decode step runs every dp rank's slots
  on its own parameters and cache (kernel D per rank), and the logits
  join on rank 0's device, where sampling runs; prefill runs on dp rank
  0 and ``insert`` writes the slot's dp rank's cache;
- sp: prefill runs each sp rank's shard of the sequence on its own
  parameters with ring attention between them (``ops/ring.py``), and
  ``insert`` scatters the prompt's KV to the shards that own its
  positions; decode writes each token into the shard that owns its
  position and attends through ``sp_decode_attention`` (no A or D
  launch in attention, as JAX reaches no Pallas kernel there); prefill
  buckets are multiples of sp and ``max_seq`` must divide by sp;
- pp: the stages hold ``L/pp`` layers each; prefill, decode and the
  embeddings forward run the GPipe microbatch schedule
  (``parallel/pipeline.py``): kernel A per stage and tp rank, kernel D
  per stage, microbatch and tp rank; pp x sp is refused, as in JAX;
- ep: a MoE layer runs each ep rank's expert bank over the rows routed
  to its experts (kernel G) and combines them in the one-device order.

Legacy chunked admission is off (``prefill_chunk = 0``) on pp and sp
meshes, and the int8 KV cache serves only without sp and pp, as in the
JAX runner.

A mesh across processes (``parallel/multihost.py``; each process holds
the ranks ``[p*L, (p+1)*L)``) serves when each process holds whole dp
ranks (dp across processes) or, without sp, pp and ep, a share of one tp
group (tp across processes); an sp, pp or ep group that would cross
processes is refused (ROADMAP Queue 1 item 8.2b).  The runner then holds
and runs only its process's ranks: ``groups``, the state's cache shards,
``devices`` and ``tp_devices`` are this process's; prefill runs on the
process's first dp rank (every process prefills each prompt, so no
prompt KV crosses processes); decode runs the slots of the local dp
ranks (``slot_rows``) and returns their tokens, which the leader-
replicated dispatch gathers (``parallel/replicated.py``); a tp group's
sums complete over its processes (``parallel/sharding.py TPGroup``).
Every process drives the same calls in the same order, with the same
host inputs, so the replicated slot state stays the same everywhere.

Megastep (``decode_megastep``, both layouts): K decode steps per host
dispatch with on-device sampling and done-flags (``ops/megastep.py``).
On the CPU the harness runs eagerly; on CUDA each flight replays a CUDA
graph captured once per shape (``engine/graphs.py``).  Once a graph
exists, ``init_state`` zeroes the captured state in place instead of
allocating a new one, so the graph's addresses stay the state's.

Sampling keys: each slot carries a threefry key ``[2]`` uint32 in the
state (host numpy, ``engine/prng.py``); every decode step splits every
slot's key, live or not, and samples with the sub-key, as the JAX decode
step does, so a seeded request draws the same tokens on both packages.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device, construction raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from dataclasses import dataclass

import numpy as np
import torch

from crowdllama_tpu_torch.engine import prng
from crowdllama_tpu_torch.engine.graphs import GraphCache
from crowdllama_tpu_torch.engine.plan import ACROSS_PROCESSES, check_megastep
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
from crowdllama_tpu_torch.ops.megastep import NO_BUDGET, run_decode_megastep
from crowdllama_tpu_torch.ops.quant import MODES as QUANT_MODES
from crowdllama_tpu_torch.ops.quant import quantize_kv, quantize_params
from crowdllama_tpu_torch.parallel import multihost
from crowdllama_tpu_torch.parallel.mesh import (
    AXIS_TP,
    Mesh,
    build_mesh,
    choose_mesh_shape,
)
from crowdllama_tpu_torch.parallel.pipeline import (
    pp_decode_step,
    pp_forward,
    pp_hidden_states,
)
from crowdllama_tpu_torch.parallel.sharding import rank_groups, shard_params

log = logging.getLogger("crowdllama.torch.engine.runner")

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
    # Speculative runners (engine/spec.py): the n-gram proposer's token
    # history [B, S] int32, and the draft model's contiguous cache
    # [Ld, B, Hkv_d, S, Dh_d]; None on every other runner.
    hist: torch.Tensor | None = None
    draft_k: torch.Tensor | None = None
    draft_v: torch.Tensor | None = None


@dataclass(kw_only=True)
class DecodeState(SlotState):
    """Contiguous-layout decode state."""

    # [L, B, Hkv, S, Dh] head-major (int8 with kv_dtype="int8"); on a
    # mesh one shard a (dp, pp, sp, tp) rank, [L/pp, B/dp, Hkv/tp, S/sp, Dh]
    k_cache: torch.Tensor | list[torch.Tensor]
    v_cache: torch.Tensor | list[torch.Tensor]
    # [L, B, Hkv, S] bf16 (per rank on a mesh), int8 only
    k_scale: torch.Tensor | list[torch.Tensor] | None = None
    v_scale: torch.Tensor | list[torch.Tensor] | None = None


class ModelRunner:
    """The contiguous-layout runner, and the base of the paged one."""

    #: the scheduler admits prompts longer than this chunk by chunk
    #: (legacy chunked admission); 0 disables
    prefill_chunk = 512
    #: the contiguous layout has no unified ragged step
    supports_ragged = False
    #: the scheduler may run full decode chunks as megasteps
    supports_megastep = True
    kv_layout = "contiguous"
    #: captured megastep graphs (``engine/graphs.py``): made on the first
    #: CUDA megastep; None on the CPU, where the harness runs eagerly
    _graphs: GraphCache | None = None
    _EMBED_BATCH = (1, 2, 4, 8)  # padded batch sizes of the embed forward

    def __init__(self, cfg: ModelConfig, params: dict | None = None,
                 max_slots: int = 8, max_seq: int = 0,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: torch.device | str | None = None,
                 kv_dtype: str = "bf16", mesh_shape: str = "",
                 devices: list | None = None, quantize: str = ""):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
        if quantize not in ("", *QUANT_MODES):
            raise ValueError(f"unknown quantization mode {quantize!r}")
        self.kv_dtype = kv_dtype
        self.cfg = cfg
        self.mesh = self._build_mesh(mesh_shape, device, devices)
        self.dp, self.pp, self.sp, self.ep, self.tp = self.mesh.shape
        #: every rank's device (this process's ranks), in rank order, the
        #: first rank's first; the slot state, sampling and the logits
        #: live on the first rank's
        self.devices = list(self.mesh.devices)
        self.device = self.devices[0]
        self.max_slots = max_slots
        self.max_seq = max_seq or cfg.max_context_length
        self._check_mesh()
        self._place_processes()
        #: the devices of the tp ranks (this process's) of the first local
        #: dp rank at (pp, sp, ep) = 0: where prefill's KV and a paged
        #: runner's pools live
        self.tp_devices = [self.mesh.device(dp=self.local_dp[0], tp=t)
                           for t in self.local_tp]
        # On a mesh the full weights are made (or quantized) on the host,
        # so no card ever holds more than its ranks' slices.
        one = self.mesh.size == 1
        home = self.device if one else "cpu"
        if params is None:
            # Quantized weights are born quantized: the full-precision
            # tree never exists.
            params = init_params(cfg, seed, dtype=dtype, device=home,
                                 quantize=quantize)
        elif quantize:
            # Given weights are quantized on the card on one device, else
            # where they are (the ranks then copy their slices).
            params = quantize_params(params, mode=quantize, device=(
                self.device if one else None))
        #: the (dp, pp, sp) groups' tp lists of per-rank parameter dicts;
        #: the full dict is not kept
        comm = None
        if self.mesh.n_processes > 1:
            comm = multihost.axis_comm(
                self.mesh, [self.mesh.ranks_along(AXIS_TP, dp=d)
                            for d in range(self.dp)], self.devices)
        #: the cross-process half of the tp collectives (None unless a tp
        #: group spans processes)
        self.tp_comm = comm
        #: the (dp, pp, sp) groups' tp lists of per-rank parameter dicts
        #: (this process's); the full dict is not kept
        self.groups = rank_groups(shard_params(params, cfg, self.mesh),
                                  self.mesh, comm)
        del params
        #: the group of (first local dp, 0, 0): the whole model unless pp
        self.params = self.groups[(self.local_dp[0], 0, 0)]
        self.dtype = self.params[0]["embed"].dtype
        self.buckets = [b for b in prefill_buckets(self.max_seq)
                        if b % self.sp == 0]
        self.windows = T.layer_sliding_windows(cfg)
        self.scale = T.attn_scale(cfg)
        self._rope_tables: dict = {}  # device -> (cos, sin), shared
        #: the (cos, sin) rope tables of ``params``' ranks
        self.ropes = self._group_ropes(self.params)
        self.noise_w = noise_width(cfg.vocab_size)
        #: no-context prefill attention (kernel A) and contiguous decode
        #: attention (kernel D); seams that let a caller run the same step
        #: through the plain versions
        self.prefill_attn = prefill_attention
        self.decode_attn = decode_attention

    def _build_mesh(self, mesh_shape: str, device,
                    devices: list | None) -> Mesh:
        """The runner's mesh: one device (``device``, else CUDA) unless a
        mesh spec or a device list is given.  Across processes the
        default is JAX's: as much tp as the kv heads allow over every
        process's devices, the rest dp (or ep)."""
        n = multihost.process_count()
        if not mesh_shape and devices is None and n == 1:
            return Mesh.single(resolve_device(device))
        if device is not None:
            raise ValueError("pass device= or a mesh (mesh_shape=/devices=), "
                             "not both")
        if not mesh_shape and n > 1:
            local = len(devices) if devices is not None else len(
                build_mesh("", None, (1, 0)).devices)
            mesh_shape = "x".join(str(a) for a in choose_mesh_shape(
                local * n, self.cfg.num_kv_heads, self.cfg.num_experts))
        return build_mesh(mesh_shape, devices)

    def _check_mesh(self) -> None:
        """JAX's runner's mesh rules: max_slots rounds down to a multiple
        of dp; sp needs max_seq % sp == 0; pp needs L % pp == 0 and no sp;
        int8 KV serves without sp and pp; chunked admission is off on pp
        and sp."""
        dp, pp, sp = self.dp, self.pp, self.sp
        if self.max_slots % dp:
            self.max_slots = max(dp, (self.max_slots // dp) * dp)
            log.warning("max_slots rounded to %d (dp=%d)", self.max_slots, dp)
        if sp > 1 and self.max_seq % sp:
            raise ValueError(f"max_seq {self.max_seq} must divide by sp={sp}")
        if pp > 1 and sp > 1:
            raise ValueError("pp x sp composition not supported yet")
        if self.cfg.num_layers % pp:
            raise ValueError(f"{self.cfg.num_layers} layers not divisible by "
                             f"pp={pp}")
        if self.kv_dtype == "int8" and (sp > 1 or pp > 1):
            raise ValueError(
                "int8 KV cache does not compose with sp/pp meshes yet")
        if pp > 1 or sp > 1:
            # Chunked admission runs the plain layer scan; pp needs the
            # pipeline and sp the ring: monolithic prefill only.
            self.prefill_chunk = 0

    def _place_processes(self) -> None:
        """This process's share of the mesh: ``local_dp`` (its dp ranks),
        ``local_tp`` (its tp ranks of them) and ``slot_rows`` (the slots
        its decode runs), as :meth:`_process_share` places them."""
        self.local_dp, self.local_tp = self._process_share(
            self.mesh.process_index)
        self.slot_rows = self.process_slot_rows(self.mesh.process_index)

    def _process_share(self, p: int) -> tuple[list[int], list[int]]:
        """(dp ranks, tp ranks of them) of process ``p``.  One process
        holds everything.  Across processes a process holds whole dp
        ranks, or a share of one tp group when sp, pp and ep are 1; any
        other split would put an sp, pp or ep group (or a tp group
        unevenly) across processes, which is refused."""
        m = self.mesh
        block = self.pp * self.sp * self.ep * self.tp  # ranks a dp rank
        size = m.local_size
        first = p * size
        if size % block == 0:
            return (list(range(first // block, (first + size) // block)),
                    list(range(self.tp)))
        if self.pp == self.sp == self.ep == 1 and self.tp % size == 0:
            return ([first // self.tp],
                    list(range(first % self.tp, first % self.tp + size)))
        raise ValueError(
            f"mesh {m.axes} over {m.n_processes} processes of {size} "
            f"ranks each puts an sp, pp or ep group (or a tp group "
            f"unevenly) across processes, which is not ported to "
            f"crowdllama_tpu_torch yet: {ACROSS_PROCESSES}")

    def process_slot_rows(self, p: int) -> slice:
        """The slots process ``p``'s decode runs (its dp ranks')."""
        per = self.max_slots // self.dp
        dps = self._process_share(p)[0]
        return slice(dps[0] * per, (dps[-1] + 1) * per)

    # --------------------------------------------------------- mesh groups

    def _rope_on(self, device: torch.device):
        if device not in self._rope_tables:
            self._rope_tables[device] = T.rope_for(self.cfg, device)
        return self._rope_tables[device]

    def _group_ropes(self, group: list) -> list:
        """(cos, sin) for each tp rank of ``group``, on its device."""
        return [self._rope_on(p["final_norm"].device) for p in group]

    def _stages(self, d: int) -> list:
        """dp rank ``d``'s pipeline stages (their tp lists)."""
        return [self.groups[(d, p, 0)] for p in range(self.pp)]

    def _sp_groups(self, d: int) -> list:
        """dp rank ``d``'s sp ranks (their tp lists)."""
        return [self.groups[(d, 0, s)] for s in range(self.sp)]

    def _cache_index(self, d: int, p: int, s: int, t: int) -> int:
        """The (dp, pp, sp, tp) rank's index in a mesh state's cache
        lists (this process's ranks, in rank order)."""
        d -= self.local_dp[0]
        t -= self.local_tp[0]
        return ((d * self.pp + p) * self.sp + s) * len(self.local_tp) + t

    def _group_device(self, d: int) -> torch.device:
        """The device of dp rank ``d``'s first local rank."""
        return self.groups[(d, 0, 0)][0]["final_norm"].device

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
        """Sample the next token of every slot of ``slot_rows`` (every
        slot unless dp spans processes) from their logits [b, V] with this
        step's ``noise`` [B, W], advance their slot state in place;
        returns the tokens [b] int32."""
        r = self.slot_rows
        active, seq, recent = st.active[r], st.seq_lens[r], st.recent[r]
        logits = apply_repeat_penalty(logits, recent, st.repeat_penalty[r])
        nxt = sample_with_noise(logits, st.temperature[r], st.top_p[r],
                                None if noise is None else noise[r],
                                top_k=st.top_k[r])
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        # The sampled token's sequence position is seq_lens + 1 (the
        # pending token occupies seq_lens).
        bidx = torch.arange(recent.shape[0], device=self.device)
        cursor = ((seq + 1) % REPEAT_LAST_N).long()
        recent[bidx, cursor] = torch.where(active, nxt, recent[bidx, cursor])
        seq.copy_(torch.where(active, seq + 1, seq))
        st.tokens[r].copy_(nxt)
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
        with ks/vs one a (pp stage, tp rank), in that order,
        [L/pp, 1, Hkv/tp, bucket, Dh] (under sp the shards' KV joined on
        the tp rank's device).  Padding positions clamp to plen-1 and
        ``kv_valid`` excludes them.  Runs on dp rank 0.  ``state`` is
        accepted (and ignored) so the scheduler passes its live state
        uniformly."""
        cfg = self.cfg
        plen = len(prompt_ids)
        bucket = self.bucket_for(plen)
        ar = torch.arange(bucket, device=self.device, dtype=torch.int32)
        positions = torch.clamp(ar, max=plen - 1)[None]
        kv_valid = (ar < plen)[None]
        tokens = self._padded(prompt_ids, bucket)
        if self.pp > 1:
            stages = self._stages(0)
            x, ks, vs = pp_forward(
                stages, cfg, tokens, positions, kv_valid,
                ropes=[self._group_ropes(g) for g in stages],
                attention=self.prefill_attn)
            ks = [k for stage in ks for k in stage]
            vs = [v for stage in vs for v in stage]
            logits = T._unembed(stages[-1], cfg, x[:, plen - 1])
        elif self.sp > 1:
            groups = self._sp_groups(0)
            xs = [T._embed(g, cfg, tk)
                  for g, tk in zip(groups, T.sp_split(tokens, groups))]
            xs, kss, vss = T.scan_prefill_layers(
                T.layer_stacks_sp(groups), self.windows, cfg, xs,
                T.sp_split(positions, groups),
                kv_valid=T.sp_split(kv_valid, groups),
                rope=[self._group_ropes(g) for g in groups], sp=True)
            shard, off = divmod(plen - 1, bucket // self.sp)
            logits = T._unembed(groups[shard], cfg, xs[shard][:, off])
            ks, vs = ([torch.cat([part[s][t].to(d) for s in range(self.sp)],
                                 dim=3)
                       for t, d in enumerate(self.tp_devices)]
                      for part in (kss, vss))
        else:
            x = T._embed(self.params, cfg, tokens)
            x, ks, vs = T.scan_prefill_layers(
                T.layer_stacks(self.params), self.windows, cfg, x,
                positions, kv_valid=kv_valid, attention=self.prefill_attn,
                rope=self.ropes)
            logits = T._unembed(self.params, cfg, x[:, plen - 1])
        tok = self._sample_first(logits.to(self.device), prompt_ids,
                                 temperature, top_p, key, top_k,
                                 repeat_penalty)
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
        """Start a chunked admission; accumulators (one a local tp rank)
        are sized to the prompt's bucket.  ``state`` is accepted (and ignored) here; the
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
             for d in self.tp_devices] for _ in range(2)))

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
        if self.pp > 1:  # the microbatch pipeline, as prefill
            stages = self._stages(0)
            h = pp_hidden_states(
                stages, self.cfg, tokens, positions, kv_valid,
                ropes=[self._group_ropes(g) for g in stages],
                attention=self.prefill_attn).to(self.device)
        elif self.sp > 1:  # the ring, as prefill
            groups = self._sp_groups(0)
            h = T.hidden_states(
                groups, self.cfg, tokens, positions, kv_valid=kv_valid,
                rope=[self._group_ropes(g) for g in groups],
                sp=True).to(self.device)
        else:
            h = T.hidden_states(self.params, self.cfg, tokens, positions,
                                kv_valid=kv_valid,
                                attention=self.prefill_attn, rope=self.ropes)
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
    def _kept_state(self) -> SlotState | None:
        """The state the megastep graphs were captured on, reset in place
        to what a fresh ``init_state`` makes (zeroed KV, every slot free):
        its tensors keep the addresses the graphs hold.  None before any
        capture."""
        st = None if self._graphs is None else self._graphs.state
        if st is None:
            return None
        fresh = self._slot_fields()
        for f in dataclasses.fields(st):
            cur = getattr(st, f.name)
            if isinstance(cur, torch.Tensor):
                if f.name in fresh:
                    cur.copy_(fresh[f.name])
                else:
                    cur.zero_()
            elif isinstance(cur, list):
                for t in cur:
                    t.zero_()
        st.keys, st.sampled = fresh["keys"], fresh["sampled"]
        return st

    @torch.inference_mode()
    def init_state(self) -> DecodeState:
        kept = self._kept_state()
        if kept is not None:
            return kept
        cfg = self.cfg
        if self.mesh.size == 1:
            k, v, scales = self._kv_zeros(
                (cfg.num_layers, self.max_slots, cfg.num_kv_heads,
                 self.max_seq, cfg.resolved_head_dim()))
            return DecodeState(k_cache=k, v_cache=v, **scales,
                               **self._slot_fields())
        shape = (cfg.num_layers // self.pp, self.max_slots // self.dp,
                 cfg.num_kv_heads // self.tp, self.max_seq // self.sp,
                 cfg.resolved_head_dim())
        ks, vs, scales = [], [], {}
        for d, p, s, t in itertools.product(self.local_dp, range(self.pp),
                                            range(self.sp), self.local_tp):
            k, v, sc = self._kv_zeros(shape, self.mesh.device(
                dp=d, pp=p, sp=s, tp=t))
            ks.append(k)
            vs.append(v)
            for name, x in sc.items():
                scales.setdefault(name, []).append(x)
        return DecodeState(k_cache=ks, v_cache=vs, **scales,
                           **self._slot_fields())

    @staticmethod
    def _ranks(x) -> list:
        """A state's cache field as its list of rank shards."""
        return x if isinstance(x, list) else [x]

    @torch.inference_mode()
    def insert(self, state: DecodeState, slot: int, ks, vs, plen: int,
               first_token: int, temperature: float, top_p: float,
               prompt_tokens: list[int] | None = None, slot_key=None,
               top_k: int = 0, repeat_penalty: float = 1.0) -> DecodeState:
        """Write a prefilled sequence (ks/vs as :meth:`prefill` returns
        them, quantized first on an int8 cache) into ``slot``: its dp
        rank's cache (when this process holds it), each sp shard taking
        the positions it owns;
        ``slot_key`` seeds the slot's sampling stream (default:
        ``default_slot_key(slot)``)."""
        t_len = ks[0].shape[3]
        d, local = divmod(slot, self.max_slots // self.dp)
        shard = self.max_seq // self.sp
        kcs, vcs = self._ranks(state.k_cache), self._ranks(state.v_cache)
        quantized = self.kv_dtype == "int8"
        if quantized:
            kss, vss = self._ranks(state.k_scale), self._ranks(state.v_scale)
        n_tp = len(self.local_tp)
        if d not in self.local_dp:
            pairs = []  # the slot's dp rank lives in another process
        else:
            pairs = itertools.product(range(self.pp), range(n_tp))
        for p, j in pairs:
            t = self.local_tp[j]
            k, v = ks[p * n_tp + j], vs[p * n_tp + j]
            if quantized:
                k, k_sc = quantize_kv(k, kss[0].dtype)
                v, v_sc = quantize_kv(v, vss[0].dtype)
            for s in range(self.sp):
                lo = s * shard
                n = min(shard, t_len - lo)
                if n <= 0:
                    break
                i = self._cache_index(d, p, s, t)
                kc, vc = kcs[i], vcs[i]
                kc[:, local, :, :n] = k[:, 0, :, lo:lo + n].to(kc.device,
                                                               kc.dtype)
                vc[:, local, :, :n] = v[:, 0, :, lo:lo + n].to(vc.device,
                                                               vc.dtype)
                if quantized:
                    kss[i][:, local, :, :n] = k_sc[:, 0, :, lo:lo + n].to(
                        kc.device)
                    vss[i][:, local, :, :n] = v_sc[:, 0, :, lo:lo + n].to(
                        kc.device)
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
        """One decode step's forward for every slot of ``slot_rows``:
        writes each token's KV into the cache and returns their logits
        [b, V] fp32 on the first rank's device (no sampling).  Each dp rank runs its slots on its own parameters
        and cache: through its pipeline stages under pp, over the
        sequence shards under sp."""
        positions = torch.clamp(st.seq_lens, max=self.max_seq - 1)
        lens = torch.clamp(st.seq_lens + 1, max=self.max_seq)
        kcs, vcs = self._ranks(st.k_cache), self._ranks(st.v_cache)
        quantized = st.k_scale is not None
        kss = self._ranks(st.k_scale) if quantized else None
        vss = self._ranks(st.v_scale) if quantized else None
        per = self.max_slots // self.dp
        tps = self.local_tp
        outs = []
        for d in self.local_dp:
            sl = slice(d * per, (d + 1) * per)
            dev = self._group_device(d)
            tok, pos, ln = (x[sl].to(dev) for x in (st.tokens, positions,
                                                    lens))
            if self.pp > 1:
                stages = self._stages(d)
                idx = [[self._cache_index(d, p, 0, t) for t in tps]
                       for p in range(self.pp)]
                logits = pp_decode_step(
                    stages, self.cfg, tok.long(), pos,
                    [[kcs[i] for i in row] for row in idx],
                    [[vcs[i] for i in row] for row in idx], ln,
                    ropes=[self._group_ropes(g) for g in stages],
                    attention=self.decode_attn)
            else:
                group = self.groups[(d, 0, 0)]
                if self.sp > 1:
                    idx = [[self._cache_index(d, 0, s, t)
                            for s in range(self.sp)] for t in tps]
                    kc = [[kcs[i] for i in row] for row in idx]
                    vc = [[vcs[i] for i in row] for row in idx]
                else:
                    idx = [self._cache_index(d, 0, 0, t) for t in tps]
                    kc, vc = [kcs[i] for i in idx], [vcs[i] for i in idx]
                x = T._embed(group, self.cfg, tok.long())
                x = T.scan_decode_layers(
                    T.layer_stacks(group), self.windows, self.cfg, x, pos,
                    kc, vc, ln, self._group_ropes(group),
                    attention=self.decode_attn,
                    k_scale=[kss[i] for i in idx] if quantized else None,
                    v_scale=[vss[i] for i in idx] if quantized else None,
                    sp=self.sp > 1)
                logits = T._unembed(group, self.cfg, x)
            outs.append(logits.to(self.device))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

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

    # ------------------------------------------------------------ megastep

    def _mega_limits_dev(self, eos_ids, budgets):
        """Device-resident eos/budget vectors [B] int32; the no-limit
        defaults are made once."""
        if eos_ids is None:
            if getattr(self, "_mega_no_eos", None) is None:
                self._mega_no_eos = torch.full((self.max_slots,), -1,
                                               dtype=torch.int32,
                                               device=self.device)
            eos_ids = self._mega_no_eos
        else:
            eos_ids = torch.as_tensor(np.asarray(eos_ids, np.int32)).to(
                self.device)
        if budgets is None:
            if getattr(self, "_mega_no_budget", None) is None:
                self._mega_no_budget = torch.full(
                    (self.max_slots,), NO_BUDGET, dtype=torch.int32,
                    device=self.device)
            budgets = self._mega_no_budget
        else:
            budgets = torch.as_tensor(np.asarray(budgets, np.int32)).to(
                self.device)
        return eos_ids, budgets

    def _graph_cache(self) -> GraphCache | None:
        """The megastep graphs: made on the first CUDA megastep; None on
        the CPU unless a caller set one."""
        if self._graphs is None and self.device.type == "cuda":
            self._graphs = GraphCache()
        return self._graphs

    def _step_logits(self, st, table) -> torch.Tensor:
        """One decode step's logits [B, V] (``table``: the paged runner's
        page table; unused here)."""
        return self.decode_logits(st)

    def _mega_prepare(self, num_steps: int) -> dict:
        """Dispatch-time host bookkeeping before a megastep; returns the
        flight's layout inputs (the paged runner's page table)."""
        return {}

    def _mega_advance(self, num_steps: int) -> None:
        """Dispatch-time host bookkeeping after a megastep."""

    @torch.inference_mode()
    def decode_megastep(self, state, num_steps: int, eos_ids=None,
                        budgets=None):
        """K = ``num_steps`` full decode steps per host dispatch with
        on-device sampling and per-slot done-flags (``ops/megastep.py``).
        Returns ``(tokens [K, B] int32, done [K, B] bool, state)`` on the
        device, so the host pays one read per flight.  ``eos_ids`` [B]
        (-1 disables) and ``budgets`` [B] (tokens the host still wants)
        drive the flags; the defaults disable both, which makes it
        :meth:`decode_steps_device` plus all-false flags.  Host bookkeeping
        assumes the full K.  On CUDA the flight is one replay of the
        graph for (layout, kv dtype, mesh shape, K, sampled); on the CPU
        the harness runs eagerly."""
        check_megastep(num_steps, self.devices)
        eos_ids, budgets = self._mega_limits_dev(eos_ids, budgets)
        values = {"eos_ids": eos_ids, "budgets": budgets,
                  **self._mega_prepare(num_steps)}
        noise = self._step_noise(state, num_steps)
        if noise is not None:
            values["noise"] = noise

        def body(inputs):
            table, noise = inputs.get("table"), inputs.get("noise")

            def step(i):
                return self._sample_decode(
                    state, self._step_logits(state, table),
                    None if noise is None else noise[i])

            return run_decode_megastep(step, state, inputs["eos_ids"],
                                       inputs["budgets"], num_steps)

        graphs = self._graph_cache()
        if graphs is None:
            tokens, done = body(values)
        else:
            key = (self.kv_layout, self.kv_dtype, self.mesh.shape,
                   num_steps, noise is not None)
            graph = graphs.graph(
                key, state,
                lambda: {k: torch.zeros(v.shape, dtype=v.dtype,
                                        device=self.device)
                         for k, v in values.items()}, body)
            tokens, done = graph.replay(state, **values)
        self._mega_advance(num_steps)
        return tokens, done, state
