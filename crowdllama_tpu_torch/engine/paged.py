"""Block-paged KV cache: slot -> page-table indirection over a shared pool.

Counterpart of ``crowdllama_tpu/engine/paged.py`` ``PagedModelRunner``, on
one device or tensor-parallel over a tp mesh:

- pool ``[L, P + 1, Hkv, page, Dh]`` (k and v); page id ``P`` is the
  reserved dump page that absorbs the writes of inactive slots and of chunk
  rows past the prompt, so no real page is ever clobbered;
- ``kv_dtype="int8"``: int8 pools with per-(position, kv head) bf16 scales
  ``[L, P + 1, Hkv, page]``; KV is quantized where it enters the pool
  (insert, decode and ragged writes), the kernels read the int8 pages with
  their scales, and the context paths dequantize the slot's pages;
- page table: host-side ``[B, max_pages]`` int32, uploaded per dispatch;
  pages are allocated at insert and before each decode chunk, freed at
  release, refcounted across slots;
- prefix cache: full prompt pages are content-addressed by a chain hash; a
  later prompt sharing the prefix reuses those pages as attention context
  and only the suffix is prefilled (plain ``prefill_attention_ctx``);
- decode attention reads pages straight from the pool through the table
  (kernel B, ``ops/cuda/paged.py``); the unified ragged step runs B decode
  rows plus one prefill chunk of a long prompt in one attention launch per
  layer (kernel C);
- tensor parallelism (``mesh_shape="2"``, or the default mesh: tp =
  ``largest_tp`` of the visible CUDA devices and the kv heads): the pools
  and scales shard kv heads, each rank's ``[L, P + 1, Hkv/tp, page, Dh]``
  on its device (``pool_k`` etc. are per-rank lists, of one on one
  device); pages are not sharded, so the allocator, page table, prefix
  cache and dump page are shared by every rank.  Decode runs kernel F (B's
  grid over every rank, one launch a device); prefill (kernel A), the prefix-hit context, legacy
  chunks and the ragged step (kernel C) run per rank.  (The JAX package runs prefill and the ragged
  step through its jnp references on a multi-device mesh only because
  GSPMD cannot partition a ``pallas_call``; A and C are independent per kv
  head, so the port runs them per rank.  The function is the same.)

Device state is updated in place (the JAX package donates and replaces
it); methods still return the state so callers read like the reference.
Legacy chunked admission (``ragged_prefill=False``) runs the base runner's
``prefill_step`` over accumulators seeded from cached prefix pages
(:meth:`PagedModelRunner.prefill_begin`).  Megastep, meshes other than
tp, and KV page export/import are not ported yet.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from crowdllama_tpu_torch.engine.runner import (
    ModelRunner,
    SlotState,
    resolve_device,
)
from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.ops.cuda.paged import (
    flash_paged_decode_attention_tp,
    ragged_paged_attention,
)
from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from crowdllama_tpu_torch.parallel.mesh import (
    Mesh,
    largest_tp,
    visible_devices,
)


class PagesExhausted(ValueError):
    """No free KV pages (overcommitted pool) — reject the request."""


@dataclass(kw_only=True)
class PagedDecodeState(SlotState):
    # Per rank, the rank's kv heads on its device.
    pool_k: list[torch.Tensor]    # [L, P+1, Hkv/tp, page, Dh] (int8 with
    pool_v: list[torch.Tensor]    # kv_dtype="int8")
    k_scale: list[torch.Tensor] | None = None  # [L, P+1, Hkv/tp, page]
    v_scale: list[torch.Tensor] | None = None  # bf16, int8 only


class PagedModelRunner(ModelRunner):
    """ModelRunner with the paged KV layout."""

    #: the scheduler runs long prompts through the unified ragged step
    supports_ragged = True
    kv_layout = "paged"

    def __init__(self, cfg, *args, page_size: int = 128, pool_tokens: int = 0,
                 prefix_cache: bool = True, step_token_budget: int = 0,
                 **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.page_size = page_size
        self.max_pages_per_slot = math.ceil(self.max_seq / page_size)
        total_tokens = pool_tokens or self.max_slots * self.max_seq
        self.total_pages = max(self.max_pages_per_slot,
                               math.ceil(total_tokens / page_size))
        # Host-side allocator state.
        self._free_pages: list[int] = list(range(self.total_pages))
        self._slot_pages: dict[int, list[int]] = {}
        self._host_seq = np.zeros((self.max_slots,), np.int64)
        self.page_table = np.zeros(
            (self.max_slots, self.max_pages_per_slot), np.int32)
        self.prefix_cache = prefix_cache
        self._prefix_index: dict[bytes, int] = {}  # chain hash -> page id
        self._page_key: dict[int, bytes] = {}      # reverse map
        self._page_refs: dict[int, int] = {}       # live slot refs per page
        self._index_lru: dict[bytes, int] = {}     # key -> last-use counter
        self._key_children: dict[bytes, set[bytes]] = {}  # chain structure
        self._lru_tick = 0
        self._pending_match: tuple[list[bytes], list[int]] | None = None
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        # Unified ragged batch: per-step token budget = one decode token
        # per slot + one prefill chunk of ``ragged_chunk`` tokens (a page
        # multiple; prefill_chunk by default so chunk boundaries match the
        # reference's monolithic chunked path).
        budget = step_token_budget or (self.prefill_chunk + self.max_slots)
        self.step_token_budget = budget
        c = min(self.prefill_chunk, max(budget - self.max_slots, page_size))
        self.ragged_chunk = max(page_size, (c // page_size) * page_size)
        # Slot owned by an in-progress ragged prefill: the grow/advance
        # loops must not treat it as a decoding slot.
        self._ragged_slot: int | None = None
        #: paged decode attention over the per-rank pools (kernel F: B's
        #: grid over every rank) and unified ragged attention (kernel C, per
        #: rank);
        #: seams like ``prefill_attn``
        self.decode_attn = flash_paged_decode_attention_tp
        self.ragged_attn = ragged_paged_attention

    def _build_mesh(self, mesh_shape, device, devices) -> Mesh:
        """The default mesh is the JAX paged runner's: tp = the largest
        degree dividing both the device count (``devices``, else the
        visible CUDA devices) and the kv heads; 1 on a one-card machine."""
        if not mesh_shape and device is None:
            devs = devices if devices is not None else visible_devices()
            tp = largest_tp(len(devs), self.cfg.num_kv_heads)
            if tp == 1 and devices is None:
                return Mesh.single(resolve_device(None))
            mesh_shape = str(tp)
        return super()._build_mesh(mesh_shape, device, devices)

    def _rank_kv(self, st: PagedDecodeState) -> list[tuple]:
        """Per rank: (pool_k, pool_v, k_scale, v_scale), the scales None on
        a bf16 pool."""
        none = [None] * self.tp
        return list(zip(st.pool_k, st.pool_v, st.k_scale or none,
                        st.v_scale or none))

    # ------------------------------------------------------------ allocator

    def _alloc(self, n: int) -> list[int]:
        if len(self._free_pages) < n:
            self._evict_cached(n - len(self._free_pages))
        if len(self._free_pages) < n:
            raise PagesExhausted(
                f"kv pool exhausted: need {n} pages, "
                f"{len(self._free_pages)} free (pool={self.total_pages})")
        return [self._free_pages.pop() for _ in range(n)]

    def _evict_cached(self, n: int) -> None:
        """Drop LRU prefix-cache pages no live slot references until ``n``
        pages are freed; evicting a chain key cascades to its descendants
        (they can never match again once an ancestor is gone)."""
        for key, _tick in sorted(self._index_lru.items(), key=lambda kv: kv[1]):
            if n <= 0:
                break
            if key not in self._prefix_index:
                continue  # already cascaded away by an ancestor's eviction
            if self._page_refs.get(self._prefix_index[key], 0) == 0:
                n -= self._deindex(key)

    def _deindex(self, key: bytes) -> int:
        """Remove ``key`` and its descendant chain from the index; returns
        how many pages went back to the free list (refcount-0 only)."""
        freed = 0
        stack = [key]
        while stack:
            k = stack.pop()
            page = self._prefix_index.pop(k, None)
            if page is None:
                continue
            self._page_key.pop(page, None)
            self._index_lru.pop(k, None)
            stack.extend(self._key_children.pop(k, ()))
            if self._page_refs.get(page, 0) == 0:
                self._free_pages.append(page)
                freed += 1
        return freed

    def _free(self, slot: int) -> None:
        for page in self._slot_pages.pop(slot, []):
            refs = self._page_refs.get(page, 1) - 1
            self._page_refs[page] = refs
            if refs <= 0 and page not in self._page_key:
                # Unshared, unindexed: back to the free list.  Indexed pages
                # stay allocated (prefix cache) until evicted under pressure.
                self._free_pages.append(page)
        self._host_seq[slot] = 0
        self.page_table[slot] = 0

    def _clear_pending(self) -> None:
        """Release an unconsumed prefill match (its insert never happened)."""
        if self._pending_match is not None:
            _, shared = self._pending_match
            for p in shared:
                self._page_refs[p] = self._page_refs.get(p, 1) - 1
            self._pending_match = None

    def _chain_keys(self, prompt_ids: list[int], n: int) -> list[bytes]:
        """Chain hashes of the first ``n`` full pages: key i commits to ALL
        tokens in pages 0..i, so equal keys mean equal full prefix."""
        keys, h = [], hashlib.sha256()
        pg = self.page_size
        for i in range(n):
            h.update(np.asarray(prompt_ids[i * pg:(i + 1) * pg],
                                np.int32).tobytes())
            keys.append(h.digest())
        return keys

    def chain_keys_for_prompt(self, prompt_ids: list[int]) -> list[bytes]:
        """Chain hashes of the prompt's pages a successor could take over
        (a MigrateFrame carries them; equal to the JAX runner's for the
        same ids and page size): the full pages before the last token, as
        prefill matching caps them (one token must remain for logits)."""
        return self._chain_keys(prompt_ids,
                                max(0, (len(prompt_ids) - 1) // self.page_size))

    def _match_prefix(self, keys: list[bytes]) -> list[int]:
        """Leading cached pages for ``keys`` (LRU-touched as they match)."""
        matched: list[int] = []
        for k in keys:
            page = self._prefix_index.get(k)
            if page is None:
                break
            matched.append(page)
            self._lru_tick += 1
            self._index_lru[k] = self._lru_tick
        return matched

    def _index_page(self, keys: list[bytes], i: int, page: int) -> None:
        """Index ``page`` under chain key ``keys[i]`` (first writer wins)."""
        key = keys[i]
        if key in self._prefix_index:
            return
        self._prefix_index[key] = page
        self._page_key[page] = key
        self._lru_tick += 1
        self._index_lru[key] = self._lru_tick
        if i > 0:  # chain edge for cascade eviction
            self._key_children.setdefault(keys[i - 1], set()).add(key)

    # --------------------------------------------------------------- state

    @torch.inference_mode()
    def init_state(self) -> PagedDecodeState:
        cfg = self.cfg
        shape = (cfg.num_layers, self.total_pages + 1,
                 cfg.num_kv_heads // self.tp, self.page_size,
                 cfg.resolved_head_dim())
        self._free_pages = list(range(self.total_pages))
        self._slot_pages = {}
        self._host_seq[:] = 0
        self.page_table[:] = 0
        self._prefix_index.clear()
        self._page_key.clear()
        self._page_refs.clear()
        self._index_lru.clear()
        self._key_children.clear()
        self._pending_match = None
        self._ragged_slot = None
        per = [self._kv_zeros(shape, d) for d in self.devices]
        scales = {name: [p[2][name] for p in per] for name in per[0][2]}
        return PagedDecodeState(pool_k=[p[0] for p in per],
                                pool_v=[p[1] for p in per],
                                **scales, **self._slot_fields())

    def _table(self, width: int | None = None) -> torch.Tensor:
        table = self.page_table if width is None else self.page_table[:, :width]
        return torch.from_numpy(np.ascontiguousarray(table)).to(self.device)

    # ------------------------------------------------------------- prefill

    def bucket_for(self, n: int) -> int:
        """Prefill buckets align to pages so prompt KV scatters whole pages:
        the base bucket rounds up to a page multiple."""
        base = super().bucket_for(n)
        return math.ceil(base / self.page_size) * self.page_size

    def prefill_prefers_monolithic(self, prompt_ids: list[int],
                                   chunk: int | None = None) -> bool:
        """True when the prefix cache covers enough of the prompt that the
        suffix-only prefill beats chunked admission: the uncovered suffix
        fits within one admission chunk."""
        if not self.prefix_cache:
            return False
        pg = self.page_size
        plen = len(prompt_ids)
        matched = 0
        for k in self._chain_keys(prompt_ids, max(0, (plen - 1) // pg)):
            if k not in self._prefix_index:
                break
            matched += pg
        return plen - matched <= (self.prefill_chunk if chunk is None
                                  else chunk)

    @torch.inference_mode()
    def prefill(self, prompt_ids: list[int], temperature: float, top_p: float,
                key=None, state: PagedDecodeState | None = None,
                top_k: int = 0, repeat_penalty: float = 1.0):
        """Bucketed prefill with automatic prefix caching.

        With ``state`` the prompt's full pages are looked up in the prefix
        index; on a hit only the suffix is prefilled, attending over the
        cached pages as context.  The match is stashed for the paired
        :meth:`insert` (the scheduler serializes admissions)."""
        self._clear_pending()
        pg = self.page_size
        plen = len(prompt_ids)
        if not self.prefix_cache:
            return super().prefill(prompt_ids, temperature, top_p, key,
                                   top_k=top_k, repeat_penalty=repeat_penalty)
        # Index keys for every full prompt page; matching is capped one page
        # earlier so at least one suffix token remains to produce logits.
        keys = self._chain_keys(prompt_ids, plen // pg)
        matched = ([] if state is None
                   else self._match_prefix(keys[:max(0, (plen - 1) // pg)]))
        # Suffix buckets round up: shrink the match until shared pages +
        # suffix-bucket pages fit the slot's page table.
        while matched:
            suffix_bucket = self.bucket_for(plen - len(matched) * pg)
            if len(matched) + suffix_bucket // pg <= self.max_pages_per_slot:
                break
            matched.pop()
        if not matched:
            if state is not None:
                self.prefix_misses += 1
            self._pending_match = (keys, [])
            return super().prefill(prompt_ids, temperature, top_p, key,
                                   top_k=top_k, repeat_penalty=repeat_penalty)
        self.prefix_hits += 1
        # Pin the matched pages now: the paired insert's _alloc could
        # otherwise evict and re-hand them out as fresh suffix pages.
        for p in matched:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        ctx_len = len(matched) * pg
        self.prefix_tokens_reused += ctx_len
        pages = np.full((self.max_pages_per_slot,), self.total_pages, np.int64)
        pages[:len(matched)] = matched  # dump-page padded
        tok, ks, vs = self._prefill_ctx(prompt_ids, ctx_len, state,
                                        torch.from_numpy(pages).to(self.device),
                                        temperature, top_p, key, top_k,
                                        repeat_penalty)
        self._pending_match = (keys, matched)
        return tok, ks, vs, plen

    def _prefill_ctx(self, prompt_ids, ctx_len, state, pages, temperature,
                     top_p, key, top_k, repeat_penalty):
        """Suffix prefill attending over cached prefix pages (``pages`` is
        the slot's dump-page padded page list; ``ctx_len`` masks the
        tail).  int8 context pages are dequantized and cast to the
        runner's dtype."""
        cfg = self.cfg
        l, dh = cfg.num_layers, cfg.resolved_head_dim()
        hkv = cfg.num_kv_heads // self.tp
        suffix = prompt_ids[ctx_len:]
        slen = len(suffix)
        t = self.bucket_for(slen)
        c = pages.shape[0] * self.page_size
        cks, cvs = [], []
        for pk, pv, ksc, vsc in self._rank_kv(state):
            idx = pages.to(pk.device)
            ck, cv = pk[:, idx], pv[:, idx]
            if self.kv_dtype == "int8":
                ck = dequantize_kv(ck, ksc[:, idx]).to(self.dtype)
                cv = dequantize_kv(cv, vsc[:, idx]).to(self.dtype)
            cks.append(ck.permute(0, 2, 1, 3, 4).reshape(l, 1, hkv, c, dh))
            cvs.append(cv.permute(0, 2, 1, 3, 4).reshape(l, 1, hkv, c, dh))
        dev = self.device
        ar = torch.arange(t, device=dev, dtype=torch.int32)
        ctx_valid = (torch.arange(c, device=dev) < ctx_len)[None]
        positions = (ctx_len + torch.clamp(ar, max=slen - 1))[None]
        kv_valid = (ar < slen)[None]
        x = T._embed(self.params, cfg, self._padded(suffix, t))
        x, ks, vs = T.scan_prefill_layers(
            T.layer_stacks(self.params), self.windows, cfg, x, positions,
            kv_valid=kv_valid, ctx_k=cks, ctx_v=cvs, ctx_valid=ctx_valid,
            rope=self.ropes)
        logits = T._unembed(self.params, cfg, x[:, slen - 1])
        tok = self._sample_first(logits, prompt_ids, temperature, top_p,
                                 key, top_k, repeat_penalty)
        return tok, ks, vs

    @torch.inference_mode()
    def prefill_begin(self, prompt_ids: list[int],
                      state: PagedDecodeState | None = None):
        """Legacy chunked-admission job, seeded from cached prefix pages:
        with ``state`` the cached prefix's KV is copied into the job's
        accumulators and ``done_tokens`` starts past it, so only the
        uncovered suffix is prefilled (int8 pages dequantized in fp32, then
        cast to the accumulators' dtype).  The job's insert scatters the
        whole prompt into fresh pages."""
        self._clear_pending()
        job = super().prefill_begin(prompt_ids)
        if state is None or not self.prefix_cache:
            return job
        pg = self.page_size
        plen = len(prompt_ids)
        # Cap one page early: >= 1 suffix token must remain for logits.
        matched = self._match_prefix(
            self._chain_keys(prompt_ids, max(0, (plen - 1) // pg)))
        if not matched:
            self.prefix_misses += 1
            return job
        cfg = self.cfg
        l, dh = cfg.num_layers, cfg.resolved_head_dim()
        hkv = cfg.num_kv_heads // self.tp
        ctx_len = len(matched) * pg
        for (pk, pv, ksc, vsc), ctx_k, ctx_v in zip(
                self._rank_kv(state), job.ctx_k, job.ctx_v):
            pages = torch.as_tensor(matched, dtype=torch.long,
                                    device=pk.device)
            for pool, scales, ctx in ((pk, ksc, ctx_k), (pv, vsc, ctx_v)):
                kv = pool[:, pages]
                if self.kv_dtype == "int8":
                    kv = dequantize_kv(kv, scales[:, pages])
                ctx[:, :, :, :ctx_len] = kv.permute(0, 2, 1, 3, 4).reshape(
                    l, 1, hkv, ctx_len, dh).to(ctx.dtype)
        job.done_tokens = ctx_len
        self.prefix_hits += 1
        self.prefix_tokens_reused += ctx_len
        return job

    @torch.inference_mode()
    def warmup_ctx_prefill(self, state: PagedDecodeState) -> None:
        """Run the suffix-over-cached-context prefill once (ctx_len 0 masks
        the context; the page list is what a real hit passes)."""
        pages = torch.full((self.max_pages_per_slot,), self.total_pages,
                           dtype=torch.long, device=self.device)
        self._prefill_ctx([1], 0, state, pages, 0.0, 1.0, None, 0, 1.0)

    @torch.inference_mode()
    def insert(self, state: PagedDecodeState, slot: int, ks, vs, plen: int,
               first_token: int, temperature: float, top_p: float,
               prompt_tokens: list[int] | None = None, slot_key=None,
               top_k: int = 0, repeat_penalty: float = 1.0):
        """Place a prefilled sequence: shared prefix pages (from the paired
        prefill's match, refcounted) + freshly scattered suffix pages.
        ``slot_key`` seeds the slot's sampling stream (default:
        ``default_slot_key(slot)``)."""
        bucket = ks[0].shape[3]
        pg = self.page_size
        if bucket % pg != 0:
            raise ValueError(
                f"prefill bucket {bucket} not a multiple of page size "
                f"{pg} (align buckets to pages)")
        keys, shared = self._pending_match or ([], [])
        self._pending_match = None
        if not keys and self.prefix_cache and prompt_tokens:
            keys = self._chain_keys(list(prompt_tokens),
                                    len(prompt_tokens) // pg)
        self._free(slot)  # defensive: slot must not leak prior pages
        try:
            fresh = self._alloc(bucket // pg)
        except PagesExhausted:
            for p in shared:  # release the prefill-time pins
                self._page_refs[p] = self._page_refs.get(p, 1) - 1
            raise
        pages = list(shared) + fresh
        for p in fresh:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        self._slot_pages[slot] = pages
        self._host_seq[slot] = plen
        self.page_table[slot] = 0
        self.page_table[slot, :len(pages)] = pages
        if self.prefix_cache:
            # Index every fresh page fully covered by prompt tokens (decode
            # writes start at plen, beyond them: the pages are immutable).
            ctx_len = len(shared) * pg
            for i, page in enumerate(fresh):
                ki = len(shared) + i
                if ctx_len + (i + 1) * pg > plen or ki >= len(keys):
                    break
                self._index_page(keys, ki, page)
        for (pk, pv, ksc, vsc), kr, vr in zip(self._rank_kv(state), ks, vs):
            # [L, 1, Hkv, bucket, Dh] -> [L, np, Hkv, page, Dh] page-major
            l, _, hkv, _, dh = kr.shape
            idx = torch.as_tensor(fresh, dtype=torch.long, device=pk.device)
            if self.kv_dtype == "int8":
                # Quantize before the page scatter; scales [L, 1, Hkv,
                # bucket] -> [L, np, Hkv, page] like the values.
                kr, k_sc = quantize_kv(kr, ksc.dtype)
                vr, v_sc = quantize_kv(vr, vsc.dtype)
                for sc_pool, sc in ((ksc, k_sc), (vsc, v_sc)):
                    sc_pool[:, idx] = sc[:, 0].reshape(
                        l, hkv, bucket // pg, pg).permute(0, 2, 1, 3)
            for pool, kv in ((pk, kr), (pv, vr)):
                pool[:, idx] = kv[:, 0].reshape(
                    l, hkv, bucket // pg, pg, dh).permute(0, 2, 1, 3, 4).to(
                    pool.dtype)
        recent_row = self._recent_from_prompt(
            list(prompt_tokens or []), first_token, plen=plen)
        self._activate(state, slot, plen, first_token, temperature, top_p,
                       top_k, repeat_penalty, recent_row, slot_key)
        return state

    @torch.inference_mode()
    def release(self, state: PagedDecodeState, slot: int):
        self._free(slot)
        self._deactivate(state, slot)
        return state

    # -------------------------------------------------------------- decode

    def _ensure_slot(self, slot: int, steps: int) -> None:
        """Grow one slot's page table to cover ``steps`` more tokens."""
        pages = self._slot_pages[slot]
        needed_tokens = min(int(self._host_seq[slot]) + steps + 1,
                            self.max_seq)
        needed = math.ceil(needed_tokens / self.page_size)
        if needed > len(pages):
            new = self._alloc(needed - len(pages))
            self.page_table[slot, len(pages):len(pages) + len(new)] = new
            pages.extend(new)

    def pre_decode_check(self, steps: int) -> list[int]:
        """Scheduler hook: grow every live slot for the coming chunk; slots
        an overcommitted pool cannot grow are returned for a forced
        length-finish."""
        starved = []
        for slot in list(self._slot_pages):
            if slot == self._ragged_slot:
                continue  # grows by chunk inside ragged_step, never decodes
            try:
                self._ensure_slot(slot, steps)
            except PagesExhausted:
                starved.append(slot)
        return starved

    def _advance_host(self, steps: int, skip: int | None = None) -> None:
        for slot in self._slot_pages:
            if slot != skip:
                self._host_seq[slot] = min(self._host_seq[slot] + steps,
                                           self.max_seq)

    def _decode_positions(self, st: PagedDecodeState, table: torch.Tensor):
        """(positions, lens, write pages, write offsets) of the B decode
        rows; inactive slots write to the dump page."""
        positions = torch.clamp(st.seq_lens, max=self.max_seq - 1)
        lens = torch.clamp(st.seq_lens + 1, max=self.max_seq)
        slot_idx = torch.arange(self.max_slots, device=self.device)
        cur = table[slot_idx, (positions // self.page_size).long()]
        dump = torch.full_like(cur, self.total_pages)
        return (positions, lens, torch.where(st.active, cur, dump),
                positions % self.page_size)

    def _layer_kv(self, st: PagedDecodeState, i: int) -> list[tuple]:
        """Per rank: layer ``i``'s (pool_k, pool_v, k_scale, v_scale)."""
        return [tuple(None if x is None else x[i] for x in rank)
                for rank in self._rank_kv(st)]

    def _write_kv(self, layer: tuple, wpages, woffs, k, v) -> dict:
        """Scatter rows k/v [N, Hkv, Dh] into one layer's pools ``layer``
        (one rank's, from :meth:`_layer_kv`) at (page, offset) pairs,
        quantized on an int8 pool; returns the scale keywords the
        attention kernels take ({} on a bf16 pool)."""
        pk, pv, sk, sv = layer
        if self.kv_dtype != "int8":
            pk[wpages, :, woffs] = k.to(pk.dtype)
            pv[wpages, :, woffs] = v.to(pv.dtype)
            return {}
        kq, k_sc = quantize_kv(k, sk.dtype)
        vq, v_sc = quantize_kv(v, sv.dtype)
        pk[wpages, :, woffs] = kq
        pv[wpages, :, woffs] = vq
        sk[wpages, :, woffs] = k_sc
        sv[wpages, :, woffs] = v_sc
        return dict(k_scale=sk, v_scale=sv)

    def _on_ranks(self, *xs: torch.Tensor) -> list[tuple]:
        """``xs`` on every rank's device, per rank (no copy on rank 0's)."""
        return [tuple(x.to(d) for x in xs) for d in self.devices]

    def _layer_body(self, i: int, x, positions, attn_fn):
        """Layer ``i`` over x [N, D] with ``attn_fn`` taking and returning
        per-rank lists."""
        return T.decode_layer_body(
            T.layer_params(T.layer_stacks(self.params), i), self.cfg, x,
            positions, self.ropes, attn_fn)

    def decode_logits(self, st: PagedDecodeState,
                      table: torch.Tensor) -> torch.Tensor:
        """One decode step's forward for every slot: writes each token's KV
        into the pool and returns logits [B, V] fp32 (no sampling).  The
        attention is one kernel F call per layer (one launch per device)."""
        cfg = self.cfg
        positions, lens, wpages, woffs = self._decode_positions(st, table)
        writes = self._on_ranks(wpages.long(), woffs.long())
        kw = dict(softcap=cfg.attn_logit_softcap)
        x = T._embed(self.params, cfg, st.tokens.long())
        for i, window in enumerate(self.windows):
            layer = self._layer_kv(st, i)

            def attn_fn(qs, ks, vs, layer=layer, window=window):
                scales = [self._write_kv(lay, *w, k, v)
                          for lay, w, k, v in zip(layer, writes, ks, vs)]
                per_rank = {}
                if scales[0]:
                    per_rank = dict(k_scales=[sc["k_scale"] for sc in scales],
                                    v_scales=[sc["v_scale"] for sc in scales])
                return self.decode_attn(qs, [lay[0] for lay in layer],
                                        [lay[1] for lay in layer], table,
                                        lens, self.scale,
                                        sliding_window=window, **kw,
                                        **per_rank)

            x = self._layer_body(i, x, positions, attn_fn)
        return T._unembed(self.params, cfg, x)

    @torch.inference_mode()
    def decode_steps_device(self, state: PagedDecodeState, num_steps: int = 1):
        """``num_steps`` decode steps; returns (tokens [K, B] int32 on the
        device, state).  Page growth and the host sequence mirror are
        dispatch-time bookkeeping."""
        for slot in list(self._slot_pages):
            if slot != self._ragged_slot:
                self._ensure_slot(slot, num_steps)
        table = self._table()
        noise = self._step_noise(state, num_steps)
        out = []
        for i in range(num_steps):
            out.append(self._sample_decode(
                state, self.decode_logits(state, table),
                None if noise is None else noise[i]))
        self._advance_host(num_steps, skip=self._ragged_slot)
        return torch.stack(out), state

    # ------------------------------------------------ unified ragged batch

    class RaggedPrefillJob:
        """Host handle for a prefill running inside the decode loop: every
        chunk's KV lands directly in the slot's pool pages, and full pages
        are prefix-indexed as they complete."""

        ragged = True  # scheduler routes abort/advance by this marker

        def __init__(self, prompt_ids, slot, keys):
            self.prompt_ids = prompt_ids
            self.slot = slot
            self.keys = keys          # chain hashes of full prompt pages
            self.done_tokens = 0
            self.last_logits = None   # [V] f32, final prompt token
            self.indexed = 0          # pages already prefix-indexed

        @property
        def finished(self) -> bool:
            return self.done_tokens >= len(self.prompt_ids)

    def ragged_begin(self, prompt_ids: list[int], slot: int,
                     state: PagedDecodeState) -> "RaggedPrefillJob":
        """Reserve ``slot`` for chunked-in-the-decode-loop prefill; cached
        prefix pages become the slot's leading pages at once."""
        if self._ragged_slot is not None:
            raise RuntimeError("one ragged prefill at a time")
        plen = len(prompt_ids)
        if plen >= self.max_seq:
            raise ValueError(f"prompt of {plen} tokens exceeds max context "
                             f"{self.max_seq}")
        self._clear_pending()
        pg = self.page_size
        keys = self._chain_keys(list(prompt_ids), plen // pg)
        job = self.RaggedPrefillJob(list(prompt_ids), slot, keys)
        self._free(slot)  # defensive: slot must not leak prior pages
        matched: list[int] = []
        if self.prefix_cache:
            matched = self._match_prefix(keys[:max(0, (plen - 1) // pg)])
            if matched:
                self.prefix_hits += 1
                self.prefix_tokens_reused += len(matched) * pg
            else:
                self.prefix_misses += 1
        for p in matched:  # pin becomes the slot's reference
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        self._slot_pages[slot] = list(matched)
        self._host_seq[slot] = len(matched) * pg
        self.page_table[slot] = 0
        self.page_table[slot, :len(matched)] = matched
        job.done_tokens = len(matched) * pg
        job.indexed = len(matched)
        self._ragged_slot = slot
        return job

    def _ragged_window(self) -> int:
        """Page-table width this dispatch needs: the most pages any slot
        holds, rounded up to a power of two, at least 4 pages."""
        need = max([4] + [len(p) for p in self._slot_pages.values()])
        wp = 4
        while wp < need:
            wp *= 2
        return min(wp, self.max_pages_per_slot)

    def _ragged_provision(self, job: "RaggedPrefillJob", num_steps: int):
        """Grow the chunk slot's pages to the dispatch end and every decoding
        slot for ``num_steps`` tokens; returns (chunk tokens [K, C],
        per-step context lengths, dispatch end, table width)."""
        c, pg, slot = self.ragged_chunk, self.page_size, job.slot
        total = len(job.prompt_ids)
        ctx0 = job.done_tokens
        end = min(ctx0 + num_steps * c, total)
        pages = self._slot_pages[slot]
        needed = math.ceil(end / pg)
        if needed > len(pages):
            new = self._alloc(needed - len(pages))
            self.page_table[slot, len(pages):len(pages) + len(new)] = new
            pages.extend(new)
        for s in list(self._slot_pages):
            if s != slot:
                self._ensure_slot(s, num_steps)
        chunk_tokens = np.zeros((num_steps, c), np.int64)
        flat = job.prompt_ids[ctx0:end]
        chunk_tokens.reshape(-1)[:len(flat)] = flat
        ctx_arr = [ctx0 + i * c for i in range(num_steps)]
        return chunk_tokens, ctx_arr, end, self._ragged_window()

    def ragged_logits(self, st: PagedDecodeState, table: torch.Tensor,
                      total_len: int, chunk_slot: int, ctx_i: int,
                      ctoks: torch.Tensor) -> tuple[torch.Tensor, int]:
        """One unified step's forward: B decode rows plus the chunk rows
        ``ctoks`` [C] of ``chunk_slot`` at positions ctx_i.., KV scattered
        into the pool in the same layer pass.  Returns (logits [B + 1, V]:
        the decode rows then the last valid chunk row, valid chunk rows)."""
        cfg, pg, b, dev = self.cfg, self.page_size, self.max_slots, self.device
        c = ctoks.shape[0]
        valid = max(0, min(total_len - ctx_i, c))
        positions_dec, lens_dec, cur_page, offs = self._decode_positions(
            st, table)
        cpos = torch.clamp(ctx_i + torch.arange(c, device=dev,
                                                dtype=torch.int32),
                           max=self.max_seq - 1)
        cidx = torch.clamp(cpos // pg, max=table.shape[1] - 1).long()
        crow_ok = torch.arange(c, device=dev) < valid
        cpages = torch.where(crow_ok, table[chunk_slot, cidx],
                             torch.full_like(cpos, self.total_pages))
        wpages = torch.cat([cur_page, cpages]).long()
        woffs = torch.cat([offs, cpos % pg]).long()
        positions = torch.cat([positions_dec, cpos])
        q_lens = torch.cat([st.active.to(torch.int32),
                            torch.tensor([valid], dtype=torch.int32,
                                         device=dev)])
        kv_lens = torch.cat([lens_dec, torch.tensor(
            [ctx_i + valid], dtype=torch.int32, device=dev)])
        ranked = self._on_ranks(wpages, woffs, table, q_lens, kv_lens)
        x = T._embed(self.params, cfg,
                     torch.cat([st.tokens.long(), ctoks]))
        for i, window in enumerate(self.windows):
            layer = self._layer_kv(st, i)

            def attn_fn(qs, ks, vs, layer=layer, window=window):
                outs = []
                for lay, (wp, wo, tab, ql, kl), q, k, v in zip(
                        layer, ranked, qs, ks, vs):
                    scales = self._write_kv(lay, wp, wo, k, v)
                    # The chunk's fresh KV also rides as operands: the
                    # plain version's self block reads it directly.
                    chunk_k = k[b:].transpose(0, 1)[None]
                    chunk_v = v[b:].transpose(0, 1)[None]
                    outs.append(self.ragged_attn(
                        q, chunk_k, chunk_v, lay[0], lay[1], tab, ql, kl,
                        chunk_slot, self.scale,
                        softcap=cfg.attn_logit_softcap,
                        sliding_window=window, **scales))
                return outs

            x = self._layer_body(i, x, positions, attn_fn)
        # Unembed the B decode rows + ONE chunk row (the last valid one).
        rows = torch.cat([x[:b], x[b + max(valid - 1, 0)][None]])
        return T._unembed(self.params, cfg, rows), valid

    @torch.inference_mode()
    def ragged_step(self, state: PagedDecodeState, job: "RaggedPrefillJob",
                    num_steps: int = 1):
        """Dispatch ``num_steps`` unified steps: every active decode slot
        advances one token per step AND the job prefills up to
        ``ragged_chunk`` prompt tokens per step.  Returns (decode tokens
        [K, B] on the device, state).  Raises PagesExhausted when the pool
        cannot cover the job's next pages."""
        chunk_tokens, ctx_arr, end, wp = self._ragged_provision(job,
                                                                num_steps)
        table = self._table(wp)
        ctoks = torch.from_numpy(chunk_tokens).to(self.device)
        noise = self._step_noise(state, num_steps)
        out = []
        for i in range(num_steps):
            logits, valid = self.ragged_logits(
                state, table, len(job.prompt_ids), job.slot, ctx_arr[i],
                ctoks[i])
            if valid > 0:
                job.last_logits = logits[-1]
            out.append(self._sample_decode(
                state, logits[:-1], None if noise is None else noise[i]))
        job.done_tokens = end
        self._host_seq[job.slot] = end
        self._advance_host(num_steps, skip=job.slot)
        self._ragged_index(job)
        return torch.stack(out), state

    def _ragged_index(self, job: "RaggedPrefillJob") -> None:
        """Prefix-index the job's freshly completed full pages."""
        if not self.prefix_cache:
            return
        pages = self._slot_pages.get(job.slot, [])
        limit = min(len(job.keys), len(pages))
        while (job.indexed < limit
               and (job.indexed + 1) * self.page_size <= job.done_tokens):
            self._index_page(job.keys, job.indexed, pages[job.indexed])
            job.indexed += 1

    @torch.inference_mode()
    def ragged_finish(self, state: PagedDecodeState, job: "RaggedPrefillJob",
                      temperature: float, top_p: float, key=None,
                      slot_key=None, top_k: int = 0,
                      repeat_penalty: float = 1.0):
        """Sample the first token and activate the slot (its KV is already
        in its pages).  Returns (first_token, state)."""
        if not job.finished or job.last_logits is None:
            raise RuntimeError("ragged_finish before the prompt is prefilled")
        plen = len(job.prompt_ids)
        first = self._sample_first(job.last_logits[None], job.prompt_ids,
                                   temperature, top_p, key, top_k,
                                   repeat_penalty)
        recent_row = self._recent_from_prompt(job.prompt_ids, first,
                                              plen=plen)
        self._activate(state, job.slot, plen, first, temperature, top_p,
                       top_k, repeat_penalty, recent_row, slot_key)
        self._host_seq[job.slot] = plen
        self._ragged_index(job)
        self._ragged_slot = None
        return first, state

    def ragged_abort(self, job: "RaggedPrefillJob") -> None:
        """Abandon a mid-flight ragged prefill: free its pages; completed
        pages already indexed stay cached."""
        if self._ragged_slot == job.slot:
            self._free(job.slot)
            self._ragged_slot = None
