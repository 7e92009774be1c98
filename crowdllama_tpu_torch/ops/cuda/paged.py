"""Kernels B, C, E and F: attention over the paged KV pool
(``csrc/paged_attention.cu``).

Counterparts of ``crowdllama_tpu/ops/pallas/paged.py``:

- B, :func:`flash_paged_decode_attention` (TPU ``flash_paged_decode_
  attention``): one decode token per slot over that slot's pages.  Its
  plain version, :func:`paged_decode_attention_plain`, gathers the pages
  and runs ``decode_attention_ref`` (``decode_attention_q`` on int8 pools).
- C, :func:`ragged_paged_attention` (TPU ``flash_ragged_paged_attention``
  behind the ``ragged_paged_attention`` dispatch): the unified ragged
  batch, B decode rows plus one prefill chunk, in one launch.  Its plain
  version is :func:`ragged_paged_attention_ref`.
- E, :func:`flash_ragged_chunk_attention` (TPU ``flash_ragged_chunk_
  attention``, the same name and signature): one prefill chunk alone over
  its slot's pages, C's chunk blocks without decode rows.  No engine path
  of either package calls it (the unified step replaced it); its plain
  version is :func:`ragged_chunk_attention_plain`.
- F, :func:`flash_paged_decode_attention_tp` (TPU ``flash_paged_decode_
  attention_tp``): kernel B on every tensor-parallel rank's share of the
  q heads and pool kv heads, table and lengths shared; the per-rank
  outputs concatenated over heads are B's answer on the whole pool, bit
  for bit.  The ranks that share a device (at most :data:`MAX_RANKS`) run
  as one launch of B's grid, counted in F's ``launches``; B's counts do
  not move.  Its plain version,
  :func:`paged_decode_attention_tp_plain`, runs B's per rank.  The paged
  decode step calls F at every tp degree; over one rank F is B's launch
  alone and does not count as an F launch.

B splits each (slot, kv head) into the key runs of :func:`split_plan`,
one block each, and merges them in the same launch; its fp32 partials and
per-(slot, kv head) counters live in a buffer made once per device and
grown as needed (:func:`split_scratch`), so a call launches nothing else.
Calls on one device share that buffer, kernel D's calls too
(``ops/cuda/flash.py``), so they run in one stream's order; every launch
leaves the counters at zero.

Pools are one layer's ``[P, Hkv, page, Dh]`` (Dh 64, 128 or 256 on the
card), bf16 or int8 (the last page is the engine's dump page), tables
``[B, NP]`` int32.  An int8 pool comes
with per-position scales ``k_scale``/``v_scale`` ``[P, Hkv, page]`` bf16:
the K scale multiplies the scores, the V scale the probabilities after
the softmax denominator is summed.  Each wrapper launches its kernel (the
bf16 or the int8 variant, counted apart in ``launches`` and
``launches_int8``) for CUDA tensors and runs its plain version for CPU
tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from crowdllama_tpu_torch.ops.attention import (
    NEG_INF,
    _softcap,
    _softmax_rows,
    _window_ok,
    decode_attention_q,
    decode_attention_ref,
    prefill_attention_ctx,
)
from crowdllama_tpu_torch.ops.cuda import check, check_head_dim, launch
from crowdllama_tpu_torch.ops.quant import dequantize_kv

# Query heads per kv head: a decode warp each, 8 warps a block; the chunk
# blocks' 128 (query, head) rows hold at least 16 queries.
MAX_GROUP = 8
MAX_PAGE = 128
PAGE_ALIGN = 16   # keys the chunk tile gathers together (one mma k-step)
# The split-KV plan of kernels B and D: keys a split walks (two pages of
# 128), the most splits a (slot, kv head) is cut into, and the keys of one
# decode stage (D's plan is B's over the cache cut into stages).
SPLIT_KEYS = 256
MAX_SPLITS = 32
DECODE_STAGE_KEYS = 64
MAX_RANKS = 8     # ranks on one device one launch of B's grid takes (F)


def _gathered(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, page, Dh] pool -> [rows, Hkv, NP*page, Dh] view of each
    table row's pages (a copy)."""
    rows, np_ = table.shape
    _, hkv, page, dh = pool.shape
    return pool[table.long()].permute(0, 2, 1, 3, 4).reshape(
        rows, hkv, np_ * page, dh)


def _gathered_scales(scales: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, page] scales -> [rows, Hkv, NP*page] (a copy)."""
    rows, np_ = table.shape
    _, hkv, page = scales.shape
    return scales[table.long()].permute(0, 2, 1, 3).reshape(
        rows, hkv, np_ * page)


def paged_decode_attention_plain(q, pool_k, pool_v, page_table, seq_lens,
                                 scale: float, softcap: float = 0.0,
                                 sliding_window: int = 0, k_scale=None,
                                 v_scale=None) -> torch.Tensor:
    """The plain version of kernel B: gather each slot's pages into a
    virtual-contiguous view and run :func:`decode_attention_ref`, or on an
    int8 pool :func:`decode_attention_q` over the gathered pages and
    scales."""
    view_k = _gathered(pool_k, page_table)
    view_v = _gathered(pool_v, page_table)
    kw = dict(softcap=softcap, sliding_window=sliding_window)
    if k_scale is None:
        return decode_attention_ref(q, view_k, view_v, seq_lens, scale, **kw)
    return decode_attention_q(q, view_k, _gathered_scales(k_scale, page_table),
                              view_v, _gathered_scales(v_scale, page_table),
                              seq_lens, scale, **kw)


def ragged_paged_attention_ref(q, chunk_k, chunk_v, pool_k, pool_v,
                               page_table, q_lens, kv_lens, chunk_slot: int,
                               scale: float, softcap: float = 0.0,
                               sliding_window: int = 0, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """The plain version of kernel C (reference semantics).

    q [B + C, H, Dh]: B decode rows (q_len 0 or 1), then the chunk rows of
    sequence B (q_len = q_lens[B] <= C); chunk_k/chunk_v [1, Hkv, C, Dh] the
    chunk's fresh KV (also already in the pool).  Decode rows run the gather
    + decode math of kernel B's plain version; chunk rows run
    :func:`prefill_attention_ctx` with the slot's pages as cached context
    (on an int8 pool dequantized in fp32) and the fresh chunk KV as the
    self block.  Rows that carry no query (inactive slots, chunk rows past
    q_lens[B]) hold values the caller discards.
    """
    b = page_table.shape[0]
    c = chunk_k.shape[2]
    _, hkv, page, dh = pool_k.shape
    w = page_table.shape[1] * page
    out_dec = paged_decode_attention_plain(
        q[:b], pool_k, pool_v, page_table, kv_lens[:b], scale,
        softcap=softcap, sliding_window=sliding_window, k_scale=k_scale,
        v_scale=v_scale)

    ctx = kv_lens[b] - q_lens[b]
    row = page_table[chunk_slot:chunk_slot + 1]
    ctx_k = _gathered(pool_k, row)
    ctx_v = _gathered(pool_v, row)
    if k_scale is not None:
        ctx_k = dequantize_kv(ctx_k, _gathered_scales(k_scale, row))
        ctx_v = dequantize_kv(ctx_v, _gathered_scales(v_scale, row))
    dev = q.device
    ctx_valid = (torch.arange(w, device=dev) < ctx)[None, :]
    positions = (ctx + torch.arange(c, device=dev))[None, :]
    kv_valid = (torch.arange(c, device=dev) < q_lens[b])[None, :]
    out_chunk = prefill_attention_ctx(
        q[b:][None], chunk_k, chunk_v, positions, ctx_k, ctx_v, ctx_valid,
        scale, softcap=softcap, sliding_window=sliding_window,
        kv_valid=kv_valid)[0]
    return torch.cat([out_dec, out_chunk], dim=0)


def _check_scales(pool_k, pool_v, k_scale, v_scale) -> bool:
    """Validate the pool/scales pairing on any device; True for an int8
    pool (whose kernels and plain versions read the scales)."""
    quant = k_scale is not None or v_scale is not None
    int8 = pool_k.dtype == torch.int8 or pool_v.dtype == torch.int8
    check(quant == int8, "an int8 pool needs k_scale and v_scale, and only "
          "an int8 pool takes them")
    if quant:
        check(k_scale is not None and v_scale is not None,
              "k_scale and v_scale come together")
        check(pool_k.dtype == pool_v.dtype == torch.int8,
              "pool_k and pool_v must both be int8")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            check(s.dtype == torch.bfloat16
                  and tuple(s.shape) == tuple(pool_k.shape[:3]),
                  f"{name} must be bfloat16 [P, Hkv, page] like the pool")
    return quant


def _check_pool(q, pool_k, pool_v, page_table, k_scale,
                v_scale) -> tuple[int, int, int, int]:
    """Validate the operands both paged kernels share; returns
    (H, Hkv, page, NP)."""
    check(q.dim() == 3 and pool_k.dim() == 4,
          "q must be [rows, H, Dh] and the pools [P, Hkv, page, Dh]")
    h, dh = q.shape[1], q.shape[2]
    _, hkv, page, pdh = pool_k.shape
    scales = [] if k_scale is None else [k_scale, v_scale]
    ops = (q, pool_k, pool_v, page_table, *scales)
    check(q.device.type == "cuda", f"unsupported device {q.device}")
    check(all(x.device == q.device for x in ops),
          "all operands must be on one device")
    check(q.dtype == torch.bfloat16, "q must be bfloat16")
    check(scales or pool_k.dtype == pool_v.dtype == torch.bfloat16,
          "pools must be bfloat16 (or int8 with scales)")
    check(dh == pdh, f"q's head dim {dh} != the pool's {pdh}")
    check_head_dim(dh)
    check(pool_v.shape == pool_k.shape, "pool_k/pool_v shapes differ")
    check(h % hkv == 0 and h // hkv <= MAX_GROUP,
          f"heads {h}/{hkv}: at most {MAX_GROUP} query heads per kv head")
    check(page % PAGE_ALIGN == 0 and page <= MAX_PAGE,
          f"page size {page} must be a multiple of {PAGE_ALIGN}, "
          f"at most {MAX_PAGE}")
    check(page_table.dtype == torch.int32 and page_table.dim() == 2,
          "page_table must be int32 [B, NP]")
    check(all(x.is_contiguous() for x in ops), "operands must be contiguous")
    check(all(x.data_ptr() % 16 == 0 for x in (q, pool_k, pool_v, *scales)),
          "q, pools and scales must be 16-byte aligned (16-byte copies)")
    return h, hkv, page, page_table.shape[1]


def split_plan(np_: int, page: int) -> tuple[int, int]:
    """Kernel B's split of a slot's keys: (pages per split, splits).  Split
    s walks the table's pages ``[s * pps, (s + 1) * pps)``.  It depends on
    the table width and the page size alone: the host sizes the grid
    without reading the lengths, and every tensor-parallel share of a pool
    splits a (slot, kv head) exactly as the whole pool does."""
    pps = max(1, SPLIT_KEYS // page, -(-np_ // MAX_SPLITS))
    return pps, max(1, -(-np_ // pps))


# device -> (fp32 partials, int32 arrival counters) of the split merge of
# kernels B and D.
_SPLIT_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def split_scratch(device: torch.device, rows: int,
                  floats: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The split merge's partials (at least ``floats`` fp32) and one counter
    per (slot, rank, kv head) row on ``device``, made once and grown as
    needed, shared by kernels B and D.  New counters are zeros and every
    launch leaves them at zero, so a call needs no memset."""
    scratch, counters = _SPLIT_SCRATCH.get(device, (None, None))
    if scratch is None or scratch.numel() < floats:
        scratch = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < rows:
        counters = torch.zeros(rows, dtype=torch.int32, device=device)
    _SPLIT_SCRATCH[device] = (scratch, counters)
    return scratch, counters


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def decode_launch_shape(qs, pools_k, table) -> dict:
    """The launch of kernel B's grid over the ranks ``qs`` (one for B, a
    device's ranks for F), from shapes alone: the split plan, the grid
    (ranks x Hkv, B, splits), threads a block (8 warps at every group
    size) and the scratch's rows (slot, rank, kv head) and fp32
    partials."""
    b, h, dh = qs[0].shape
    _, hkv, page, _ = pools_k[0].shape
    np_ = table.shape[1]
    pps, splits = split_plan(np_, page)
    rows = b * hkv * len(qs)
    g = h // hkv
    return dict(pps=pps, splits=splits, grid=(len(qs) * hkv, b, splits),
                threads=256, rows=rows, floats=rows * splits * g * (dh + 4))


def _launch_decode(qs, pools_k, pools_v, k_scales, v_scales, table, seq_lens,
                   scale: float, softcap: float,
                   window: int) -> list[torch.Tensor]:
    """One launch of kernel B's split-KV grid over the ranks ``qs`` (all on
    one device, validated, sharing ``table`` and ``seq_lens`` there; scales
    None on bf16 pools); returns each rank's output."""
    dev = qs[0].device
    shape = decode_launch_shape(qs, pools_k, table)
    scratch, counters = split_scratch(dev, shape["rows"], shape["floats"])
    outs = [torch.empty_like(q) for q in qs]
    arrays = [_ptrs(x) for x in (qs, pools_k, pools_v)]
    if k_scales is not None:
        arrays += [_ptrs(k_scales), _ptrs(v_scales)]
    arrays.append(_ptrs(outs))
    b, h, dh = qs[0].shape
    _, hkv, page, _ = pools_k[0].shape
    launch("paged_attention",
           "paged_decode" if k_scales is None else "paged_decode_i8", dev,
           len(qs), *(ctypes.addressof(a) for a in arrays), table.data_ptr(),
           seq_lens.data_ptr(), scratch.data_ptr(), counters.data_ptr(), b, h,
           hkv, page, table.shape[1], shape["pps"], shape["splits"],
           float(scale), float(softcap or 0.0), int(window), dh)
    return outs


def _check_decode(q, pool_k, pool_v, page_table, seq_lens, k_scale=None,
                  v_scale=None) -> None:
    _check_pool(q, pool_k, pool_v, page_table, k_scale, v_scale)
    b = q.shape[0]
    check(page_table.shape[0] == b, "page_table rows != batch")
    check(seq_lens.device == q.device and seq_lens.dtype == torch.int32
          and tuple(seq_lens.shape) == (b,) and seq_lens.is_contiguous(),
          "seq_lens must be int32 [B] on the device")


def flash_paged_decode_attention(q, pool_k, pool_v, page_table, seq_lens,
                                 scale: float, softcap: float = 0.0,
                                 sliding_window: int = 0, k_scale=None,
                                 v_scale=None) -> torch.Tensor:
    """One decode step over the paged pool: q [B, H, Dh], seq_lens [B]
    int32 (incl. the pending token); returns [B, H, Dh].  ``k_scale`` /
    ``v_scale`` [P, Hkv, page] bf16 go with an int8 pool."""
    quant = _check_scales(pool_k, pool_v, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool_k, pool_v, page_table, seq_lens, scale, softcap=softcap,
            sliding_window=sliding_window, k_scale=k_scale, v_scale=v_scale)
    _check_decode(q, pool_k, pool_v, page_table, seq_lens, k_scale, v_scale)
    scales = ([k_scale], [v_scale]) if quant else (None, None)
    out, = _launch_decode([q], [pool_k], [pool_v], *scales, page_table,
                          seq_lens, scale, softcap, sliding_window)
    if quant:
        flash_paged_decode_attention.launches_int8 += 1
    else:
        flash_paged_decode_attention.launches += 1
    return out


flash_paged_decode_attention.launches = 0
flash_paged_decode_attention.launches_int8 = 0


def ragged_paged_attention(q, chunk_k, chunk_v, pool_k, pool_v, page_table,
                           q_lens, kv_lens, chunk_slot: int, scale: float,
                           softcap: float = 0.0, sliding_window: int = 0,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Unified ragged batch attention over the paged pool in one launch:
    q [B + C, H, Dh], q_lens / kv_lens [B + 1] int32, the chunk's fresh KV
    already in the pool; returns [B + C, H, Dh].  Kernel C reads the chunk's
    KV from the pool (quantized, on an int8 pool) and writes zeros on rows
    that carry no query; CPU tensors run :func:`ragged_paged_attention_ref`,
    which alone reads ``chunk_k``/``chunk_v``."""
    quant = _check_scales(pool_k, pool_v, k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, chunk_k, chunk_v, pool_k, pool_v, page_table, q_lens, kv_lens,
            chunk_slot, scale, softcap=softcap, sliding_window=sliding_window,
            k_scale=k_scale, v_scale=v_scale)
    b = page_table.shape[0]
    c = q.shape[0] - b
    h, hkv, page, np_ = _check_pool(q, pool_k, pool_v, page_table, k_scale,
                                    v_scale)
    check(c >= 0, "q has fewer rows than the page table")
    check(0 <= int(chunk_slot) < b, f"chunk_slot {chunk_slot} out of range")
    for name, x in (("q_lens", q_lens), ("kv_lens", kv_lens)):
        check(x.device == q.device and x.dtype == torch.int32
              and tuple(x.shape) == (b + 1,) and x.is_contiguous(),
              f"{name} must be int32 [B + 1] on the device")
    out = torch.empty_like(q)
    meta = (page_table.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), b, c, h, hkv, page, np_, int(chunk_slot),
            float(scale), float(softcap or 0.0), int(sliding_window),
            q.shape[2])
    if quant:
        launch("paged_attention", "ragged_paged_i8", q.device,
               q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               k_scale.data_ptr(), v_scale.data_ptr(), *meta)
        ragged_paged_attention.launches_int8 += 1
    else:
        launch("paged_attention", "ragged_paged", q.device,
               q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *meta)
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_int8 = 0


def ragged_chunk_attention_plain(q, pool_k, pool_v, pages, ctx_len, kv_len,
                                 scale: float, softcap: float = 0.0,
                                 sliding_window: int = 0, k_scale=None,
                                 v_scale=None) -> torch.Tensor:
    """The plain version of kernel E: gather the slot's pages (on an int8
    pool dequantized in fp32) and run the masked fp32 attention of chunk
    row j at position ``ctx_len + j`` over the keys ``< kv_len`` it may
    see.  The chunk's own K/V are read back from the pool, as the kernel
    reads them.  Rows ``j >= kv_len - ctx_len`` are the caller's to drop
    (here they see every key below ``kv_len``; the kernel writes zeros)."""
    c, h, dh = q.shape
    row = pages.reshape(1, -1)
    k, v = _gathered(pool_k, row)[0], _gathered(pool_v, row)[0]
    if k_scale is not None:
        k = dequantize_kv(k, _gathered_scales(k_scale, row)[0])
        v = dequantize_kv(v, _gathered_scales(v_scale, row)[0])
    hkv, w = k.shape[0], k.shape[1]
    dev = q.device
    ctx = torch.as_tensor(ctx_len, device=dev).reshape(())
    kv = torch.as_tensor(kv_len, device=dev).reshape(())
    qpos = (ctx + torch.arange(c, device=dev))[:, None]   # [C, 1]
    kpos = torch.arange(w, device=dev)[None, :]            # [1, W]
    mask = (kpos < kv) & (kpos <= qpos) & _window_ok(kpos, qpos,
                                                    int(sliding_window))
    qg = q.reshape(c, hkv, h // hkv, dh).float()
    logits = torch.einsum("chgd,hkd->hgck", qg, k.float()) * scale
    logits = _softcap(logits, softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    out = torch.einsum("hgck,hkd->chgd", _softmax_rows(logits), v.float())
    return out.reshape(c, h, dh).to(q.dtype)


def _check_len_scalar(name: str, x, q) -> None:
    check(isinstance(x, torch.Tensor) and x.device == q.device
          and x.dtype == torch.int32 and x.numel() == 1,
          f"{name} must be an int32 scalar tensor on the device")


def flash_ragged_chunk_attention(q, pool_k, pool_v, pages, ctx_len, kv_len,
                                 scale: float, softcap: float = 0.0,
                                 sliding_window: int = 0, k_scale=None,
                                 v_scale=None) -> torch.Tensor:
    """One prefill chunk's attention over its slot's pages: q [C, H, Dh],
    ``pages`` [NP] int32 (the slot's table row), ``ctx_len`` / ``kv_len``
    int32 scalars on the device (tokens already in the pool, and those
    plus the valid chunk rows), the chunk's own K/V already in the pool.
    Row j sees keys ``< min(kv_len, ctx_len + j + 1)``.  Returns [C, H,
    Dh]; rows past ``kv_len - ctx_len`` are the caller's to drop (kernel
    E writes zeros there).  CPU tensors run
    :func:`ragged_chunk_attention_plain`."""
    quant = _check_scales(pool_k, pool_v, k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_chunk_attention_plain(
            q, pool_k, pool_v, pages, ctx_len, kv_len, scale,
            softcap=softcap, sliding_window=sliding_window, k_scale=k_scale,
            v_scale=v_scale)
    check(pages.dim() == 1, "pages must be [NP]")
    h, hkv, page, np_ = _check_pool(q, pool_k, pool_v, pages[None], k_scale,
                                    v_scale)
    _check_len_scalar("ctx_len", ctx_len, q)
    _check_len_scalar("kv_len", kv_len, q)
    out = torch.empty_like(q)
    meta = (pages.data_ptr(), ctx_len.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), q.shape[0], h, hkv, page, np_, float(scale),
            float(softcap or 0.0), int(sliding_window), q.shape[2])
    if quant:
        launch("paged_attention", "ragged_chunk_i8", q.device,
               q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               k_scale.data_ptr(), v_scale.data_ptr(), *meta)
        flash_ragged_chunk_attention.launches_int8 += 1
    else:
        launch("paged_attention", "ragged_chunk", q.device, q.data_ptr(),
               pool_k.data_ptr(), pool_v.data_ptr(), *meta)
        flash_ragged_chunk_attention.launches += 1
    return out


flash_ragged_chunk_attention.launches = 0
flash_ragged_chunk_attention.launches_int8 = 0


def _rank_scales(k_scales, v_scales, n: int) -> list[dict]:
    if k_scales is None and v_scales is None:
        return [{} for _ in range(n)]
    check(k_scales is not None and v_scales is not None
          and len(k_scales) == len(v_scales) == n,
          "k_scales and v_scales come together, one per rank")
    return [dict(k_scale=k, v_scale=v) for k, v in zip(k_scales, v_scales)]


def paged_decode_attention_tp_plain(qs, pools_k, pools_v, page_table,
                                    seq_lens, scale: float,
                                    softcap: float = 0.0,
                                    sliding_window: int = 0, k_scales=None,
                                    v_scales=None) -> list[torch.Tensor]:
    """The plain version of kernel F: kernel B's plain version on every
    rank (the shared table and lengths moved to the rank's device)."""
    return [paged_decode_attention_plain(
        q, pk, pv, page_table.to(q.device), seq_lens.to(q.device), scale,
        softcap=softcap, sliding_window=sliding_window, **sc)
        for q, pk, pv, sc in zip(qs, pools_k, pools_v,
                                 _rank_scales(k_scales, v_scales, len(qs)))]


def flash_paged_decode_attention_tp(qs, pools_k, pools_v, page_table,
                                    seq_lens, scale: float,
                                    softcap: float = 0.0,
                                    sliding_window: int = 0, k_scales=None,
                                    v_scales=None) -> list[torch.Tensor]:
    """Paged decode on a tensor-parallel pool: per rank r, q shard
    ``qs[r]`` [B, H/tp, Dh] (kv-major heads), pools ``pools_k[r]`` /
    ``pools_v[r]`` [P, Hkv/tp, page, Dh] (and the int8 pools' scales per
    rank), table [B, NP] and ``seq_lens`` [B] shared.  Returns the per-rank
    outputs; concatenated over heads they are B's answer on the whole pool,
    bit for bit.  Over one rank it is B's launch (B's count).  Over more,
    the ranks on each device (at most :data:`MAX_RANKS`) run as one launch
    of B's grid, each counted in ``launches`` (``launches_int8``); B's
    counts do not move.  CPU tensors run
    :func:`paged_decode_attention_tp_plain`."""
    n = len(qs)
    check(n >= 1 and len(pools_k) == len(pools_v) == n,
          "one q shard and one pool pair per rank")
    scales = _rank_scales(k_scales, v_scales, n)
    kinds = {q.device.type for q in qs}
    check(len(kinds) == 1, f"ranks on mixed device types {sorted(kinds)}")
    if kinds == {"cpu"}:
        return paged_decode_attention_tp_plain(
            qs, pools_k, pools_v, page_table, seq_lens, scale,
            softcap=softcap, sliding_window=sliding_window,
            k_scales=k_scales, v_scales=v_scales)
    if n == 1:
        return [flash_paged_decode_attention(
            qs[0], pools_k[0], pools_v[0], page_table.to(qs[0].device),
            seq_lens.to(qs[0].device), scale, softcap=softcap,
            sliding_window=sliding_window, **scales[0])]
    quant = k_scales is not None
    for q, pk, pv, sc in zip(qs, pools_k, pools_v, scales):
        _check_scales(pk, pv, sc.get("k_scale"), sc.get("v_scale"))
        check(q.shape == qs[0].shape and pk.shape == pools_k[0].shape
              and pk.dtype == pools_k[0].dtype,
              "every rank's q shard and pools must have the same shapes")
    by_dev: dict[torch.device, list[int]] = {}
    for r, q in enumerate(qs):
        by_dev.setdefault(q.device, []).append(r)
    outs: list[torch.Tensor | None] = [None] * n
    for dev, ranks in by_dev.items():
        check(len(ranks) <= MAX_RANKS,
              f"at most {MAX_RANKS} ranks on one device")
        table, lens = page_table.to(dev), seq_lens.to(dev)
        for r in ranks:
            _check_decode(qs[r], pools_k[r], pools_v[r], table, lens,
                          **scales[r])
        pick = lambda xs: [xs[r] for r in ranks]  # noqa: E731
        got = _launch_decode(pick(qs), pick(pools_k), pick(pools_v),
                             pick(k_scales) if quant else None,
                             pick(v_scales) if quant else None, table, lens,
                             scale, softcap, sliding_window)
        for r, out in zip(ranks, got):
            outs[r] = out
        if quant:
            flash_paged_decode_attention_tp.launches_int8 += 1
        else:
            flash_paged_decode_attention_tp.launches += 1
    return outs


flash_paged_decode_attention_tp.launches = 0
flash_paged_decode_attention_tp.launches_int8 = 0
