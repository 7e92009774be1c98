#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``crowdllama_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, compute capability (must be 9.0) and
   ``nvidia-smi`` name/power limit;
2. build: compiles every kernel from ``crowdllama_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once; each kernel at head dims 64 and 128)
   and reports the seconds it took, each instantiation's registers and
   spills from ``ptxas -v``, and each entry's dynamic shared memory and
   blocks per SM at the serving groups (8 query heads a kv head at Dh 64,
   4 at Dh 128);
3. threefry: the port's threefry keys and bits, and its samplers on logits
   on the card (rows with tied logits too), against golden vectors
   captured from JAX (``engine/prng_golden.py``);
4. kernels, once at Dh 64 over TinyLlama's 4 kv heads and once at Dh 128
   over Llama-3-8B's 8 (A also at qwen2.5-7b's group of 7, 28 / 4 heads,
   at both): each hand-written kernel (A prefill, B paged decode, C ragged
   paged, D contiguous decode, E one prefill chunk over its slot's pages,
   F paged decode on tensor-parallel shares of the heads, and B, C, E and
   F on int8 pools with bf16 scales from ``quantize_kv``) against its
   plain PyTorch version on the same inputs — at the serving shapes
   TinyLlama-1.1B gives it, and at small shapes with softcap, a sliding
   window and all-masked rows or zero-length slots (B, B-int8, D, F and
   F-int8 also at lengths on the edges of their split-KV plan, 256 keys a
   split: 0, 1, 127, 128, 129, 256, 257 and the table's or cache's 2,048,
   with windows that leave whole splits empty, two calls equal; C and E
   also at a context that is not page-aligned, a window across a page
   boundary, a chunk that is not a multiple of a block's queries and, for
   E, a group of 7 query heads per kv head) — with times for the
   kernel, the plain version, one PyTorch SDPA call over the same
   (gathered; for int8, dequantized to bf16) inputs and the card's least
   time for the work (its bound).  F at tp 2 and 4 must equal B on the
   whole pool bit for bit;
5. engine: ``TorchEngine`` serving tinyllama-1.1b at full width (random
   weights from seed 0, default config: 8 slots, page 128, context 2048)
   to 8 concurrent greedy ``generate()`` streams — 6 short prompts, one
   prompt that repeats a served prompt's first 300 bytes (prefix cache) and
   one of ~1,500 bytes sent while the others decode (unified ragged
   prefill).  Launch counts are zeroed right before the streams are sent
   and read right after; kernels A-C must have launched, no other.  Then
   one prefill, one decode step and one ragged step run through the
   kernels and through the plain versions, and their logits must agree;
   the long prompt's TTFT is reported beside the time of each ragged step
   of a long prompt prefilled beside 3 decoding slots (and its kernel C
   time, CUDA events);
6. wire: the worker's request seam on tinyllama-1.1b (paged, bf16, the
   same seed-0 weights): the port's ``IPCServer`` on a Unix socket, a
   client speaking only the port's llama.v1 codec; a PB greedy request
   equal to a direct ``generate()``, a seeded one that repeats, a JSON
   prompt of the long prompt, a JSON embed equal to ``embed_prompts``,
   ping, status, an oversized frame (dropped, the server keeps serving);
   the golden frames of ``core/wire_golden.py``; one request streamed
   through ``handle_streaming_frames``; an IPC ``profile`` of 1 s while 4
   streams decode (the trace's top kernels and the card's busy share:
   the union of kernel intervals over the window); last ``migrate()``
   under 3 streams (MigrateFrames with their delivered tokens and chain
   hashes, the pool idle, new requests refused).  A, B and C launch, no
   other; the host us to encode and decode one frame;
7. engine_int8: the same engine with ``kv_dtype="int8"`` (int8 pools)
   and the same traffic plus a seeded sampled stream (temperature 0.8,
   seed 1234) that must repeat token for token when sent again; kernels
   A, B-int8 and C-int8 must have launched and B, C (bf16) not; one
   decode step through B-int8 must agree with its plain version; the
   ragged steps and the steady step are reported, the latter beside the
   bf16 pool's;
8. contiguous: ``TorchEngine(kv_layout="contiguous")`` on the same
   weights serves 8 concurrent streams of 32 tokens — 6 greedy short
   prompts, the seeded sampled stream and the ~1,500-byte prompt sent
   while they decode (legacy chunked admission, >= 2 chunks).  Kernels A
   and D must have launched; the seeded stream must repeat; one decode
   step through kernel D must agree with the plain version;
9. contiguous_int8: the contiguous int8 cache, 4 greedy streams of 16
   tokens, the long one in legacy chunks; its decode is the plain
   ``decode_attention_q`` (no Pallas kernel in the JAX package either),
   so only kernel A may launch;
10. engine_tp: the paged engine tensor-parallel, ``mesh_shape="2"`` with
   both ranks on the one card (``devices=[cuda:0, cuda:0]``: it proves the
   sharded math and kernel F's launches, not a tp speed-up), the paged
   phase's traffic: every stream done, 22 F launches per decode step (the
   two ranks in one grid) and no B launch, A and C per rank, step logits
   kernel vs plain within 2%
   of their scale, the share of greedy tokens equal to the one-device
   phase's, the steady step and the peak memory beside that phase's
   (peak at most 1.1x);
11. engine_tp_int8: the same on int8 pools, 3 streams of 16 tokens
   (F-int8 launches, no B-int8; C-int8 per rank), one decode step vs
   plain.

12. engine_llama: llama-3-8b at full width and depth (32 layers, Dh
   128, 32 / 8 heads, hidden 4096, vocab 128256; random bf16 weights from
   seed 0 made on the card, EOS column zeroed) on the paged main path,
   the paged phase's traffic and checks (kernels A-C at Dh 128);
13. engine_llama_int8, contiguous_llama, engine_llama_tp,
   engine_llama_tp_int8: llama-3-8b cut to 4 layers at full width on
   int8 pools (B-int8, C-int8), the contiguous layout (D), tp=2 on the
   one card (F) and tp=2 on int8 pools (F-int8), 3 streams of 16 tokens
   each, one decode step (and on bf16 paged pools a prefill and a ragged
   step) vs the plain versions; the cut is printed as ``reduced``.

Each engine phase starts once the previous engine has stopped and its
memory is freed; its peak memory is counted from before the engine loads
its weights (TinyLlama's kept on the host between phases, llama-3-8b's
made on the card for each phase), the start's peak and the serving peak
apart.  No engine path of either package runs kernel E (the
unified ragged step replaced it), so it launches only in the kernel
phase and its row's launch count is 0.
Then the ``kernels`` line (a row per kernel and head dim, the Dh-128
rows named ``<symbol>_dh128`` with the llama phases' launches), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: non-zero exit and
no last line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import gc
import json
import struct
import subprocess
import sys
import time

import torch

# H100 SXM dense bf16 (data sheet, 700 W).  Also the operations bound of
# the int8-pool kernels: their products pair a bf16 query with int8 keys
# and values, which convert to bf16 exactly, so bf16 is their rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# At most the H100's boost clock (1.98 GHz): a sleep of this many cycles
# per second of host time lasts at least that long.
SLEEP_CYCLES_PER_S = 2e9
# Kernel vs plain on one output element: both read the same bf16 inputs and
# accumulate in fp32 in different orders, then round to bf16, so they may
# differ by one bf16 ulp of the value (2^-8 relative) plus fp32 order noise.
ATOL, RTOL = 2e-2, 1e-2
# One step's logits through the kernels vs through the plain versions:
# each of the 22 layers' attention outputs may differ by one bf16 rounding
# (above), and random-weight layers carry that noise to the logits, so the
# bound is relative to the logits' own scale: 5% of max |logit|.
LOGIT_RTOL = 0.05
# The tensor-parallel phases: 2% of max |logit| (the sharded step differs
# from the one-device one only by the order of the row-parallel sums).
LOGIT_RTOL_TP = 0.02
# tp=2 on one card holds the same weights and pools as tp=1.
TP_MEMORY_RATIO = 1.1


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``: ``iters`` calls between two CUDA
    events, queued behind a device sleep twice as long as the host took to
    issue them, so the events time the device's work back to back and not
    the host's gaps between launches (which set the time of a call that is
    faster than its own launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rows=None) -> float:
    """Max |got - want| over ``rows`` (all when None); raises beyond
    ATOL + RTOL * |want|."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > ATOL + RTOL * w.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"tolerance, max abs err {float(err.max()):.4g}")
    return float(err.max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------ kernel phase

def check_prefill(dev, gen, t: int, softcap: float, window: int,
                  masked_rows: int, timed: bool, h: int = 32, hkv: int = 4,
                  dh: int = 64) -> dict:
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import flash_prefill_attention

    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.randn((1, t, h, dh), generator=gen, **bf)
    k = torch.randn((1, hkv, t, dh), generator=gen, **bf)
    v = torch.randn((1, hkv, t, dh), generator=gen, **bf)
    pos = torch.arange(t, device=dev, dtype=torch.int32)[None]
    valid = torch.ones((1, t), device=dev, dtype=torch.bool)
    valid[:, :masked_rows] = False  # queries < masked_rows see no key
    scale = dh ** -0.5
    args = (q, k, v, pos, scale)
    kw = dict(softcap=softcap, sliding_window=window, kv_valid=valid)
    got = flash_prefill_attention(*args, **kw)
    want = prefill_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    if masked_rows and got[0, :masked_rows].abs().max() != 0:
        raise AssertionError("prefill: all-masked rows must be zero")
    err = compare(f"prefill t={t}", got[0, masked_rows:],
                  want[0, masked_rows:])
    res = {"max_abs_err": err}
    if timed:
        g = h // hkv
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        qt = q.transpose(1, 2)
        res["ms"] = time_ms(lambda: flash_prefill_attention(*args, **kw))
        res["plain_ms"] = time_ms(lambda: prefill_attention_ref(*args, **kw))
        res["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kr, vr, is_causal=True, scale=scale))
        seen = t * (t + 1) // 2  # causal (query, key) pairs per head
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, k, v, pos, valid, got), 4 * dh * h * seen)
    return res


def _paged_inputs(dev, gen, b: int, lens: list[int], page: int, np_: int,
                  pool_pages: int, hkv: int = 4, dh: int = 64):
    """A pool with distinct random pages per slot: table row i holds slot
    i's pages (the dump page, pool_pages - 1, pads every row)."""
    bf = dict(device=dev, dtype=torch.bfloat16)
    pool_k = torch.randn((pool_pages, hkv, page, dh), generator=gen, **bf)
    pool_v = torch.randn((pool_pages, hkv, page, dh), generator=gen, **bf)
    perm = torch.randperm(pool_pages - 1, generator=torch.Generator(
        ).manual_seed(b))
    table = torch.full((b, np_), pool_pages - 1, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // page)
        table[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    return pool_k, pool_v, table.to(dev)


def _sdpa_gathered(q, pool_k, pool_v, table, lens, qpos):
    """One SDPA call over each row's gathered pages (gather and head
    repeat done here, outside the timed call); q [R, H, Q, Dh]."""
    r, h = q.shape[0], q.shape[1]
    _, hkv, page, dh = pool_k.shape
    w = table.shape[1] * page
    kk = pool_k[table.long()].permute(0, 2, 1, 3, 4).reshape(r, hkv, w, dh)
    vv = pool_v[table.long()].permute(0, 2, 1, 3, 4).reshape(r, hkv, w, dh)
    kk = kk.repeat_interleave(h // hkv, 1)
    vv = vv.repeat_interleave(h // hkv, 1)
    kpos = torch.arange(w, device=q.device)
    mask = ((kpos[None, None] < lens[:, None, None])
            & (kpos[None, None] <= qpos[:, :, None]))[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, attn_mask=mask)


def _quantized(pool_k, pool_v):
    """int8 pools with their bf16 scales (``quantize_kv`` of bf16 K/V), and
    the pools dequantized to bf16 for the library call's yardstick."""
    from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    (pk8, ks), (pv8, vs) = quantize_kv(pool_k), quantize_kv(pool_v)
    deq = (dequantize_kv(pk8, ks).to(torch.bfloat16),
           dequantize_kv(pv8, vs).to(torch.bfloat16))
    return pk8, pv8, dict(k_scale=ks, v_scale=vs), deq


def _kv_token_bytes(hkv: int, dh: int, int8: bool) -> int:
    """Bytes of one live token's K and V (and their bf16 scales)."""
    return hkv * dh * 2 * (1 if int8 else 2) + (hkv * 2 * 2 if int8 else 0)


def check_decode(dev, gen, lens: list[int], softcap: float, window: int,
                 timed: bool, int8: bool = False, hkv: int = 4,
                 dh: int = 64) -> dict:
    """Kernel B (bf16 pool, or the int8 variant on a quantized pool)
    against its plain version."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        paged_decode_attention_plain,
    )

    b, h, page, np_ = len(lens), 32, 128, 16
    pool_k, pool_v, table = _paged_inputs(dev, gen, b, lens, page, np_, 129,
                                          hkv, dh)
    lib_pools, scales = (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((b, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    seq = torch.tensor(lens, device=dev, dtype=torch.int32)
    args = (q, pool_k, pool_v, table, seq, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window, **scales)
    got = flash_paged_decode_attention(*args, **kw)
    again = flash_paged_decode_attention(*args, **kw)
    want = paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("decode: two calls differ (the split merge must "
                             "read its partials in split order)")
    live = [i for i, n in enumerate(lens) if n > 0]
    dead = [i for i, n in enumerate(lens) if n == 0]
    if dead and got[dead].abs().max() != 0:
        raise AssertionError("decode: a zero-length slot must output zeros")
    res = {"max_abs_err": compare("decode", got, want, live)}
    if timed:
        res["ms"] = time_ms(lambda: flash_paged_decode_attention(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: paged_decode_attention_plain(*args, **kw))
        res["library_ms"] = time_ms(_sdpa_gathered(
            q[:, :, None], *lib_pools, table, seq, (seq - 1)[:, None]))
        kv = sum(lens) * _kv_token_bytes(hkv, dh, int8)  # live tokens only
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, table, seq, got) + kv, 4 * dh * h * sum(lens))
    return res


def check_ragged(dev, gen, dec_lens: list[int], chunk_slot: int, ctx: int,
                 c: int, valid: int, softcap: float, window: int,
                 timed: bool, int8: bool = False, hkv: int = 4,
                 dh: int = 64) -> dict:
    """Kernel C (bf16 pool, or the int8 variant) against its plain version.
    The kernel reads the chunk's KV back from the pool, so on an int8 pool
    the plain version is fed the chunk rows as the pool holds them
    (dequantized in fp32); the gap to the plain version fed the fresh
    bf16 rows (what the engine's CPU path does) is reported apart."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        ragged_paged_attention,
        ragged_paged_attention_ref,
    )
    from crowdllama_tpu_torch.ops.quant import dequantize_kv

    b, h, page, np_ = len(dec_lens), 32, 128, 16
    lens = list(dec_lens)
    lens[chunk_slot] = ctx + valid  # the chunk slot's pages hold ctx+chunk
    pool_k, pool_v, table = _paged_inputs(dev, gen, b, lens, page, np_, 129,
                                          hkv, dh)
    fresh_pools, lib_pools, scales = (pool_k, pool_v), (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((b + c, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    q_lens = [1 if n > 0 else 0 for n in dec_lens] + [valid]
    q_lens[chunk_slot] = 0  # the reserved slot does not decode
    kv_lens = [max(n, 1) for n in dec_lens] + [ctx + valid]
    # The chunk's fresh KV, carved back out of the pool where the engine
    # has already written it (the plain version reads it as operands).
    cpos = (ctx + torch.arange(c, device=dev)).clamp(max=ctx + valid - 1)
    cpages = table[chunk_slot, (cpos // page).long()].long()
    co = cpos % page

    def rows(pool, sc=None):
        x = pool[cpages, :, co]
        if sc is not None:
            x = dequantize_kv(x, sc[cpages, :, co])
        return x.transpose(0, 1)[None].contiguous()

    chunk_k = rows(pool_k, scales.get("k_scale"))
    chunk_v = rows(pool_v, scales.get("v_scale"))
    ql = torch.tensor(q_lens, device=dev, dtype=torch.int32)
    kl = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    tail = (pool_k, pool_v, table, ql, kl, chunk_slot, dh ** -0.5)
    args = (q, chunk_k, chunk_v, *tail)
    kw = dict(softcap=softcap, sliding_window=window, **scales)
    got = ragged_paged_attention(*args, **kw)
    want = ragged_paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    live = [i for i in range(b) if q_lens[i]] + [b + i for i in range(valid)]
    dead = [i for i in range(b) if not q_lens[i]] + [
        b + i for i in range(valid, c)]
    if dead and got[dead].abs().max() != 0:
        raise AssertionError("ragged: rows without a query must be zeros")
    res = {"max_abs_err": compare("ragged", got, want, live)}
    if int8:
        fresh = ragged_paged_attention_ref(
            q, rows(fresh_pools[0]), rows(fresh_pools[1]), *tail, **kw)
        res["fresh_kv_gap"] = float((got[live].float()
                                     - fresh[live].float()).abs().max())
    if timed:
        res["ms"] = time_ms(lambda: ragged_paged_attention(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: ragged_paged_attention_ref(*args, **kw))
        # One padded SDPA call: row b..b+? -> [B+1, H, C, Dh] queries.
        qq = torch.zeros((b + 1, h, c, dh), device=dev, dtype=torch.bfloat16)
        qq[:b, :, 0] = q[:b]
        qq[b] = q[b:].transpose(0, 1)
        tab = torch.cat([table, table[chunk_slot][None]])
        qpos = torch.zeros((b + 1, c), device=dev, dtype=torch.int64)
        qpos[:b, 0] = kl[:b] - 1
        qpos[b] = cpos
        res["library_ms"] = time_ms(_sdpa_gathered(qq, *lib_pools, tab, kl,
                                                   qpos))
        dec = [kv_lens[i] for i in range(b) if q_lens[i]]
        seen = sum(dec) + sum(ctx + r + 1 for r in range(valid))
        kv_tokens = sum(dec) + ctx + valid
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, ql, kl, table, got)
            + kv_tokens * _kv_token_bytes(hkv, dh, int8), 4 * dh * h * seen)
    return res


def check_flash_decode(dev, gen, lens: list[int], s: int, softcap: float,
                       window: int, timed: bool, hkv: int = 4,
                       dh: int = 64) -> dict:
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    b, h = len(lens), 32
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.randn((b, h, dh), generator=gen, **bf)
    kc = torch.randn((b, hkv, s, dh), generator=gen, **bf)
    vc = torch.randn((b, hkv, s, dh), generator=gen, **bf)
    seq = torch.tensor(lens, device=dev, dtype=torch.int32)
    args = (q, kc, vc, seq, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_decode_attention(*args, **kw)
    again = flash_decode_attention(*args, **kw)
    want = decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("flash decode: two calls differ (the split "
                             "merge must read its partials in split order)")
    live = [i for i, n in enumerate(lens) if n > 0]
    dead = [i for i, n in enumerate(lens) if n == 0]
    if dead and got[dead].abs().max() != 0:
        raise AssertionError("flash decode: a zero-length slot must output "
                             "zeros")
    res = {"max_abs_err": compare("flash decode", got, want, live)}
    if timed:
        res["ms"] = time_ms(lambda: flash_decode_attention(*args, **kw))
        res["plain_ms"] = time_ms(lambda: decode_attention_plain(*args, **kw))
        # One SDPA call over the same cache, heads repeated and the length
        # mask built beforehand (outside the timing).
        kr, vr = kc.repeat_interleave(h // hkv, 1), vc.repeat_interleave(
            h // hkv, 1)
        mask = (torch.arange(s, device=dev)[None] < seq[:, None])[:, None,
                                                                   None]
        res["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kr, vr, attn_mask=mask))
        kv = sum(lens) * hkv * dh * 2 * 2  # live K and V rows, bf16
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, seq, got) + kv, 4 * dh * h * sum(lens))
    return res


def check_chunk(dev, gen, ctx: int, c: int, valid: int, softcap: float,
                window: int, timed: bool, int8: bool = False,
                h: int = 32, hkv: int = 4, dh: int = 64) -> dict:
    """Kernel E (bf16 pool, or the int8 variant) against its plain version:
    a chunk of ``c`` rows (``valid`` carry a query) at context ``ctx`` over
    its slot's pages, which hold ctx + valid tokens; ``h`` query heads over
    ``hkv`` kv heads."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_ragged_chunk_attention,
        ragged_chunk_attention_plain,
    )

    page, np_ = 128, 16
    pool_k, pool_v, table = _paged_inputs(dev, gen, 1, [ctx + valid], page,
                                          np_, 129, hkv, dh)
    lib_pools, scales = (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((c, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    i32 = dict(device=dev, dtype=torch.int32)
    ctx_t, kv_t = torch.tensor(ctx, **i32), torch.tensor(ctx + valid, **i32)
    args = (q, pool_k, pool_v, table[0], ctx_t, kv_t, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window, **scales)
    got = flash_ragged_chunk_attention(*args, **kw)
    want = ragged_chunk_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    if valid < c and got[valid:].abs().max() != 0:
        raise AssertionError("chunk: rows past the valid ones must be zeros")
    res = {"max_abs_err": compare(f"chunk ctx={ctx}", got[:valid],
                                  want[:valid])}
    if timed:
        res["ms"] = time_ms(lambda: flash_ragged_chunk_attention(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: ragged_chunk_attention_plain(*args, **kw))
        qpos = (ctx + torch.arange(c, device=dev))[None]
        res["library_ms"] = time_ms(_sdpa_gathered(
            q.transpose(0, 1)[None], *lib_pools, table, kv_t[None], qpos))
        seen = sum(ctx + r + 1 for r in range(valid))
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, table[0], ctx_t, kv_t, got)
            + (ctx + valid) * _kv_token_bytes(hkv, dh, int8),
            4 * dh * h * seen)
    return res


def check_tp_decode(dev, gen, lens: list[int], tp: int, softcap: float,
                    window: int, timed: bool, int8: bool = False,
                    hkv: int = 4, dh: int = 64) -> dict:
    """Kernel F on tp shares of B's inputs (q heads and pool kv heads,
    kv-major): every rank's output must equal B's on the whole pool bit
    for bit, and F is held against its plain version."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        flash_paged_decode_attention_tp,
        paged_decode_attention_tp_plain,
    )

    b, h, page, np_ = len(lens), 32, 128, 16
    pool_k, pool_v, table = _paged_inputs(dev, gen, b, lens, page, np_, 129,
                                          hkv, dh)
    lib_pools, scales = (pool_k, pool_v), {}
    if int8:
        pool_k, pool_v, scales, lib_pools = _quantized(pool_k, pool_v)
    q = torch.randn((b, h, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    seq = torch.tensor(lens, device=dev, dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    whole = flash_paged_decode_attention(q, pool_k, pool_v, table, seq,
                                         dh ** -0.5, **kw, **scales)

    def cut(x):
        return [part.contiguous() for part in x.chunk(tp, dim=1)]

    args = (cut(q), cut(pool_k), cut(pool_v), table, seq, dh ** -0.5)
    kw.update({f"{k}s": cut(v) for k, v in scales.items()})
    before = _launches()
    got = torch.cat(flash_paged_decode_attention_tp(*args, **kw), dim=1)
    moved = {k: n - before[k] for k, n in _launches().items()
             if n != before[k]}
    if moved != {"F_int8" if int8 else "F": 1}:
        raise AssertionError(f"tp decode (tp={tp}) on one card must be one "
                             f"F launch and nothing else: {moved}")
    want = torch.cat(paged_decode_attention_tp_plain(*args, **kw), dim=1)
    torch.cuda.synchronize()
    if not torch.equal(got, whole):
        raise AssertionError(f"tp decode (tp={tp}) differs from kernel B on "
                             f"the whole pool")
    live = [i for i, n in enumerate(lens) if n > 0]
    res = {"max_abs_err": compare(f"tp decode tp={tp}", got, want, live),
           "equal_to_B": True}
    if timed:
        res["ms"] = time_ms(
            lambda: flash_paged_decode_attention_tp(*args, **kw))
        res["plain_ms"] = time_ms(
            lambda: paged_decode_attention_tp_plain(*args, **kw))
        res["library_ms"] = time_ms(_sdpa_gathered(
            q[:, :, None], *lib_pools, table, seq, (seq - 1)[:, None]))
        kv = sum(lens) * _kv_token_bytes(hkv, dh, int8)  # live tokens only
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes(q, table, seq, got) + kv, 4 * dh * h * sum(lens))
    return res


# Lengths on the edges of the split plan of kernels B and D at the serving
# table (16 pages of 128: splits of 2 pages, 256 keys) and cache (2,048
# keys, splits of 256): an empty slot, one key, a page less one, a page, a
# page and one, one split, one split and one key, the whole table.  Cases (softcap, window): none; a window of 40 (the
# 2,048-token slot's keys in its last split only, 7 splits empty); softcap
# and a window of 300 (first key 1,748: 6 splits empty, 2 merged).
SPLIT_EDGE_LENS = [0, 1, 127, 128, 129, 256, 257, 2048]
SPLIT_EDGE_CASES = [(0.0, 0), (0.0, 40), (30.0, 300)]


def kernel_checks(dev, gen, hkv: int, dh: int) -> dict:
    """Every kernel against its plain version at head dim ``dh`` over
    ``hkv`` kv heads (32 query heads; TinyLlama's 4 at Dh 64, Llama-3-8B's
    8 at Dh 128): the serving shapes timed, then the small shapes."""
    d = dict(hkv=hkv, dh=dh)
    out = {}
    a = check_prefill(dev, gen, 512, 0.0, 0, 0, timed=True, **d)
    a["small"] = [check_prefill(dev, gen, 64, 30.0, 9, 5, False, **d)
                  ["max_abs_err"],
                  check_prefill(dev, gen, 96, 0.0, 17, 0, False, **d)
                  ["max_abs_err"]]
    out["A"] = a
    serve_lens = [1723, 1, 402, 2048, 77, 1200, 513, 960]
    for key, int8 in (("B", False), ("B_int8", True)):
        bres = check_decode(dev, gen, serve_lens, 0.0, 0, timed=True,
                            int8=int8, **d)
        bres["small"] = [
            check_decode(dev, gen, [0, 5, 300, 129], 30.0, 0, False,
                         int8=int8, **d)["max_abs_err"],
            check_decode(dev, gen, [260, 1, 0, 64], 0.0, 40, False,
                         int8=int8, **d)["max_abs_err"]]
        bres["split_edges"] = [
            check_decode(dev, gen, SPLIT_EDGE_LENS, sc, win, False,
                         int8=int8, **d)["max_abs_err"]
            for sc, win in SPLIT_EDGE_CASES]
        out[key] = bres
    ragged_serve = ([1723, 1, 402, 0, 77, 1200, 0, 960], 3, 1024, 512, 512,
                    0.0, 0)
    ragged_small = [([40, 0, 300, 0], 3, 256, 96, 70, 30.0, 0),
                    ([40, 130, 0, 9], 2, 128, 64, 64, 0.0, 33),
                    ([40, 0, 300, 0], 3, 200, 75, 61, 30.0, 100)]
    for key, int8 in (("C", False), ("C_int8", True)):
        cres = check_ragged(dev, gen, *ragged_serve, timed=True, int8=int8,
                            **d)
        small = [check_ragged(dev, gen, *a, timed=False, int8=int8, **d)
                 for a in ragged_small]
        cres["small"] = [r["max_abs_err"] for r in small]
        if int8:
            cres["small_fresh_kv_gap"] = [r["fresh_kv_gap"] for r in small]
        out[key] = cres
    dres = check_flash_decode(dev, gen, serve_lens, 2048, 0.0, 0, timed=True,
                              **d)
    dres["small"] = [check_flash_decode(dev, gen, [0, 5, 300, 129], 300,
                                        30.0, 0, False, **d)["max_abs_err"],
                     check_flash_decode(dev, gen, [260, 1, 0, 64], 300, 0.0,
                                        40, False, **d)["max_abs_err"]]
    dres["split_edges"] = [
        check_flash_decode(dev, gen, SPLIT_EDGE_LENS, 2048, sc, win, False,
                           **d)["max_abs_err"]
        for sc, win in SPLIT_EDGE_CASES]
    out["D"] = dres
    for key, int8 in (("E", False), ("E_int8", True)):
        eres = check_chunk(dev, gen, 1024, 512, 512, 0.0, 0, timed=True,
                           int8=int8, **d)
        eres["small"] = [
            check_chunk(dev, gen, 256, 96, 70, 30.0, 0, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 128, 80, 77, 0.0, 33, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 0, 64, 64, 0.0, 0, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 200, 75, 60, 30.0, 100, False,
                        int8=int8, **d)["max_abs_err"],
            check_chunk(dev, gen, 200, 75, 61, 0.0, 100, False, int8=int8,
                        h=7 * hkv, **d)["max_abs_err"]]
        out[key] = eres
    for key, int8 in (("F", False), ("F_int8", True)):
        fres = check_tp_decode(dev, gen, serve_lens, 2, 0.0, 0, timed=True,
                               int8=int8, **d)
        fres["tp4"] = check_tp_decode(dev, gen, serve_lens, 4, 0.0, 0,
                                      False, int8=int8, **d)["max_abs_err"]
        fres["small"] = [
            check_tp_decode(dev, gen, [0, 5, 300, 129], 2, 30.0, 0, False,
                            int8=int8, **d)["max_abs_err"],
            check_tp_decode(dev, gen, [260, 1, 0, 64], 4, 0.0, 40, False,
                            int8=int8, **d)["max_abs_err"]]
        fres["split_edges"] = [
            check_tp_decode(dev, gen, SPLIT_EDGE_LENS, tp, sc, win, False,
                            int8=int8, **d)["max_abs_err"]
            for tp, (sc, win) in zip((2, 4, 2), SPLIT_EDGE_CASES)]
        out[key] = fres
    return out


def kernel_phase(dev) -> dict:
    """The kernel checks at Dh 64 (TinyLlama) and at Dh 128 (Llama-3-8B),
    a line each, then kernel A at a group of 7 (qwen2.5-7b's 28 query / 4
    kv heads: 18 queries a block, its last two rows empty) at both; returns
    the rows keyed by kernel, ``_dh128`` appended at Dh 128."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dh, hkv in ((64, 4), (128, 8)):
        res = kernel_checks(dev, gen, hkv, dh)
        emit({"phase": "kernels_vs_plain", "head_dim": dh, "kv_heads": hkv,
              "tolerance": {"atol": ATOL, "rtol": RTOL}, **res})
        out.update({k + ("" if dh == 64 else "_dh128"): v
                    for k, v in res.items()})
    group7 = {dh: [check_prefill(dev, gen, 512, 0.0, 0, 0, False, h=28,
                                 dh=dh)["max_abs_err"],
                   check_prefill(dev, gen, 96, 30.0, 17, 5, False, h=28,
                                 dh=dh)["max_abs_err"]] for dh in (64, 128)}
    emit({"phase": "kernel_A_group7", "heads": [28, 4],
          "max_abs_err": group7})
    return out


# ------------------------------------------------------------ engine phases

TINYLLAMA = "tinyllama-1.1b"
LLAMA = "llama-3-8b"
# Depth of the llama-3-8b phases beside the full-depth paged one.
LLAMA_CUT_LAYERS = 4

SHORT = [
    "The swarm routes each request to a worker that holds the model. " * 6,
    "Paged attention keeps the KV cache in fixed pages shared by slots. " * 4,
    "Hopper kernels read pages straight from the pool through the table.",
    "A continuous batch admits new requests while others are decoding. " * 3,
    "Prefix caching reuses the pages of a prompt that was served before. " * 5,
    "Greedy decoding takes the argmax of the logits at every step. " * 2,
]
HIT = SHORT[0][:300] + " and a different tail that only this request sends."
LONG = ("Long prompts are prefilled in chunks inside the decode dispatch, "
        "so the other streams keep emitting tokens while it runs. ") * 12
SAMPLED = ("A seeded sampled stream draws its tokens from threefry keys.",
           dict(temperature=0.8, seed=1234))
GREEDY = {f"short{i}": (p, {}) for i, p in enumerate(SHORT)}

# The token ids a stream received, per asyncio task (see _IdRecorder).
_STREAM_IDS: contextvars.ContextVar = contextvars.ContextVar("stream_ids",
                                                             default=None)


class _IdRecorder:
    """Tokenizer proxy: each stream's decoder appends the token ids it is
    fed to the list its task set in ``_STREAM_IDS``."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), _STREAM_IDS.get()

        class _Dec:
            def feed(self, token_id):
                if ids is not None:
                    ids.append(int(token_id))
                return dec.feed(token_id)

        return _Dec()


def _counters() -> dict:
    """Kernel row -> (wrapper, its launch-count attribute)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        flash_decode_attention,
        flash_prefill_attention,
    )
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention,
        flash_paged_decode_attention_tp,
        flash_ragged_chunk_attention,
        ragged_paged_attention,
    )

    return {"A": (flash_prefill_attention, "launches"),
            "B": (flash_paged_decode_attention, "launches"),
            "B_int8": (flash_paged_decode_attention, "launches_int8"),
            "C": (ragged_paged_attention, "launches"),
            "C_int8": (ragged_paged_attention, "launches_int8"),
            "D": (flash_decode_attention, "launches"),
            "E": (flash_ragged_chunk_attention, "launches"),
            "E_int8": (flash_ragged_chunk_attention, "launches_int8"),
            "F": (flash_paged_decode_attention_tp, "launches"),
            "F_int8": (flash_paged_decode_attention_tp, "launches_int8")}


def _zero_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


async def serve(engine, streams: dict, max_tokens: int,
                again: str | None = None) -> dict:
    """Send ``streams`` (name -> (prompt, generate kwargs)) at once, then
    LONG once the others are decoding, then stream ``again`` alone a second
    time (as ``<again>_again``)."""
    results: dict[str, dict] = {}

    async def run(name: str, prompt: str, kw: dict) -> None:
        ids: list[int] = []
        _STREAM_IDS.set(ids)
        t0 = time.perf_counter()
        final = None
        async for chunk in engine.generate(prompt, max_tokens=max_tokens,
                                           **kw):
            final = chunk
        results[name] = {"done": final.done, "reason": final.done_reason,
                         "completion_tokens": final.completion_tokens,
                         "prompt_tokens": final.prompt_tokens,
                         "ttft_ms": (final.queue_ns + final.prefill_ns) / 1e6,
                         "wall_s": time.perf_counter() - t0, "ids": ids}

    t0 = time.perf_counter()
    tasks = [asyncio.create_task(run(n, p, kw))
             for n, (p, kw) in streams.items()]
    while (engine.scheduler.tokens_generated < 8
           and not all(t.done() for t in tasks)):
        await asyncio.sleep(0.005)
    tasks.append(asyncio.create_task(run("long", LONG, {})))
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t0
    if again:
        await run(f"{again}_again", *streams[again])
    return {"requests": results, "wall_s": wall}


def run_engine(dev, streams: dict, max_tokens: int, again: str | None = None,
               params: dict | None = None, **engine_kw):
    """Reset the card's peak-memory mark, start ``TorchEngine`` on
    ``params`` (default: TinyLlama's seed-0 weights) (on ``dev``, or on the
    tp ranks ``devices`` in
    ``engine_kw`` names), zero every launch count, serve the traffic, read
    the counts, stop.  The card's memory is read at four points: what was
    allocated before the engine, the peak while it started (loading and
    warm-up), what stayed allocated after that, and the peak while it
    served; ``max_memory_allocated`` is the larger peak.  Checks that every stream ended done with
    ``max_tokens`` tokens and that a seeded stream sent again repeated
    token for token."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    if "devices" not in engine_kw:
        engine_kw["device"] = dev

    async def go():
        weights = seed0_params(dev) if params is None else params
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        memory = {"before_start": torch.cuda.memory_allocated(dev)}
        engine = TorchEngine(params=weights, **engine_kw)
        t0 = time.perf_counter()
        await engine.start()
        start_s = time.perf_counter() - t0
        engine.tokenizer = _IdRecorder(engine.tokenizer)
        try:
            memory.update(start_peak=torch.cuda.max_memory_allocated(dev),
                          after_start=torch.cuda.memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
            hits0 = getattr(engine.runner, "prefix_hits", 0)
            _zero_launches()
            served = await serve(engine, streams, max_tokens, again)
            launches = _launches()
            memory["serve_peak"] = torch.cuda.max_memory_allocated(dev)
            hits = getattr(engine.runner, "prefix_hits", 0) - hits0
        finally:
            await engine.stop()
        return engine, start_s, served, launches, hits, memory

    engine, start_s, served, launches, hits, memory = asyncio.run(go())
    reqs = served["requests"]
    for name, v in reqs.items():
        if not (v["done"] and v["completion_tokens"] == max_tokens
                and len(v["ids"]) == max_tokens):
            raise AssertionError(f"stream {name} ended "
                                 f"{ {k: x for k, x in v.items() if k != 'ids'} }")
    if again and reqs[again]["ids"] != reqs[f"{again}_again"]["ids"]:
        raise AssertionError(f"the seeded stream {again} did not repeat: "
                             f"{reqs[again]['ids']} vs "
                             f"{reqs[again + '_again']['ids']}")
    ttft = sorted(v["ttft_ms"] for k, v in reqs.items()
                  if not k.endswith("_again"))
    tokens = sum(v["completion_tokens"] for k, v in reqs.items()
                 if not k.endswith("_again"))
    summary = {"start_s": start_s, "wall_s": served["wall_s"],
               "completion_tokens": tokens,
               "tokens_per_s": tokens / served["wall_s"],
               "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
               "launches": launches, "prefix_hits": hits,
               "max_memory_allocated": max(memory["start_peak"],
                                           memory["serve_peak"]),
               "memory": memory,
               "requests": {k: {x: y for x, y in v.items() if x != "ids"}
                            for k, v in reqs.items()}}
    return engine, summary, reqs


def _expect_launches(launches: dict, ran: set[str], phase: str) -> None:
    """Kernels in ``ran`` launched in the phase's streams; no other did."""
    for k, n in launches.items():
        if (n > 0) != (k in ran):
            raise AssertionError(f"{phase}: kernel {k} launched {n} times "
                                 f"(expected {'> 0' if k in ran else 0}): "
                                 f"{launches}")


def _logit_err(kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    """Max |kernel - plain|, the plain logits' max |logit| and the share of
    rows whose argmax agrees."""
    return {"max_abs_err": float((kernel - plain).abs().max()),
            "scale": float(plain.abs().max()),
            "argmax_agree": float((kernel.argmax(-1) == plain.argmax(-1))
                                  .float().mean())}


def _check_logit_errs(errs: dict, phase: str) -> dict:
    for k, e in errs.items():
        if not e["max_abs_err"] <= LOGIT_RTOL * e["scale"]:
            raise AssertionError(f"{phase} {k} logits: kernel vs plain {e}")
    return errs


def _three_slots(r, tok):
    st = r.init_state()
    for slot, p in enumerate(SHORT[:3]):
        ids = tok.encode(p)
        first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None)
        st = r.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                      prompt_tokens=ids)
    return st


def logits_check(engine, dev, ragged: bool = True) -> dict:
    """One decode step through kernel F (B's grid over every rank: its bf16
    or int8 variant, as the runner's pool is) and through its plain version
    on the same state (3 live slots); with ``ragged`` also one prefill through
    kernel A and one ragged step through kernel C, each against its plain
    version."""
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda.flash import flash_prefill_attention
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        paged_decode_attention_tp_plain,
        ragged_paged_attention,
        ragged_paged_attention_ref,
    )

    r = engine.runner
    tok = engine.tokenizer
    errs = {}
    with torch.inference_mode():
        if ragged:
            ids = tok.encode(SHORT[1])
            t = r.bucket_for(len(ids))
            tokens = r._padded(ids, t)
            ar = torch.arange(t, device=dev, dtype=torch.int32)
            pos = torch.clamp(ar, max=len(ids) - 1)[None]
            valid = (ar < len(ids))[None]
            lk = T.prefill(r.params, r.cfg, tokens, pos, valid,
                           attention=flash_prefill_attention)[0]
            lp = T.prefill(r.params, r.cfg, tokens, pos, valid,
                           attention=prefill_attention_ref)[0]
            errs["prefill"] = _logit_err(lk[0, :len(ids)], lp[0, :len(ids)])

        st = _three_slots(r, tok)
        r.pre_decode_check(1)
        table = r._table()
        r.decode_attn = paged_decode_attention_tp_plain
        dp = r.decode_logits(st, table)
        r.decode_attn = flash_paged_decode_attention_tp
        dk = r.decode_logits(st, table)
        errs["decode"] = _logit_err(dk[:3], dp[:3])

        if ragged:
            long_ids = tok.encode(LONG)
            job = r.ragged_begin(long_ids, 5, st)
            chunk, ctx_arr, _, wp = r._ragged_provision(job, 1)
            table = r._table(wp)
            ctoks = torch.from_numpy(chunk[0]).to(dev)
            r.ragged_attn = ragged_paged_attention_ref
            rp, n = r.ragged_logits(st, table, len(long_ids), 5, ctx_arr[0],
                                    ctoks)
            r.ragged_attn = ragged_paged_attention
            rk, _ = r.ragged_logits(st, table, len(long_ids), 5, ctx_arr[0],
                                    ctoks)
            rows = [0, 1, 2, r.max_slots]  # live decode rows + the chunk row
            errs["ragged"] = _logit_err(rk[rows], rp[rows])
            r.ragged_abort(job)
    return errs


def _event_timed(kernel, spans: list):
    """``kernel`` wrapped to record a pair of CUDA events around each call
    into ``spans``."""
    def timed(*a, **kw):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = kernel(*a, **kw)
        ev1.record()
        spans.append((ev0, ev1))
        return out
    return timed


def decode_step_timing(engine, dev, kernel=None, steps: int = 8,
                       temperature: float = 0.0) -> dict:
    """Steady-state decode with all slots live (each sampling at
    ``temperature``): host wall time per step (ending in a synchronize)
    and, when ``kernel`` is the runner's decode attention, the GPU time it
    takes per step (its launches alone, CUDA events over the same
    steps)."""
    r = engine.runner
    tok = engine.tokenizer
    with torch.inference_mode():
        st = r.init_state()
        for slot in range(r.max_slots):
            ids = tok.encode(SHORT[slot % len(SHORT)] + str(slot))
            first, ks, vs, plen = r.prefill(ids, 0.0, 1.0, None)
            st = r.insert(st, slot, ks, vs, plen, first, temperature, 1.0,
                          prompt_tokens=ids)
        r.decode_steps(st, steps)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.decode_steps(st, steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        spans = []
        if kernel is not None:
            seam = r.decode_attn
            r.decode_attn = _event_timed(kernel, spans)
            r.decode_steps(st, steps)
            r.decode_attn = seam
            torch.cuda.synchronize()
    out = {"slots": r.max_slots, "temperature": temperature,
           "step_ms": step_ms, "tokens_per_s": r.max_slots * 1e3 / step_ms}
    if kernel is not None:
        out["kernel_ms_per_step"] = sum(a.elapsed_time(b)
                                        for a, b in spans) / steps
    return out


def ragged_step_timing(engine, kernel) -> dict:
    """A long prompt (LONG behind a new first page, so no prefix hit)
    prefilled alone through ragged steps of one chunk beside 3 live decode
    slots, as the scheduler dispatches them: host wall ms of each step
    (ending in a synchronize) and the GPU time of the step's ragged
    attention launches (``kernel``, the runner's ``ragged_attn``, CUDA
    events)."""
    r, tok = engine.runner, engine.tokenizer
    spans, step_ms = [], []
    with torch.inference_mode():
        st = _three_slots(r, tok)
        job = r.ragged_begin(tok.encode("Timed. " + LONG), 5, st)
        r.ragged_attn = _event_timed(kernel, spans)
        try:
            while not job.finished:
                r.pre_decode_check(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, st = r.ragged_step(st, job, 1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            r.ragged_attn = kernel
            r.ragged_abort(job)
    steps = len(step_ms)
    return {"chunk": r.ragged_chunk, "steps": steps, "step_ms": step_ms,
            "step_ms_mean": sum(step_ms) / steps,
            "attention_ms_per_step": sum(a.elapsed_time(b)
                                         for a, b in spans) / steps}


@functools.cache
def seed0_params(dev) -> dict:
    """TinyLlama-1.1B at full width and depth, random weights from seed 0
    (made on ``dev``, kept on the host: each engine copies them to its
    ranks, so no card holds a spare copy), with the EOS unembedding column
    zeroed so no stream stops early (every stream must run to max_tokens
    whatever batch it lands in)."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.engine.weights import init_params
    from crowdllama_tpu_torch.models.config import get_config

    params = init_params(get_config("tinyllama-1.1b"), seed=0, device=dev)
    params["lm_head"][:, ByteTokenizer.EOS] = 0

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    return host(params)


def _free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def engine_phase(dev, phase: str = "engine", model: str = TINYLLAMA,
                 params: dict | None = None) -> dict:
    """The paged engine with a bf16 pool (the default config), serving
    ``model`` (on ``params``; default TinyLlama's seed-0 weights)."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        ragged_paged_attention,
    )

    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "prefix_hit": (HIT, {})}, 32, params=params,
        model=model)
    del params
    if reqs["long"]["prompt_tokens"] <= engine.runner.ragged_chunk:
        raise AssertionError("the long prompt must exceed one ragged chunk")
    _expect_launches(summary["launches"], {"A", "B", "C"}, "paged")
    ragged_chunks = engine.scheduler.ragged_chunks
    if summary["prefix_hits"] < 1 or ragged_chunks < 1:
        raise AssertionError(f"prefix hits {summary['prefix_hits']}, ragged "
                             f"chunks {ragged_chunks}: a path was not taken")
    errs = _check_logit_errs(logits_check(engine, dev), "paged")
    ragged = ragged_step_timing(engine, ragged_paged_attention)
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    steady_sampled = decode_step_timing(engine, dev,
                                        flash_paged_decode_attention_tp,
                                        temperature=0.8)
    emit({"phase": phase, "model": model,
          "layers": engine.runner.cfg.num_layers,
          "head_dim": engine.runner.cfg.resolved_head_dim(),
          **summary, "ragged_chunks": ragged_chunks,
          "long_ttft_ms": reqs["long"]["ttft_ms"], "ragged_step": ragged,
          "logits_max_abs_err": errs, "steady_decode": steady,
          "steady_decode_sampled": steady_sampled,
          "logits_rtol": LOGIT_RTOL, "card": torch.cuda.get_device_name(0)})
    return {"launches": summary["launches"], "steady": steady,
            "ids": {k: v["ids"] for k, v in reqs.items()},
            "max_memory_allocated": summary["max_memory_allocated"]}


class _StreamLog(_IdRecorder):
    """``_IdRecorder`` that also keeps each stream decoder's token ids, in
    the order the streams started (``streams``, each a list of
    ``(host seconds, id)``), for streams served in tasks this script did
    not create (the IPC server's)."""

    def __init__(self, tok):
        super().__init__(tok)
        self.streams: list[list] = []

    def stream_decoder(self):
        dec, log = super().stream_decoder(), []
        self.streams.append(log)

        class _Dec:
            def feed(self, token_id):
                log.append((time.perf_counter(), int(token_id)))
                return dec.feed(token_id)

        return _Dec()


def _ids(log: list) -> list[int]:
    return [t for _, t in log]


def busy_share(trace_path: str, seconds: float) -> dict:
    """The card's busy share over a ``capture_profile`` window: the union
    of the trace's CUDA kernel intervals over the window's length, the
    union over the span from the first kernel's start to the last one's
    end, the 5 kernels with the most device time, and the trace's event
    count by category."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError(f"the profile {trace_path} holds no CUDA "
                             f"kernel ({len(events)} events)")
    busy, end, by_name = 0.0, -1.0, {}
    for t0, t1, name in kernels:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    span = kernels[-1][1] - kernels[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    cats: dict[str, int] = {}
    for e in events:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    return {"events_by_category": cats, "kernels": len(kernels),
            "busy_us": busy,
            "window_us": seconds * 1e6, "busy_share": busy / (seconds * 1e6),
            "kernel_span_us": span, "busy_share_of_span": busy / span,
            "top_kernels": [{"name": n, "device_us": us,
                             "launches": sum(1 for k in kernels
                                             if k[2] == n)}
                            for n, us in top]}


def codec_timing(iters: int = 2000) -> dict:
    """Host microseconds to encode one streamed GenerateResponse frame
    (``genresp_frame_bytes``) and to decode it (``wire.decode_payload``)."""
    from crowdllama_tpu_torch.core import wire
    from crowdllama_tpu_torch.core.messages import genresp_frame_bytes

    kw = dict(worker_id="worker-a", done=False, trace_id="trace-1")
    frame = genresp_frame_bytes(TINYLLAMA, " tok", **kw)
    t0 = time.perf_counter()
    for _ in range(iters):
        genresp_frame_bytes(TINYLLAMA, " tok", **kw)
    t1 = time.perf_counter()
    for _ in range(iters):
        wire.decode_payload(frame[4:])
    t2 = time.perf_counter()
    return {"frame_bytes": len(frame), "encode_us": (t1 - t0) * 1e6 / iters,
            "decode_us": (t2 - t1) * 1e6 / iters}


PROFILE_S = 1.0
WIRE_TOKENS = 32
# The client's line limit: an embed reply of two tinyllama vectors (2 x
# 2,048 floats as JSON) is longer than asyncio's default 64 KiB.
IPC_READ_LIMIT = 1 << 24


async def _ipc_pb(sock: str, msg):
    """One PB request over a new connection -> (reply, ms)."""
    from crowdllama_tpu_torch.core import wire

    reader, writer = await asyncio.open_unix_connection(
        sock, limit=IPC_READ_LIMIT)
    try:
        t0 = time.perf_counter()
        await wire.write_length_prefixed_pb(writer, msg)
        reply = await wire.read_length_prefixed_pb(reader, timeout=120)
        return reply, (time.perf_counter() - t0) * 1e3
    finally:
        writer.close()


async def _ipc_json(sock: str, obj: dict | bytes):
    """One JSON line (or raw bytes) over a new connection -> (the reply
    line parsed, or b"" when the server dropped the connection; ms)."""
    reader, writer = await asyncio.open_unix_connection(
        sock, limit=IPC_READ_LIMIT)
    try:
        data = (obj if isinstance(obj, bytes)
                else json.dumps(obj).encode() + b"\n")
        t0 = time.perf_counter()
        writer.write(data)
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), 120)
        ms = (time.perf_counter() - t0) * 1e3
        return (json.loads(line) if line else b""), ms
    finally:
        writer.close()


def wire_phase(dev) -> dict:
    """The worker's request seam on the card: the port's ``IPCServer`` on a
    Unix socket over ``TorchEngine`` (tinyllama-1.1b at full width and
    depth, paged, bf16, TinyLlama's seed-0 weights), a client speaking only
    the port's codec.  Requests one at a time on the idle engine: a PB
    GenerateRequest (greedy, 32 tokens) equal to a direct ``generate()`` of
    the same prompt, a seeded PB request (0.8, seed 1234) sent twice that
    repeats, a JSON ``prompt`` of the long prompt (kernel C), a JSON
    ``embed`` of two inputs equal to ``runner.embed_prompts`` within 1e-3
    of their scale, ``ping``, ``status`` and a frame header over the cap
    (that connection is dropped, the server keeps serving).  The golden
    frames (``core/wire_golden.py``); one request streamed through
    ``handle_streaming_frames`` (its text is the greedy reply's, the last
    frame done with 32 tokens); an IPC ``profile`` of 1 s while 4 streams
    decode (the trace's size, top kernels and the card's busy share);
    last, ``migrate()`` under 3 streams of 2-4 prompt pages: each ends in a MigrateFrame with
    its delivered tokens and chain hashes, slots and pages go idle, a new
    request is refused.  A, B and C launch, no other kernel."""
    import os
    import tempfile

    from crowdllama_tpu_torch.core import wire, wire_golden
    from crowdllama_tpu_torch.core.messages import create_generate_request
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.ipc.server import IPCServer

    golden = wire_golden.check()
    codec = codec_timing()
    greedy_prompt, (seeded_prompt, seeded_kw) = SHORT[2], SAMPLED

    async def go(tmp: str) -> dict:
        sock = os.path.join(tmp, "ipc.sock")
        engine = TorchEngine(params=seed0_params(dev), device=dev,
                             model=TINYLLAMA,
                             profile_dir=os.path.join(tmp, "profile"))
        await engine.start()
        log = _StreamLog(engine.tokenizer)
        engine.tokenizer = log
        srv = IPCServer(sock, engine)
        await srv.start()
        r, tok = engine.runner, engine.tokenizer
        out: dict = {"latency_ms": {}}
        lat = out["latency_ms"]
        try:
            _zero_launches()
            # Direct generate() on the idle engine: the reference reply.
            direct = ""
            t0 = time.perf_counter()
            async for chunk in engine.generate(greedy_prompt,
                                               max_tokens=WIRE_TOKENS):
                direct += chunk.text
            lat["direct_generate"] = (time.perf_counter() - t0) * 1e3
            direct_ids = _ids(log.streams[-1])

            reply, lat["pb_greedy"] = await _ipc_pb(
                sock, create_generate_request(TINYLLAMA, greedy_prompt,
                                              max_tokens=WIRE_TOKENS))
            gr = reply.generate_response
            if not (gr.done and gr.completion_tokens == WIRE_TOKENS
                    and gr.response == direct
                    and _ids(log.streams[-1]) == direct_ids):
                raise AssertionError(f"wire: IPC greedy reply {gr} differs "
                                     f"from generate() ({direct!r})")
            seeded = []
            for i in range(2):
                reply, lat[f"pb_seeded_{i}"] = await _ipc_pb(
                    sock, create_generate_request(
                        TINYLLAMA, seeded_prompt, max_tokens=WIRE_TOKENS,
                        **seeded_kw))
                seeded.append((reply.generate_response.response,
                               _ids(log.streams[-1])))
            if seeded[0] != seeded[1] or len(seeded[0][1]) != WIRE_TOKENS:
                raise AssertionError(f"wire: the seeded request did not "
                                     f"repeat: {seeded}")
            chunks0 = engine.scheduler.ragged_chunks
            line, lat["json_prompt_long"] = await _ipc_json(sock, {
                "type": "prompt", "text": LONG, "model": TINYLLAMA})
            if (line.get("type") != "response" or not line.get("done")
                    or engine.scheduler.ragged_chunks <= chunks0):
                raise AssertionError(f"wire: JSON prompt reply {line}")
            inputs = ["alpha beta gamma", SHORT[0]]
            line, lat["json_embed"] = await _ipc_json(sock, {
                "type": "embed", "input": inputs})
            want = r.embed_prompts([tok.encode(x) for x in inputs])
            got = torch.tensor(line["embeddings"])
            embed_err = float((got - torch.from_numpy(want)).abs().max())
            if not (got.shape == want.shape
                    and embed_err <= 1e-3 * float(abs(want).max())):
                raise AssertionError(f"wire: IPC embeddings differ from "
                                     f"embed_prompts by {embed_err}")
            pong, lat["json_ping"] = await _ipc_json(sock, {"type": "ping"})
            status, lat["json_status"] = await _ipc_json(
                sock, {"type": "status"})
            dropped, _ = await _ipc_json(
                sock, struct.pack(">I", wire.MAX_MESSAGE_SIZE + 1))
            again, _ = await _ipc_json(sock, {"type": "ping"})
            if (pong != {"type": "pong"} or status != {
                    "type": "status", "peer_id": "", "workers": []}
                    or dropped != b"" or again != {"type": "pong"}):
                raise AssertionError(f"wire: ping/status/oversized: {pong} "
                                     f"{status} {dropped!r} {again}")

            # One request streamed through handle_streaming_frames.
            t0 = time.perf_counter()
            frames, first_frame = [], None
            async for frame in engine.handle_streaming_frames(
                    create_generate_request(TINYLLAMA, greedy_prompt,
                                            max_tokens=WIRE_TOKENS,
                                            stream=True)):
                frames.append(wire.decode_payload(frame[4:]))
                first_frame = first_frame or time.perf_counter()
            first_token = log.streams[-1][0][0]
            text = "".join(f.generate_response.response for f in frames)
            last = frames[-1].generate_response
            if not (text == direct and last.done
                    and last.completion_tokens == WIRE_TOKENS):
                raise AssertionError(f"wire: streamed frames {frames}")
            out["stream"] = {"frames": len(frames),
                             "ttft_ms": (first_token - t0) * 1e3,
                             "first_frame_ms": (first_frame - t0) * 1e3,
                             "wall_ms": (time.perf_counter() - t0) * 1e3}

            # IPC profile while 4 streams decode.
            async def drive(prompt):
                async for _ in engine.generate(prompt, max_tokens=1024):
                    pass

            n0 = len(log.streams)
            tasks = [asyncio.create_task(drive(p)) for p in SHORT[:4]]
            while (len(log.streams) < n0 + 4
                   or min(len(x) for x in log.streams[n0:]) < 2):
                await asyncio.sleep(0.01)
            reply, lat["json_profile"] = await _ipc_json(sock, {
                "type": "profile", "seconds": PROFILE_S})
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if reply.get("type") != "profile":
                raise AssertionError(f"wire: profile reply {reply}")
            (trace,) = [os.path.join(reply["trace_dir"], f)
                        for f in os.listdir(reply["trace_dir"])]
            out["profile"] = {"trace": trace,
                              "trace_bytes": os.path.getsize(trace),
                              "streams": 4,
                              **busy_share(trace, PROFILE_S)}
            while any(s is not None for s in engine.scheduler.slots):
                await asyncio.sleep(0.01)

            # Migrate 3 streams once each has 4 tokens.
            free0, cached0 = len(r._free_pages), len(r._page_key)
            prompts = [SHORT[0], SHORT[1], SHORT[4]]  # 2-4 pages each
            streams: dict[int, list] = {}
            ids: dict[int, list] = {}

            async def frames_of(i, prompt):
                ids[i] = []
                _STREAM_IDS.set(ids[i])
                msg = create_generate_request(TINYLLAMA, prompt,
                                              max_tokens=1024)
                msg.trace_id = f"migrate-{i}"
                streams[i] = [wire.decode_payload(f[4:]) async for f in
                              engine.handle_streaming_frames(msg, "worker")]

            tasks = [asyncio.create_task(frames_of(i, p))
                     for i, p in enumerate(prompts)]
            while len(ids) < 3 or min(len(v) for v in ids.values()) < 4:
                await asyncio.sleep(0.005)
            moved = await engine.migrate()
            await asyncio.wait_for(asyncio.gather(*tasks), 60)
            for i, prompt in enumerate(prompts):
                last = streams[i][-1]
                mf = last.migrate_frame
                want_keys = r.chain_keys_for_prompt(tok.encode(prompt))
                if not (last.WhichOneof("message") == "migrate_frame"
                        and mf.delivered_tokens == len(ids[i])
                        and list(mf.chain_hashes) == want_keys
                        and len(want_keys) >= 2
                        and mf.page_size == r.page_size
                        and last.trace_id == f"migrate-{i}"):
                    raise AssertionError(f"wire: stream {i} ended {last} "
                                         f"after {len(ids[i])} tokens")
            idle = (all(s is None for s in engine.scheduler.slots)
                    and not r._slot_pages
                    and len(set(r._free_pages) | set(r._page_key))
                    == r.total_pages)
            refused, _ = await _ipc_json(sock, {"type": "prompt",
                                                "text": "x"})
            if not (moved == 3 and idle and refused == {
                    "type": "error",
                    "error": "worker is draining for shutdown"}):
                raise AssertionError(f"wire: migrate moved {moved}, idle "
                                     f"{idle}, then {refused}")
            out["migrate"] = {
                "moved": moved,
                "delivered_tokens": [len(ids[i]) for i in range(3)],
                "chain_hashes": [len(streams[i][-1].migrate_frame
                                     .chain_hashes) for i in range(3)],
                "free_pages": [free0, len(r._free_pages)],
                "cached_pages": [cached0, len(r._page_key)],
                "total_pages": r.total_pages}
            out["launches"] = _launches()
            out["embed_max_abs_err"] = embed_err
            out["greedy_ids"] = len(direct_ids)
            out["ragged_chunks"] = engine.scheduler.ragged_chunks - chunks0
        finally:
            await srv.stop()
            await engine.stop()
        return out

    with tempfile.TemporaryDirectory(prefix="cs") as tmp:
        if len(os.path.join(tmp, "ipc.sock")) > 100:
            raise SystemExit(f"chip_smoke: socket path under {tmp} too long")
        out = asyncio.run(go(tmp))
    _expect_launches(out["launches"], {"A", "B", "C"}, "wire")
    smi = nvidia_smi()
    emit({"phase": "wire", "model": TINYLLAMA, "golden": golden,
          "codec": codec, **out,
          "card": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return out


def _expect_tp_launches(launches: dict, tp: int, int8: bool,
                        phase: str, layers: int = 22) -> int:
    """Per decode step one F launch per layer (the ranks on the one card
    in one grid) and no B launch; A and C (its int8 variant on int8 pools)
    once per layer per rank.  Returns the decode steps the phase ran."""
    sfx = "_int8" if int8 else ""
    f, b = launches["F" + sfx], launches["B" + sfx]
    a, c = launches["A"], launches["C" + sfx]
    if not (f > 0 and f % layers == 0 and b == 0 and a > 0
            and a % (layers * tp) == 0 and c > 0
            and c % (layers * tp) == 0):
        raise AssertionError(f"{phase}: launches {launches} are not "
                             f"{layers} F launches and no B launch per "
                             f"decode step, with A and C per rank")
    return f // layers


def _greedy_share(ids: dict, reqs: dict) -> float:
    same = [a == b for name, x in ids.items()
            if name in reqs and name != "sampled"
            for a, b in zip(x, reqs[name]["ids"])]
    return sum(same) / len(same)


def tp_phase(dev, paged: dict) -> dict:
    """The paged engine at tp=2 with both ranks on the one card, the paged
    phase's traffic: kernel F decodes (both ranks in one launch of B's
    grid), A and C run per rank."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    tp = 2
    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "prefix_hit": (HIT, {})}, 32, mesh_shape=str(tp),
        devices=[dev, dev])
    r = engine.runner
    if r.tp != tp or r.devices != [dev, dev]:
        raise AssertionError(f"tp engine runs tp={r.tp} on {r.devices}")
    if reqs["long"]["prompt_tokens"] <= r.ragged_chunk:
        raise AssertionError("the long prompt must exceed one ragged chunk")
    _expect_launches(summary["launches"], {"A", "C", "F"}, "tp")
    steps = _expect_tp_launches(summary["launches"], tp, False, "tp")
    ragged_chunks = engine.scheduler.ragged_chunks
    if summary["prefix_hits"] < 1 or ragged_chunks < 1:
        raise AssertionError(f"prefix hits {summary['prefix_hits']}, ragged "
                             f"chunks {ragged_chunks}: a path was not taken")
    errs = logits_check(engine, dev)
    for k, e in errs.items():
        if not e["max_abs_err"] <= LOGIT_RTOL_TP * e["scale"]:
            raise AssertionError(f"tp {k} logits: kernel vs plain {e}")
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    peak, peak1 = summary["max_memory_allocated"], paged[
        "max_memory_allocated"]
    if peak > TP_MEMORY_RATIO * peak1:
        raise AssertionError(f"tp={tp} peak memory {peak} B above "
                             f"{TP_MEMORY_RATIO}x tp=1's {peak1} B")
    emit({"phase": "engine_tp", "model": "tinyllama-1.1b", "layers": 22,
          "tp": r.tp, "devices": [str(d) for d in r.devices], **summary,
          "decode_steps": steps, "ragged_chunks": ragged_chunks,
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL_TP,
          "greedy_tokens_equal_to_tp1": _greedy_share(paged["ids"], reqs),
          "steady_decode": steady, "tp1_steady_decode": paged["steady"],
          "tp1_max_memory_allocated": peak1,
          "memory_ratio_to_tp1": peak / peak1,
          "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


def tp_int8_phase(dev) -> dict:
    """The tensor-parallel engine on int8 pools: 3 streams of 16 tokens
    (2 short, the long one through the ragged step), F-int8 decodes and
    C-int8 runs per rank; one decode step through F-int8 vs plain."""
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1")}, 16,
        mesh_shape="2", devices=[dev, dev], kv_dtype="int8")
    _expect_launches(summary["launches"], {"A", "C_int8", "F_int8"},
                     "tp int8")
    steps = _expect_tp_launches(summary["launches"], 2, True, "tp int8")
    errs = logits_check(engine, dev, ragged=False)
    for k, e in errs.items():
        if not e["max_abs_err"] <= LOGIT_RTOL_TP * e["scale"]:
            raise AssertionError(f"tp int8 {k} logits: kernel vs plain {e}")
    emit({"phase": "engine_tp_int8", "model": "tinyllama-1.1b", "layers": 22,
          "tp": engine.runner.tp, "kv_dtype": "int8", **summary,
          "decode_steps": steps, "logits_max_abs_err": errs,
          "logits_rtol": LOGIT_RTOL_TP,
          "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


def int8_paged_phase(dev, bf16: dict) -> dict:
    """The paged engine on int8 pools (``kv_dtype="int8"``), the bf16
    paged phase's traffic plus one seeded sampled stream sent twice:
    kernels A, B-int8 and C-int8 launch, the bf16 variants do not."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
        ragged_paged_attention,
    )

    streams = {**GREEDY, "prefix_hit": (HIT, {}), "sampled": SAMPLED}
    engine, summary, reqs = run_engine(dev, streams, 32, again="sampled",
                                       kv_dtype="int8")
    if engine.runner.init_state().pool_k[0].dtype != torch.int8:
        raise AssertionError("kv_dtype='int8' did not build int8 pools")
    _expect_launches(summary["launches"], {"A", "B_int8", "C_int8"},
                     "int8 paged")
    ragged_chunks = engine.scheduler.ragged_chunks
    if summary["prefix_hits"] < 1 or ragged_chunks < 1:
        raise AssertionError(f"prefix hits {summary['prefix_hits']}, ragged "
                             f"chunks {ragged_chunks}: a path was not taken")
    errs = _check_logit_errs(logits_check(engine, dev, ragged=False),
                             "int8 paged")
    ragged = ragged_step_timing(engine, ragged_paged_attention)
    steady = decode_step_timing(engine, dev, flash_paged_decode_attention_tp)
    # Greedy tokens equal to the bf16 pool's, position by position (reported:
    # int8 KV changes the logits of random weights).
    same = [a == b for name, ids in bf16["ids"].items()
            if name in reqs and name != "sampled"
            for a, b in zip(ids, reqs[name]["ids"])]
    emit({"phase": "engine_int8", "model": "tinyllama-1.1b", "layers": 22,
          "kv_dtype": "int8", **summary, "ragged_chunks": ragged_chunks,
          "long_ttft_ms": reqs["long"]["ttft_ms"], "ragged_step": ragged,
          "sampled_ids": reqs["sampled"]["ids"],
          "logits_max_abs_err": errs, "logits_rtol": LOGIT_RTOL,
          "steady_decode": steady, "bf16_steady_decode": bf16["steady"],
          "greedy_tokens_equal_to_bf16": sum(same) / len(same),
          "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


def contiguous_logits_check(engine) -> dict:
    """One decode step through kernel D and through its plain version on
    the same state (3 live slots)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    r, tok = engine.runner, engine.tokenizer
    with torch.inference_mode():
        st = _three_slots(r, tok)
        seam = r.decode_attn
        r.decode_attn = decode_attention_plain
        dp = r.decode_logits(st)
        r.decode_attn = flash_decode_attention
        dk = r.decode_logits(st)
        r.decode_attn = seam
    return _check_logit_errs({"decode": _logit_err(dk[:3], dp[:3])},
                             "contiguous")["decode"]


def _check_chunks(engine, reqs) -> int:
    chunks = engine.scheduler.prefill_chunks
    if reqs["long"]["prompt_tokens"] <= engine.runner.prefill_chunk or \
            chunks < 2:
        raise AssertionError(f"the long prompt must take >= 2 chunks "
                             f"({chunks} chunks)")
    return chunks


def contiguous_phase(dev) -> int:
    """The contiguous-KV engine; returns kernel D's launches in its
    streams."""
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention

    engine, summary, reqs = run_engine(
        dev, {**GREEDY, "sampled": SAMPLED}, 32, again="sampled",
        kv_layout="contiguous")
    chunks = _check_chunks(engine, reqs)
    _expect_launches(summary["launches"], {"A", "D"}, "contiguous")
    err = contiguous_logits_check(engine)
    steady = decode_step_timing(engine, dev, flash_decode_attention)
    emit({"phase": "contiguous", "model": "tinyllama-1.1b", "layers": 22,
          **summary, "prefill_chunks": chunks,
          "sampled_ids": reqs["sampled"]["ids"],
          "logits_max_abs_err": err, "logits_rtol": LOGIT_RTOL,
          "steady_decode": steady, "card": torch.cuda.get_device_name(0)})
    return summary["launches"]["D"]


def int8_contiguous_phase(dev) -> None:
    """The contiguous int8 cache: 4 greedy streams of 16 tokens, the long
    one admitted in legacy chunks.  Its decode runs the plain
    ``decode_attention_q`` (the JAX package has no Pallas kernel for it),
    so only kernel A launches."""
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1", "short2")}, 16,
        kv_layout="contiguous", kv_dtype="int8")
    chunks = _check_chunks(engine, reqs)
    _expect_launches(summary["launches"], {"A"}, "int8 contiguous")
    steady = decode_step_timing(engine, dev)
    emit({"phase": "contiguous_int8", "model": "tinyllama-1.1b", "layers": 22,
          "kv_dtype": "int8", **summary, "prefill_chunks": chunks,
          "steady_decode": steady, "card": torch.cuda.get_device_name(0)})


def llama_params(dev, layers: int | None = None):
    """llama-3-8b at full width (32 query / 8 kv heads, Dh 128, hidden
    4096, vocab 128256), random bf16 weights from seed 0 made on the card
    (~16 GB at full depth; no host copy), the EOS column zeroed as in
    :func:`seed0_params`; ``layers`` cuts the depth.  Returns (config,
    params)."""
    from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
    from crowdllama_tpu_torch.engine.weights import init_params
    from crowdllama_tpu_torch.models.config import get_config

    cfg = get_config(LLAMA, **({} if layers is None
                               else {"num_layers": layers}))
    params = init_params(cfg, seed=0, device=dev)
    params["lm_head"][:, ByteTokenizer.EOS] = 0
    return cfg, params


def llama_phase(dev) -> dict:
    """llama-3-8b at full width and depth on the paged main path (bf16
    pool, default config): the TinyLlama paged phase's traffic and
    checks at Dh 128."""
    return engine_phase(dev, "engine_llama", LLAMA, llama_params(dev)[1])


def llama_cut_phase(dev, phase: str, ran: set[str], **engine_kw) -> dict:
    """llama-3-8b cut to LLAMA_CUT_LAYERS layers at full width, on one
    more path at Dh 128 (``engine_kw``: int8 pools, the contiguous layout,
    tp=2 on the one card): 2 greedy short prompts and the long one, 16
    tokens each.  The kernels in ``ran`` launch and no other; one decode
    step (and on bf16 paged pools a prefill and a ragged step) through the
    kernels agrees with the plain versions (2% of the logits' scale under
    tp, else 5%); the steady decode step is reported.  Returns the launch
    counts of the streams."""
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    cfg, params = llama_params(dev, LLAMA_CUT_LAYERS)
    engine, summary, reqs = run_engine(
        dev, {k: GREEDY[k] for k in ("short0", "short1")}, 16,
        params=params, model=LLAMA, model_config=cfg, **engine_kw)
    del params
    r = engine.runner
    int8 = engine_kw.get("kv_dtype") == "int8"
    tp = int(engine_kw.get("mesh_shape") or 1)
    _expect_launches(summary["launches"], ran, phase)
    out = {}
    if tp > 1:
        out["decode_steps"] = _expect_tp_launches(
            summary["launches"], tp, int8, phase, LLAMA_CUT_LAYERS)
    if engine_kw.get("kv_layout") == "contiguous":
        out["prefill_chunks"] = _check_chunks(engine, reqs)
        errs = {"decode": contiguous_logits_check(engine)}
        kernel = flash_decode_attention
    else:
        out["ragged_chunks"] = engine.scheduler.ragged_chunks
        if (reqs["long"]["prompt_tokens"] <= r.ragged_chunk
                or out["ragged_chunks"] < 1):
            raise AssertionError(f"{phase}: the long prompt took no ragged "
                                 f"chunk")
        errs = logits_check(engine, dev, ragged=not int8)
        kernel = flash_paged_decode_attention_tp
    rtol = LOGIT_RTOL_TP if tp > 1 else LOGIT_RTOL
    for k, e in errs.items():
        if not e["max_abs_err"] <= rtol * e["scale"]:
            raise AssertionError(f"{phase} {k} logits: kernel vs plain {e}")
    steady = decode_step_timing(engine, dev, kernel)
    kw = {k: [str(d) for d in v] if k == "devices" else v
          for k, v in engine_kw.items()}
    emit({"phase": phase, "model": LLAMA, "layers": cfg.num_layers,
          "head_dim": cfg.resolved_head_dim(),
          "reduced": {"num_layers": [32, LLAMA_CUT_LAYERS]}, **kw,
          **summary, **out, "logits_max_abs_err": errs, "logits_rtol": rtol,
          "steady_decode": steady, "card": torch.cuda.get_device_name(0)})
    return summary["launches"]


# row -> (name, source, TPU kernel it replaces); the name is the C symbol,
# for F B's symbol launched once over every tensor-parallel rank on the
# card (the ranks folded into its grid).
KERNEL_ROWS = {
    "A": ("flash_prefill", "crowdllama_tpu_torch/csrc/flash_prefill.cu",
          "crowdllama_tpu/ops/pallas/flash.py:146"),
    "B": ("paged_decode", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:196"),
    "B_int8": ("paged_decode_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:159"),
    "C": ("ragged_paged", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:703"),
    "C_int8": ("ragged_paged_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:667"),
    "D": ("flash_decode", "crowdllama_tpu_torch/csrc/flash_decode.cu",
          "crowdllama_tpu/ops/pallas/flash.py:269"),
    "E": ("ragged_chunk", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:412"),
    "E_int8": ("ragged_chunk_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:376"),
    "F": ("paged_decode_tp", "crowdllama_tpu_torch/csrc/paged_attention.cu",
          "crowdllama_tpu/ops/pallas/paged.py:860"),
    "F_int8": ("paged_decode_tp_i8",
               "crowdllama_tpu_torch/csrc/paged_attention.cu",
               "crowdllama_tpu/ops/pallas/paged.py:898"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from crowdllama_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "capability": list(cap),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability 9.0, got {cap}")

    t0 = time.perf_counter()
    kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [dict(r, library=lib) for lib in kernels.SIGNATURES
                    for r in kernels.ptxas_usage(lib)],
          "smem": [dict(kernels.kernel_resources(lib, sym, dh, g, dev),
                        entry=sym, dh=dh, group=g)
                   for lib, entries in kernels.SIGNATURES.items()
                   for sym in entries for dh, g in ((64, 8), (128, 4))]})

    from crowdllama_tpu_torch.engine import prng_golden

    emit({"phase": "threefry", **prng_golden.check(dev)})
    res = kernel_phase(dev)
    paged = engine_phase(dev)
    launches = {k: paged["launches"][k] for k in ("A", "B", "C")}
    _free_card()
    wire_phase(dev)
    _free_card()
    launches["F"] = tp_phase(dev, paged)["F"]
    _free_card()
    launches["F_int8"] = tp_int8_phase(dev)["F_int8"]
    _free_card()
    int8 = int8_paged_phase(dev, paged)
    launches.update({k: int8[k] for k in ("B_int8", "C_int8")})
    _free_card()
    launches["D"] = contiguous_phase(dev)
    _free_card()
    int8_contiguous_phase(dev)
    _free_card()
    # Dh 128: llama-3-8b at full depth on the paged main path, then cut to
    # LLAMA_CUT_LAYERS layers on the other paths.
    paged128 = llama_phase(dev)["launches"]
    launches128 = {k: paged128[k] for k in ("A", "B", "C")}
    for phase, ran, kw in (
            ("engine_llama_int8", {"A", "B_int8", "C_int8"},
             dict(kv_dtype="int8")),
            ("contiguous_llama", {"A", "D"}, dict(kv_layout="contiguous")),
            ("engine_llama_tp", {"A", "C", "F"},
             dict(mesh_shape="2", devices=[dev, dev])),
            ("engine_llama_tp_int8", {"A", "C_int8", "F_int8"},
             dict(mesh_shape="2", devices=[dev, dev], kv_dtype="int8"))):
        _free_card()
        got = llama_cut_phase(dev, phase, ran, **kw)
        launches128.update({k: got[k] for k in ran - {"A", "C"}
                            if k not in launches128})
    # No engine path runs kernel E; every phase checked it stayed at 0.
    launches["E"] = launches["E_int8"] = 0
    launches128["E"] = launches128["E_int8"] = 0

    rows = []
    for dh, counts in ((64, launches), (128, launches128)):
        sfx = "" if dh == 64 else "_dh128"
        for key, (kname, src, repl) in KERNEL_ROWS.items():
            r = res[key + sfx]
            rows.append({"name": kname + sfx, "head_dim": dh, "route": "cuda",
                         "source": src, "replaces": repl,
                         "launches": counts[key],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
