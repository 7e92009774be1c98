"""The port's hand-written CUDA kernels against their plain versions, on
the card (``cuda`` marker; each test skips without a GPU).

This file imports torch and the port only, so it runs on a machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).  Shapes
are TinyLlama's heads (32 query, 4 kv, Dh 64) at small lengths, with
softcap, a sliding window, padding, rows that carry no query and
zero-length slots (kernels A-D, and B and C on int8 pools with bf16
scales from ``quantize_kv``; kernel E, and C's chunk rows, on both pools
at the edges of the chunk tile: unaligned contexts and chunk lengths,
windows across pages, groups of 2, 4 and 7; kernel F bit-equal to B at
tp 2 and 4);
and at head dim 128 with Llama-3-8B's heads (32 query, 8 kv): every
kernel on both pools, A at groups of 4 and 7 (and 7 at Dh 64), F
bit-equal to B, and the builds' ``ptxas`` reports without spills.  Kernel
B's split-KV grid on both pools, at both head dims and groups of 1, 2, 4,
7 and 8 (padded to 4 or 8 heads), at lengths on its split edges (0, 1,
page - 1, page, page + 1, one split's 256 keys, one more, the table's
width), with softcap and windows that leave whole splits empty, and on
pages of 16, 32 and 64 (a stage spanning several pages); two calls
equal; F at tp 2 and 4 one launch on one card, bit-equal to B; the
decode block's shared memory leaves two blocks a SM at both head dims.
Kernel D on the same decode stages: at its split and stage edges over
caches of 2,048 and 600 keys, both head dims, groups of 1, 2, 4, 7 and 8,
softcap and windows that empty whole splits, two calls equal; bit-equal
to B on the same keys in pages of 128; D and B calls in turn on one
stream, each equal to its plain version, the shared counters at zero.
Tolerance: one bf16 rounding of outputs of magnitude ~1 plus fp32
summation order, atol 2e-2 + rtol 1e-2.
"""

import pytest

torch = pytest.importorskip("torch")

from crowdllama_tpu_torch.ops.cuda.flash import (  # noqa: E402
    flash_prefill_attention,
)
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_paged_decode_attention,
    ragged_paged_attention,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (hand-written CUDA kernels)")
    return torch.device("cuda")


def _card_case(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = dict(device=dev, dtype=torch.bfloat16)
    return gen, bf


@pytest.mark.cuda
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 17)])
def test_prefill_kernel_matches_plain_on_card(cuda_device, softcap, window):
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref

    gen, bf = _card_case(cuda_device)
    t, plen = 160, 150
    q = torch.randn((2, t, 32, 64), generator=gen, **bf)
    k = torch.randn((2, 4, t, 64), generator=gen, **bf)
    v = torch.randn((2, 4, t, 64), generator=gen, **bf)
    ar = torch.arange(t, device=cuda_device, dtype=torch.int32)
    pos = torch.clamp(ar, max=plen - 1)[None].repeat(2, 1).contiguous()
    valid = (ar < plen)[None].repeat(2, 1).contiguous()
    kw = dict(softcap=softcap, sliding_window=window, kv_valid=valid)
    got = flash_prefill_attention(q, k, v, pos, 0.125, **kw)
    want = prefill_attention_ref(q, k, v, pos, 0.125, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=1e-2)


@pytest.mark.cuda
def test_paged_kernels_match_plain_on_card(cuda_device):
    from crowdllama_tpu_torch.ops.cuda.paged import (
        paged_decode_attention_plain,
        ragged_paged_attention_ref,
    )

    gen, bf = _card_case(cuda_device)
    b, page, np_ = 4, 128, 4
    pk = torch.randn((17, 4, page, 64), generator=gen, **bf)
    pv = torch.randn((17, 4, page, 64), generator=gen, **bf)
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 11, 12]], dtype=torch.int32,
                         device=cuda_device)
    q = torch.randn((b, 32, 64), generator=gen, **bf)
    lens = torch.tensor([300, 1, 512, 129], dtype=torch.int32,
                        device=cuda_device)
    got = flash_paged_decode_attention(q, pk, pv, table, lens, 0.125)
    want = paged_decode_attention_plain(q, pk, pv, table, lens, 0.125)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=1e-2)

    c, ctx, valid = 64, 256, 50
    qr = torch.randn((b + c, 32, 64), generator=gen, **bf)
    cpos = torch.clamp(ctx + torch.arange(c, device=cuda_device),
                       max=ctx + valid - 1)
    cpages = table[3, cpos // page].long()
    ck = pk[cpages, :, cpos % page].transpose(0, 1)[None].contiguous()
    cv = pv[cpages, :, cpos % page].transpose(0, 1)[None].contiguous()
    ql = torch.tensor([1, 1, 1, 0, valid], dtype=torch.int32,
                      device=cuda_device)
    kl = torch.tensor([300, 1, 512, 1, ctx + valid], dtype=torch.int32,
                      device=cuda_device)
    got = ragged_paged_attention(qr, ck, cv, pk, pv, table, ql, kl, 3, 0.125)
    want = ragged_paged_attention_ref(qr, ck, cv, pk, pv, table, ql, kl, 3,
                                      0.125)
    live = [0, 1, 2] + [b + i for i in range(valid)]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=2e-2, rtol=1e-2)
    assert not got[[3] + [b + i for i in range(valid, c)]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 40)])
def test_decode_kernel_matches_plain_on_card(cuda_device, softcap, window):
    """Kernel D over the contiguous cache: mixed lengths, a one-token slot
    and a zero-length slot (zeros from the kernel)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    gen, bf = _card_case(cuda_device)
    b, s = 5, 300
    q = torch.randn((b, 32, 64), generator=gen, **bf)
    kc = torch.randn((b, 4, s, 64), generator=gen, **bf)
    vc = torch.randn((b, 4, s, 64), generator=gen, **bf)
    lens = torch.tensor([300, 1, 0, 129, 77], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_decode_attention(q, kc, vc, lens, 0.125, **kw)
    want = decode_attention_plain(q, kc, vc, lens, 0.125, **kw)
    live = [0, 1, 3, 4]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=2e-2, rtol=1e-2)
    assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 40)])
def test_paged_int8_kernels_match_plain_on_card(cuda_device, softcap, window):
    """Kernels B and C on an int8 pool: mixed lengths, a one-token slot, a
    zero-length slot and an inactive row (zeros from the kernels).  C's
    plain version gets the chunk rows as the pool holds them (dequantized
    in fp32), since the kernel reads them back from the pool."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        paged_decode_attention_plain,
        ragged_paged_attention_ref,
    )
    from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    gen, bf = _card_case(cuda_device)
    b, page = 4, 128
    pk8, ksc = quantize_kv(torch.randn((17, 4, page, 64), generator=gen, **bf))
    pv8, vsc = quantize_kv(torch.randn((17, 4, page, 64), generator=gen, **bf))
    sc = dict(k_scale=ksc, v_scale=vsc, softcap=softcap,
              sliding_window=window)
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 11, 12]], dtype=torch.int32,
                         device=cuda_device)
    q = torch.randn((b, 32, 64), generator=gen, **bf)
    lens = torch.tensor([300, 1, 0, 129], dtype=torch.int32,
                        device=cuda_device)
    got = flash_paged_decode_attention(q, pk8, pv8, table, lens, 0.125, **sc)
    want = paged_decode_attention_plain(q, pk8, pv8, table, lens, 0.125, **sc)
    torch.testing.assert_close(got[[0, 1, 3]].float(),
                               want[[0, 1, 3]].float(), atol=2e-2, rtol=1e-2)
    assert not got[2].any()

    c, ctx, valid = 64, 256, 50
    qr = torch.randn((b + c, 32, 64), generator=gen, **bf)
    cpos = torch.clamp(ctx + torch.arange(c, device=cuda_device),
                       max=ctx + valid - 1)
    cp, co = table[3, cpos // page].long(), cpos % page
    ck = dequantize_kv(pk8[cp, :, co], ksc[cp, :, co]).transpose(0, 1)[None]
    cv = dequantize_kv(pv8[cp, :, co], vsc[cp, :, co]).transpose(0, 1)[None]
    ql = torch.tensor([1, 1, 0, 0, valid], dtype=torch.int32,
                      device=cuda_device)
    kl = torch.tensor([300, 1, 1, 1, ctx + valid], dtype=torch.int32,
                      device=cuda_device)
    got = ragged_paged_attention(qr, ck, cv, pk8, pv8, table, ql, kl, 3,
                                 0.125, **sc)
    want = ragged_paged_attention_ref(qr, ck, cv, pk8, pv8, table, ql, kl, 3,
                                      0.125, **sc)
    live = [0, 1] + [b + i for i in range(valid)]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=2e-2, rtol=1e-2)
    assert not got[[2, 3] + [b + i for i in range(valid, c)]].any()


def _pools(dev, gen, int8: bool, page: int = 128):
    from crowdllama_tpu_torch.ops.quant import quantize_kv

    bf = dict(device=dev, dtype=torch.bfloat16)
    pk = torch.randn((17, 4, page, 64), generator=gen, **bf)
    pv = torch.randn((17, 4, page, 64), generator=gen, **bf)
    if not int8:
        return pk, pv, {}
    (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
    return pk, pv, dict(k_scale=ks, v_scale=vs)


# Chunk cases for kernels E and C: (ctx, chunk rows, valid rows, softcap,
# window, query heads over the 4 kv heads).  Chunk blocks hold 128 / G
# queries (16 at G = 8); the cases take chunk lengths that are not a
# multiple of that, a context that is not page-aligned, windows across a
# page boundary, valid rows fewer than the chunk's, and groups of 2, 4 and 7
# (7 leaves the last two rows of a block's 128 empty).
CHUNK_CASES = [
    (0, 80, 64, 0.0, 0, 32), (256, 80, 50, 30.0, 0, 32),
    (128, 80, 77, 0.0, 40, 32), (200, 75, 75, 0.0, 0, 32),
    (200, 75, 60, 30.0, 100, 32), (200, 90, 81, 0.0, 0, 8),
    (130, 70, 70, 30.0, 50, 16), (200, 75, 61, 0.0, 100, 28)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ctx,c,valid,softcap,window,h", CHUNK_CASES)
def test_chunk_kernel_matches_plain_on_card(cuda_device, int8, ctx, c, valid,
                                            softcap, window, h):
    """Kernel E: one chunk over its slot's pages; rows past the valid ones
    are zeros from the kernel."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_ragged_chunk_attention,
        ragged_chunk_attention_plain,
    )

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools(cuda_device, gen, int8)
    q = torch.randn((c, h, 64), generator=gen, **bf)
    pages = torch.tensor([3, 9, 1, 14], dtype=torch.int32, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    args = (q, pk, pv, pages, torch.tensor(ctx, **i32),
            torch.tensor(ctx + valid, **i32), 0.125)
    kw = dict(softcap=softcap, sliding_window=window, **sc)
    got = flash_ragged_chunk_attention(*args, **kw)
    want = ragged_chunk_attention_plain(*args, **kw)
    torch.testing.assert_close(got[:valid].float(), want[:valid].float(),
                               atol=2e-2, rtol=1e-2)
    assert not got[valid:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("page", [16, 32])
def test_chunk_kernel_small_pages_on_card(cuda_device, int8, page):
    """Kernel E on pages smaller than its 128-key tiles: each tile gathers
    several pages of the table, the last one past the table's end."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_ragged_chunk_attention,
        ragged_chunk_attention_plain,
    )

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools(cuda_device, gen, int8, page)
    ctx, c, valid = 100, 75, 70
    q = torch.randn((c, 32, 64), generator=gen, **bf)
    pages = torch.randperm(16, generator=torch.Generator().manual_seed(page))
    pages = pages[:-(-(ctx + valid) // page)].to(torch.int32).to(cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    args = (q, pk, pv, pages, torch.tensor(ctx, **i32),
            torch.tensor(ctx + valid, **i32), 0.125)
    kw = dict(softcap=30.0, sliding_window=50, **sc)
    got = flash_ragged_chunk_attention(*args, **kw)
    want = ragged_chunk_attention_plain(*args, **kw)
    torch.testing.assert_close(got[:valid].float(), want[:valid].float(),
                               atol=2e-2, rtol=1e-2)
    assert not got[valid:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ctx,c,valid,softcap,window,h", CHUNK_CASES[3:])
def test_ragged_kernel_chunk_rows_match_plain_on_card(cuda_device, int8, ctx,
                                                      c, valid, softcap,
                                                      window, h):
    """Kernel C's chunk rows at the edges of the chunk tile, beside decode
    rows (one inactive); the plain version gets the chunk's rows as the
    pool holds them.  Rows without a query are zeros from the kernel."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        ragged_paged_attention,
        ragged_paged_attention_ref,
    )
    from crowdllama_tpu_torch.ops.quant import dequantize_kv

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools(cuda_device, gen, int8)
    b, page = 4, 128
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 11, 12]], dtype=torch.int32,
                         device=cuda_device)
    qr = torch.randn((b + c, h, 64), generator=gen, **bf)
    cpos = torch.clamp(ctx + torch.arange(c, device=cuda_device),
                       max=ctx + valid - 1)
    cp, co = table[3, cpos // page].long(), cpos % page

    def rows(pool, scale):
        x = pool[cp, :, co]
        if scale is not None:
            x = dequantize_kv(x, scale[cp, :, co])
        return x.transpose(0, 1)[None].contiguous()

    ck, cv = rows(pk, sc.get("k_scale")), rows(pv, sc.get("v_scale"))
    ql = torch.tensor([1, 0, 1, 0, valid], dtype=torch.int32,
                      device=cuda_device)
    kl = torch.tensor([300, 1, 512, 1, ctx + valid], dtype=torch.int32,
                      device=cuda_device)
    args = (qr, ck, cv, pk, pv, table, ql, kl, 3, 0.125)
    kw = dict(softcap=softcap, sliding_window=window, **sc)
    got = ragged_paged_attention(*args, **kw)
    want = ragged_paged_attention_ref(*args, **kw)
    live = [0, 2] + [b + i for i in range(valid)]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=2e-2, rtol=1e-2)
    assert not got[[1, 3] + [b + i for i in range(valid, c)]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_decode_is_bit_identical_to_paged_decode_on_card(cuda_device,
                                                            int8, tp):
    """Kernel F on tp shares of the q heads and pool kv heads gives, rank
    by rank, exactly B's output on the whole pool (its (slot, kv head)
    blocks are independent); a call counts as an F call only over more
    than one rank."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools(cuda_device, gen, int8)
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 11, 12]], dtype=torch.int32,
                         device=cuda_device)
    q = torch.randn((4, 32, 64), generator=gen, **bf)
    lens = torch.tensor([300, 1, 0, 129], dtype=torch.int32,
                        device=cuda_device)
    full = flash_paged_decode_attention(q, pk, pv, table, lens, 0.125, **sc)

    def cut(x):
        return [s.contiguous() for s in x.chunk(tp, dim=1)]

    skw = {f"{k}s": cut(v) for k, v in sc.items()}
    calls = lambda: (flash_paged_decode_attention_tp.launches  # noqa: E731
                     + flash_paged_decode_attention_tp.launches_int8)
    b_calls = lambda: (flash_paged_decode_attention.launches  # noqa: E731
                       + flash_paged_decode_attention.launches_int8)
    before, b_before = calls(), b_calls()
    outs = flash_paged_decode_attention_tp(cut(q), cut(pk), cut(pv), table,
                                           lens, 0.125, **skw)
    assert torch.equal(torch.cat(outs, dim=1), full)
    # One launch over every rank on the card; B's count moves only at tp 1.
    assert calls() - before == (tp > 1)
    assert b_calls() - b_before == (tp == 1)


# ------------------------------------------------------------ head dim 128

ATOL, RTOL = 2e-2, 1e-2


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,h,hkv,softcap,window", [
    (128, 32, 8, 0.0, 0), (128, 32, 8, 30.0, 17), (128, 28, 4, 0.0, 0),
    (128, 28, 4, 30.0, 40), (64, 28, 4, 0.0, 33)])
def test_prefill_kernel_head_dims_and_groups_on_card(cuda_device, dh, h, hkv,
                                                     softcap, window):
    """Kernel A at Dh 128 (groups of 4 and 7) and at Dh 64 with a group of
    7, over two batch rows padded past their prompt (positions clamped,
    padding keys invalid), every row that sees a key held against the
    plain version; row 1's first 7 queries see none and are zeros from the
    kernel (the plain version averages V there)."""
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref

    gen, bf = _card_case(cuda_device)
    t, plen = 200, 181
    q = torch.randn((2, t, h, dh), generator=gen, **bf)
    k = torch.randn((2, hkv, t, dh), generator=gen, **bf)
    v = torch.randn((2, hkv, t, dh), generator=gen, **bf)
    ar = torch.arange(t, device=cuda_device, dtype=torch.int32)
    pos = torch.clamp(ar, max=plen - 1)[None].repeat(2, 1).contiguous()
    valid = (ar < plen)[None].repeat(2, 1).contiguous()
    valid[1, :7] = False  # row 1's first queries see no key
    kw = dict(softcap=softcap, sliding_window=window, kv_valid=valid)
    got = flash_prefill_attention(q, k, v, pos, dh ** -0.5, **kw)
    want = prefill_attention_ref(q, k, v, pos, dh ** -0.5, **kw)
    _close(got[0], want[0])
    _close(got[1, 7:], want[1, 7:])
    assert not got[1, :7].any()


def _pools128(dev, gen, int8: bool, page: int = 128, pages: int = 17):
    from crowdllama_tpu_torch.ops.quant import quantize_kv

    bf = dict(device=dev, dtype=torch.bfloat16)
    pk = torch.randn((pages, 8, page, 128), generator=gen, **bf)
    pv = torch.randn((pages, 8, page, 128), generator=gen, **bf)
    if not int8:
        return pk, pv, {}
    (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
    return pk, pv, dict(k_scale=ks, v_scale=vs)


_TABLE = [[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8], [9, 10, 11, 12]]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 40)])
def test_paged_decode_dh128_on_card(cuda_device, int8, softcap, window):
    """Kernel B at Dh 128 (its page past 48 KB of shared memory at page
    128): mixed lengths, a one-token and a zero-length slot."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        paged_decode_attention_plain,
    )

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools128(cuda_device, gen, int8)
    table = torch.tensor(_TABLE, dtype=torch.int32, device=cuda_device)
    q = torch.randn((4, 32, 128), generator=gen, **bf)
    lens = torch.tensor([300, 1, 0, 512], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(softcap=softcap, sliding_window=window, **sc)
    got = flash_paged_decode_attention(q, pk, pv, table, lens, 0.088, **kw)
    want = paged_decode_attention_plain(q, pk, pv, table, lens, 0.088, **kw)
    _close(got[[0, 1, 3]], want[[0, 1, 3]])
    assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 40)])
def test_flash_decode_dh128_on_card(cuda_device, softcap, window):
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    gen, bf = _card_case(cuda_device)
    b, s = 5, 300
    q = torch.randn((b, 32, 128), generator=gen, **bf)
    kc = torch.randn((b, 8, s, 128), generator=gen, **bf)
    vc = torch.randn((b, 8, s, 128), generator=gen, **bf)
    lens = torch.tensor([300, 1, 0, 129, 77], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_decode_attention(q, kc, vc, lens, 0.088, **kw)
    want = decode_attention_plain(q, kc, vc, lens, 0.088, **kw)
    _close(got[[0, 1, 3, 4]], want[[0, 1, 3, 4]])
    assert not got[2].any()


# (ctx, chunk rows, valid rows, softcap, window, query heads over 8 kv
# heads): Dh 128's 64-key tiles, windows across tiles and pages, groups of
# 4, 2 and 7 (56 / 8).
CHUNK128_CASES = [
    (0, 80, 64, 0.0, 0, 32), (256, 80, 50, 30.0, 0, 32),
    (200, 75, 60, 30.0, 100, 32), (130, 70, 70, 0.0, 50, 16),
    (200, 75, 61, 0.0, 100, 56)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ctx,c,valid,softcap,window,h", CHUNK128_CASES)
def test_chunk_and_ragged_dh128_on_card(cuda_device, int8, ctx, c, valid,
                                        softcap, window, h):
    """Kernel E over its slot's pages, and C's chunk rows beside decode
    rows on the same pool, at Dh 128."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_ragged_chunk_attention,
        ragged_chunk_attention_plain,
        ragged_paged_attention_ref,
    )
    from crowdllama_tpu_torch.ops.quant import dequantize_kv

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools128(cuda_device, gen, int8)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    q = torch.randn((c, h, 128), generator=gen, **bf)
    pages = torch.tensor([3, 9, 1, 14], **i32)
    args = (q, pk, pv, pages, torch.tensor(ctx, **i32),
            torch.tensor(ctx + valid, **i32), 0.088)
    kw = dict(softcap=softcap, sliding_window=window, **sc)
    got = flash_ragged_chunk_attention(*args, **kw)
    want = ragged_chunk_attention_plain(*args, **kw)
    _close(got[:valid], want[:valid])
    assert not got[valid:].any()

    b, page = 4, 128
    table = torch.tensor(_TABLE, **i32)
    qr = torch.randn((b + c, h, 128), generator=gen, **bf)
    cpos = torch.clamp(ctx + torch.arange(c, device=cuda_device),
                       max=ctx + valid - 1)
    cp, co = table[3, cpos // page].long(), cpos % page

    def rows(pool, scale):
        x = pool[cp, :, co]
        if scale is not None:
            x = dequantize_kv(x, scale[cp, :, co])
        return x.transpose(0, 1)[None].contiguous()

    ck, cv = rows(pk, sc.get("k_scale")), rows(pv, sc.get("v_scale"))
    ql = torch.tensor([1, 0, 1, 0, valid], **i32)
    kl = torch.tensor([300, 1, 512, 1, ctx + valid], **i32)
    rargs = (qr, ck, cv, pk, pv, table, ql, kl, 3, 0.088)
    got = ragged_paged_attention(*rargs, **kw)
    want = ragged_paged_attention_ref(*rargs, **kw)
    live = [0, 2] + [b + i for i in range(valid)]
    _close(got[live], want[live])
    assert not got[[1, 3] + [b + i for i in range(valid, c)]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("page", [16, 64])
def test_chunk_dh128_small_pages_on_card(cuda_device, int8, page):
    """E at Dh 128 on pages of 16 and 64 keys: a 64-key tile gathers four
    pages of 16, or is one page of 64."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_ragged_chunk_attention,
        ragged_chunk_attention_plain,
    )

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools128(cuda_device, gen, int8, page, pages=17)
    ctx, c, valid = 100, 75, 70
    q = torch.randn((c, 32, 128), generator=gen, **bf)
    pages = torch.randperm(16, generator=torch.Generator().manual_seed(page))
    pages = pages[:-(-(ctx + valid) // page)].to(torch.int32).to(cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    args = (q, pk, pv, pages, torch.tensor(ctx, **i32),
            torch.tensor(ctx + valid, **i32), 0.088)
    kw = dict(softcap=30.0, sliding_window=50, **sc)
    got = flash_ragged_chunk_attention(*args, **kw)
    want = ragged_chunk_attention_plain(*args, **kw)
    _close(got[:valid], want[:valid])
    assert not got[valid:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_dh128_bit_identical_to_paged_decode(cuda_device, int8, tp):
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    gen, bf = _card_case(cuda_device)
    pk, pv, sc = _pools128(cuda_device, gen, int8)
    table = torch.tensor(_TABLE, dtype=torch.int32, device=cuda_device)
    q = torch.randn((4, 32, 128), generator=gen, **bf)
    lens = torch.tensor([300, 1, 0, 512], dtype=torch.int32,
                        device=cuda_device)
    full = flash_paged_decode_attention(q, pk, pv, table, lens, 0.088, **sc)

    def cut(x):
        return [s.contiguous() for s in x.chunk(tp, dim=1)]

    skw = {f"{k}s": cut(v) for k, v in sc.items()}
    before = (flash_paged_decode_attention_tp.launches
              + flash_paged_decode_attention_tp.launches_int8)
    outs = flash_paged_decode_attention_tp(cut(q), cut(pk), cut(pv), table,
                                           lens, 0.088, **skw)
    assert torch.equal(torch.cat(outs, dim=1), full)
    assert (flash_paged_decode_attention_tp.launches
            + flash_paged_decode_attention_tp.launches_int8) == before + 1


@pytest.mark.cuda
def test_builds_report_no_spills(cuda_device):
    """Every kernel instantiation, at Dh 64 and 128 on both pools, keeps
    its registers: ``ptxas -v`` reports no spill stores or loads."""
    from crowdllama_tpu_torch.ops import cuda as kernels

    rows = [dict(r, library=name) for name in kernels.SIGNATURES
            for r in kernels.ptxas_usage(name)]
    assert {(r["kernel"], r["dh"]) for r in rows} >= {
        (k, dh) for dh in (64, 128)
        for k in ("flash_prefill_kernel", "flash_decode_kernel",
                  "paged_decode_kernel", "ragged_paged_kernel",
                  "ragged_chunk_kernel")}
    spills = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    assert not spills, spills


@pytest.mark.cuda
def test_samplers_match_jax_goldens_on_card(cuda_device):
    """Threefry and the samplers with the logits on the card, against the
    goldens captured from JAX, tied rows included (the window's stable
    sort orders equal logits as ``jax.lax.top_k``)."""
    from crowdllama_tpu_torch.engine import prng_golden

    got = prng_golden.check(cuda_device)
    assert got["tied_slot_tokens"] == prng_golden.TIED_SLOT_TOKENS


# ------------------------------------------------------ B's split-KV grid

# Lengths on the edges of B's split plan at page 128 and a table of 16
# pages (2 pages, 256 keys, a split): no key, one, a page less one, a page,
# a page and one, one split, one split and one key, the whole table.
SPLIT_EDGE_LENS = [0, 1, 127, 128, 129, 256, 257, 2048]


def _split_case(dev, gen, int8: bool, dh: int, h: int, hkv: int,
                page: int = 128, lens=None):
    """Pools with distinct pages per slot (the last page pads every table
    row), q and the lengths (default: the edge lengths at page 128); the
    table holds 2,048 keys."""
    from crowdllama_tpu_torch.ops.quant import quantize_kv

    lens = SPLIT_EDGE_LENS if lens is None else lens
    np_ = 2048 // page
    need = [-(-n // page) for n in lens]
    pages = sum(need) + 1
    bf = dict(device=dev, dtype=torch.bfloat16)
    pk = torch.randn((pages, hkv, page, dh), generator=gen, **bf)
    pv = torch.randn((pages, hkv, page, dh), generator=gen, **bf)
    table = torch.full((len(need), np_), pages - 1, dtype=torch.int32)
    perm = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(7))
    used = 0
    for i, k in enumerate(need):
        table[i, :k] = perm[used:used + k].to(torch.int32)
        used += k
    q = torch.randn((len(need), h, dh), generator=gen, **bf)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    sc = {}
    if int8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        sc = dict(k_scale=ks, v_scale=vs)
    return q, pk, pv, table.to(dev), lens, sc


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dh,hkv", [(64, 4), (128, 8)])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 40),
                                            (0.0, 300)])
def test_split_decode_edges_match_plain_on_card(cuda_device, int8, dh, hkv,
                                                group, softcap, window):
    """Kernel B at its split edges: one live split written directly,
    several merged (windows of 40 and 300 leave the first 7 and 6 splits of
    the 2,048-token slot empty), the zero-length slot zeros; two calls give
    the same bits (the merge reads its partials in split order)."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        paged_decode_attention_plain,
    )

    gen, _ = _card_case(cuda_device)
    q, pk, pv, table, lens, sc = _split_case(cuda_device, gen, int8, dh,
                                             group * hkv, hkv)
    args = (q, pk, pv, table, lens, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window, **sc)
    got = flash_paged_decode_attention(*args, **kw)
    again = flash_paged_decode_attention(*args, **kw)
    want = paged_decode_attention_plain(*args, **kw)
    assert torch.equal(got, again)
    _close(got[1:], want[1:])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dh,hkv", [(64, 4), (128, 8)])
@pytest.mark.parametrize("page", [16, 32, 64])
def test_split_decode_small_pages_on_card(cuda_device, int8, dh, hkv, page):
    """Kernel B on pages smaller than its 64-key stages (16, 32: a stage
    gathers several pages) or equal to one (64); splits of 256 keys span
    16, 8 or 4 pages; lengths at page and split edges, a window across
    pages."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        paged_decode_attention_plain,
    )

    gen, _ = _card_case(cuda_device)
    lens = [0, 1, page - 1, page + 1, 255, 257, 1000, 2048]
    q, pk, pv, table, lens, sc = _split_case(cuda_device, gen, int8, dh, 32,
                                             hkv, page, lens)
    kw = dict(softcap=30.0, sliding_window=300, **sc)
    got = flash_paged_decode_attention(q, pk, pv, table, lens, dh ** -0.5,
                                       **kw)
    want = paged_decode_attention_plain(q, pk, pv, table, lens, dh ** -0.5,
                                        **kw)
    _close(got[1:], want[1:])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dh,hkv", [(64, 4), (128, 8)])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_at_split_edges_is_one_launch_equal_to_b(cuda_device, int8,
                                                           dh, hkv, tp):
    """Kernel F at B's split edges with a window that empties splits: the
    ranks on the one card run as one launch, bit-equal to B on the whole
    pool (the split plan does not depend on the kv heads)."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention_tp,
    )

    gen, _ = _card_case(cuda_device)
    q, pk, pv, table, lens, sc = _split_case(cuda_device, gen, int8, dh,
                                             32, hkv)
    kw = dict(softcap=30.0, sliding_window=300)
    full = flash_paged_decode_attention(q, pk, pv, table, lens, dh ** -0.5,
                                        **kw, **sc)

    def cut(x):
        return [s.contiguous() for s in x.chunk(tp, dim=1)]

    counts = lambda: (flash_paged_decode_attention_tp.launches,  # noqa: E731
                      flash_paged_decode_attention_tp.launches_int8,
                      flash_paged_decode_attention.launches,
                      flash_paged_decode_attention.launches_int8)
    before = counts()
    outs = flash_paged_decode_attention_tp(
        cut(q), cut(pk), cut(pv), table, lens, dh ** -0.5, **kw,
        **{f"{k}s": cut(v) for k, v in sc.items()})
    assert torch.equal(torch.cat(outs, dim=1), full)
    moved = [a - b for a, b in zip(counts(), before)]
    assert moved == ([0, 1, 0, 0] if int8 else [1, 0, 0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dh,group", [(64, 8), (128, 4), (128, 8)])
def test_decode_block_leaves_two_blocks_a_sm(cuda_device, dh, group):
    """The decode block of B and D (the ring of three 64-key stages, page
    ids, P and the flag) leaves room for two blocks a SM in shared memory at
    both head dims and both pools, and launches (at least one block a
    SM)."""
    from crowdllama_tpu_torch.ops import cuda as kernels

    sm_bytes = 228 * 1024  # an H100 SM's shared memory; 1 KB a block reserved
    for lib, entry in (("paged_attention", "paged_decode"),
                       ("paged_attention", "paged_decode_i8"),
                       ("flash_decode", "flash_decode")):
        res = kernels.kernel_resources(lib, entry, dh, group, cuda_device)
        assert 2 * (res["smem_bytes"] + 1024) <= sm_bytes, res
        assert res["blocks_per_sm"] >= 1, res


# ------------------------------------------------------ D's split-KV grid

def _contig_case(dev, gen, dh: int, h: int, hkv: int, s: int):
    """Caches [B, Hkv, S, Dh] and q at lengths on D's split and stage edges
    (no key, one, a stage less one, a stage, a stage and one, a split less
    one, a split, a split and one, S - 1, S)."""
    lens = [0, 1, 63, 64, 65, 255, 256, 257, s - 1, s]
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.randn((len(lens), h, dh), generator=gen, **bf)
    kc = torch.randn((len(lens), hkv, s, dh), generator=gen, **bf)
    vc = torch.randn((len(lens), hkv, s, dh), generator=gen, **bf)
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,hkv", [(64, 4), (128, 8)])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("s", [2048, 600])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 40),
                                            (0.0, 300)])
def test_flash_decode_split_edges_match_plain_on_card(cuda_device, dh, hkv,
                                                      group, s, softcap,
                                                      window):
    """Kernel D at its split and stage edges over caches of 2,048 and 600
    keys (not a multiple of a split): one live split written directly,
    several merged (windows of 40 and 300 leave the first splits of the
    longest slots empty), the zero-length slot zeros; two calls give the
    same bits (the merge reads its partials in split order)."""
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    gen, _ = _card_case(cuda_device)
    q, kc, vc, lens = _contig_case(cuda_device, gen, dh, group * hkv, hkv, s)
    args = (q, kc, vc, lens, dh ** -0.5)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_decode_attention(*args, **kw)
    again = flash_decode_attention(*args, **kw)
    want = decode_attention_plain(*args, **kw)
    assert torch.equal(got, again)
    _close(got[1:], want[1:])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,hkv", [(64, 4), (128, 8)])
@pytest.mark.parametrize("group", [4, 8])
def test_flash_decode_is_bit_identical_to_paged_decode(cuda_device, dh, hkv,
                                                       group):
    """D on a contiguous cache and B on the same keys in pages of 128 run
    the same decode stages with the same 256-key splits: the same bits."""
    from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention

    gen, _ = _card_case(cuda_device)
    s, page = 2048, 128
    q, kc, vc, lens = _contig_case(cuda_device, gen, dh, group * hkv, hkv, s)
    b, np_ = q.shape[0], s // page

    def paged(x):
        return x.reshape(b, hkv, np_, page, dh).transpose(1, 2).reshape(
            b * np_, hkv, page, dh).contiguous()

    table = torch.arange(b * np_, dtype=torch.int32,
                         device=cuda_device).reshape(b, np_)
    kw = dict(softcap=30.0, sliding_window=300)
    got = flash_decode_attention(q, kc, vc, lens, dh ** -0.5, **kw)
    want = flash_paged_decode_attention(q, paged(kc), paged(vc), table, lens,
                                        dh ** -0.5, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,hkv", [(64, 4), (128, 8)])
def test_flash_decode_and_paged_decode_interleaved_on_card(cuda_device, dh,
                                                           hkv):
    """D and B share the device's split scratch and counters: calls of one
    and the other in turn on one stream each match their plain versions,
    and every launch leaves the counters at zero."""
    from crowdllama_tpu_torch.ops.cuda import paged as P
    from crowdllama_tpu_torch.ops.cuda.flash import (
        decode_attention_plain,
        flash_decode_attention,
    )

    gen, _ = _card_case(cuda_device)
    dq, kc, vc, dlens = _contig_case(cuda_device, gen, dh, 32, hkv, 600)
    q, pk, pv, table, lens, _ = _split_case(cuda_device, gen, False, dh, 32,
                                            hkv)
    kw = dict(softcap=30.0, sliding_window=300)
    d_want = decode_attention_plain(dq, kc, vc, dlens, 0.1, **kw)
    b_want = P.paged_decode_attention_plain(q, pk, pv, table, lens, 0.1, **kw)
    for _ in range(3):
        for name, got, want in (
                ("D", flash_decode_attention(dq, kc, vc, dlens, 0.1, **kw),
                 d_want),
                ("B", flash_paged_decode_attention(q, pk, pv, table, lens,
                                                   0.1, **kw), b_want)):
            _close(got[1:], want[1:])
            assert not got[0].any(), name
            counters = P._SPLIT_SCRATCH[got.device][1]
            assert not counters.any(), (name, counters.nonzero())
