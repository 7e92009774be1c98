"""Kernel E (``flash_ragged_chunk_attention``) of the port against the JAX
package.

E's plain version (what the wrapper runs on CPU tensors) against JAX's
Pallas kernel in interpret mode, on the valid chunk rows, over bf16 and
int8 pools: a chunk at context 0 and past it, fewer valid rows than the
chunk, a softcap and a sliding window.  Tolerance 2e-2 + 1e-2·|x|: both
read the same bf16 (or int8 + bf16 scale) inputs and accumulate in fp32
in different orders, then round to bf16.  Also E's plain version against
the chunk rows of kernel C's plain version (its reference semantics),
and the wrapper's dispatch: CPU tensors run the plain version without
launching, other devices are launched or refused.  Last, a torch
emulation of the CUDA chunk tile's arithmetic order (page-wise online
softmax, P rounded to bf16 after the V scale) against JAX's E, at the
same tolerance: the one rounding the card adds stays inside it.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.ops.pallas import paged as JP  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_ragged_chunk_attention,
    ragged_chunk_attention_plain,
    ragged_paged_attention_ref,
)
from crowdllama_tpu_torch.ops.quant import quantize_kv  # noqa: E402

ATOL, RTOL = 2e-2, 1e-2
H, HKV, DH, PAGE, NP, C = 4, 2, 16, 16, 6, 40


@pytest.fixture
def interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def _jx(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _chunk_case(seed: int, int8: bool):
    """q [C, H, Dh] and a 13-page pool (bf16, or int8 with bf16 scales);
    the slot's table row holds 6 distinct pages."""
    r = np.random.default_rng(seed)
    q = torch.from_numpy(r.standard_normal((C, H, DH)).astype(
        np.float32)).to(torch.bfloat16)
    pk = torch.from_numpy(r.standard_normal((13, HKV, PAGE, DH)).astype(
        np.float32)).to(torch.bfloat16)
    pv = torch.from_numpy(r.standard_normal((13, HKV, PAGE, DH)).astype(
        np.float32)).to(torch.bfloat16)
    pages = torch.tensor([7, 2, 11, 4, 0, 9], dtype=torch.int32)
    scales = {}
    if int8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, pk, pv, pages, scales


CASES = [  # (ctx_len, valid rows, softcap, window)
    (0, 40, 0.0, 0), (32, 27, 0.0, 0), (16, 40, 30.0, 0), (48, 33, 0.0, 9)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ctx,valid,softcap,window", CASES)
def test_chunk_plain_matches_jax_kernel(interpret_mode, ctx, valid, softcap,
                                        window, int8):
    q, pk, pv, pages, scales = _chunk_case(ctx + valid, int8)
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    kv_t = torch.tensor(ctx + valid, dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_ragged_chunk_attention(q, pk, pv, pages, ctx_t, kv_t, 0.25,
                                       **scales, **kw)
    jscales = {k: _jx(v) for k, v in scales.items()}
    want = JP.flash_ragged_chunk_attention(
        _jx(q), _jx(pk), _jx(pv), _jx(pages), jnp.int32(ctx),
        jnp.int32(ctx + valid), 0.25, **jscales, **kw)
    assert got.shape == (C, H, DH) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got[:valid].float().numpy(),
                               np.asarray(want, np.float32)[:valid],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ctx,valid,softcap,window", CASES)
def test_chunk_plain_matches_the_ragged_reference_chunk_rows(ctx, valid,
                                                             softcap, window):
    """Kernel C's plain version reads the chunk's own KV as operands and the
    context from the pool; E reads both from the pool.  Fed the pool's
    chunk rows, the two agree on the valid rows (fp32, within 1e-5)."""
    q, pk, pv, pages, _ = _chunk_case(ctx + valid, False)
    q, pk, pv = q.float(), pk.float(), pv.float()
    kw = dict(softcap=softcap, sliding_window=window)
    got = ragged_chunk_attention_plain(q, pk, pv, pages, ctx, ctx + valid,
                                       0.25, **kw)
    pos = np.minimum(ctx + np.arange(C), ctx + valid - 1)
    rows = pages[pos // PAGE].long()
    chunk_k = pk[rows, :, pos % PAGE].transpose(0, 1)[None]
    chunk_v = pv[rows, :, pos % PAGE].transpose(0, 1)[None]
    table = pages[None]
    ref = ragged_paged_attention_ref(
        torch.cat([torch.zeros((1, H, DH)), q]), chunk_k, chunk_v, pk, pv,
        table, torch.tensor([0, valid], dtype=torch.int32),
        torch.tensor([1, ctx + valid], dtype=torch.int32), 0, 0.25, **kw)
    torch.testing.assert_close(got[:valid], ref[1:1 + valid], atol=1e-5,
                               rtol=0)


def _tile_emulation(q, pk, pv, pages, ctx, kv, scale, softcap=0.0,
                    window=0, k_scale=None, v_scale=None):
    """The arithmetic order of the CUDA chunk tile, in torch: one page at a
    time, logits ``dot * scale`` (times the K scale) then the softcap and
    the mask; an fp32 online softmax rescaled once per page; P summed into
    l in fp32, times the V scale, then rounded to bf16 before P V (the JAX
    kernel keeps P in fp32)."""
    c, h, dh = q.shape
    _, hkv, page, _ = pk.shape
    g = h // hkv
    rows = q.float().reshape(c, hkv, g, dh).transpose(0, 1).reshape(
        hkv, c * g, dh)                       # query-major rows per kv head
    qpos = (ctx + torch.arange(c)).repeat_interleave(g)[:, None]
    m = torch.full((hkv, c * g), JP.NEG_INF)
    l = torch.zeros((hkv, c * g))
    o = torch.zeros((hkv, c * g, dh))
    for n, pid in enumerate(pages.tolist()):
        kpos = n * page + torch.arange(page)[None, :]
        s = torch.einsum("hrd,hkd->hrk", rows, pk[pid].float()) * scale
        if k_scale is not None:
            s = s * k_scale[pid].float()[:, None, :]
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = (kpos < kv) & (kpos <= qpos)
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, JP.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]) * mask
        l = l * alpha + p.sum(-1)
        if v_scale is not None:
            p = p * v_scale[pid].float()[:, None, :]
        p = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("hrk,hkd->hrd", p,
                                                pv[pid].float())
        m = m_new
    out = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.reshape(hkv, c, g, dh).transpose(0, 1).reshape(c, h, dh).to(
        torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ctx,valid,softcap,window", CASES)
def test_bf16_probabilities_stay_within_tolerance_of_jax(
        interpret_mode, ctx, valid, softcap, window, int8):
    """The CUDA chunk tile rounds P to bf16 where JAX's kernel keeps it in
    fp32: emulated in torch, that order stays within the kernels'
    tolerance of JAX's E in interpret mode on the valid rows."""
    q, pk, pv, pages, scales = _chunk_case(ctx + valid, int8)
    kw = dict(softcap=softcap, window=window)
    got = _tile_emulation(q, pk, pv, pages, ctx, ctx + valid, 0.25, **scales,
                          **kw)
    jscales = {k: _jx(v) for k, v in scales.items()}
    want = JP.flash_ragged_chunk_attention(
        _jx(q), _jx(pk), _jx(pv), _jx(pages), jnp.int32(ctx),
        jnp.int32(ctx + valid), 0.25, softcap=softcap, sliding_window=window,
        **jscales)
    np.testing.assert_allclose(got[:valid].float().numpy(),
                               np.asarray(want, np.float32)[:valid],
                               atol=ATOL, rtol=RTOL)


def _launches():
    return (flash_ragged_chunk_attention.launches,
            flash_ragged_chunk_attention.launches_int8)


def test_chunk_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    q, pk, pv, pages, _ = _chunk_case(1, False)
    ctx, kv = torch.tensor(8, dtype=torch.int32), torch.tensor(
        30, dtype=torch.int32)
    before = _launches()
    torch.testing.assert_close(
        flash_ragged_chunk_attention(q, pk, pv, pages, ctx, kv, 0.25),
        ragged_chunk_attention_plain(q, pk, pv, pages, ctx, kv, 0.25),
        rtol=0, atol=0)
    meta = [x.to("meta") for x in (q, pk, pv, pages, ctx, kv)]
    with pytest.raises(ValueError):  # not a CUDA tensor: refused
        flash_ragged_chunk_attention(*meta, 0.25)
    q8, pk8, pv8, _, scales = _chunk_case(1, True)
    with pytest.raises(ValueError, match="scale|int8"):
        flash_ragged_chunk_attention(q8, pk8, pv8, pages, ctx, kv, 0.25)
    assert _launches() == before
