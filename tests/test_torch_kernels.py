"""The plain versions of the port's three attention kernels against the JAX
package's Pallas kernels (run in interpret mode, as tests/test_pallas.py
runs them) and its jnp references.

A: prefill (ops/cuda/flash.py), B: paged decode and C: ragged paged
attention (ops/cuda/paged.py).  On CPU tensors each wrapper runs its plain
version, which is what these tests hold.  Where the TPU kernel writes zeros
(rows that see no key, rows that carry no query) the jnp references — and
the port's plain versions, which follow them — hold other values the
engine discards, so those rows are compared against the references only.
Tolerances: fp32 1e-5, bf16 2e-2 (one bf16 rounding of outputs ~1).

The kernels themselves are held against their plain versions on the card
by ``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.ops import attention as JA  # noqa: E402
from crowdllama_tpu.ops.pallas import paged as JP  # noqa: E402
from crowdllama_tpu.ops.pallas.flash import (  # noqa: E402
    flash_prefill_attention as j_flash_prefill,
)
from crowdllama_tpu_torch.ops.cuda.flash import (  # noqa: E402
    flash_prefill_attention,
)
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_paged_decode_attention,
    ragged_paged_attention,
)

TOL = {np.float32: 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def _both(arr, bf16: bool):
    """One numpy array as (torch, jax) inputs of the tested dtype."""
    if bf16:
        return (torch.from_numpy(arr).to(torch.bfloat16),
                jnp.asarray(arr, jnp.bfloat16))
    return torch.from_numpy(arr), jnp.asarray(arr)


def _close(got, want, rows=None, bf16=False):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if rows is not None:
        g, w = g[rows], w[rows]
    np.testing.assert_allclose(g, w, atol=TOL["bf16" if bf16 else np.float32],
                               rtol=0)


# ------------------------------------------------------------------ kernel A

def _prefill_case(seed, b, t, plen, masked):
    r = np.random.default_rng(seed)
    h, hkv, dh = 4, 2, 16
    q = r.standard_normal((b, t, h, dh)).astype(np.float32)
    k = r.standard_normal((b, hkv, t, dh)).astype(np.float32)
    v = r.standard_normal((b, hkv, t, dh)).astype(np.float32)
    pos = np.minimum(np.arange(t), plen - 1)[None].repeat(b, 0).astype(
        np.int32)
    valid = (np.arange(t) < plen)[None].repeat(b, 0)
    valid[:, :masked] = False  # queries < masked see no key at all
    return q, k, v, pos, valid


@pytest.mark.parametrize("softcap,window,plen,masked,bf16", [
    (0.0, 0, 64, 0, False), (30.0, 0, 64, 0, False), (0.0, 5, 64, 0, False),
    (0.0, 0, 41, 0, False), (20.0, 9, 50, 3, False), (0.0, 0, 64, 0, True),
    (30.0, 7, 45, 2, True)])
def test_prefill_plain_matches_jax(softcap, window, plen, masked, bf16):
    q, k, v, pos, valid = _prefill_case(0, 2, 64, plen, masked)
    tq, jq = _both(q, bf16)
    tk, jk = _both(k, bf16)
    tv, jv = _both(v, bf16)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_prefill_attention(tq, tk, tv, torch.from_numpy(pos), 0.25,
                                  kv_valid=torch.from_numpy(valid), **kw)
    ref = JA.prefill_attention_ref(jq, jk, jv, jnp.asarray(pos), 0.25,
                                   kv_valid=jnp.asarray(valid), **kw)
    pallas = j_flash_prefill(jq, jk, jv, jnp.asarray(pos), 0.25,
                             kv_valid=jnp.asarray(valid), **kw)
    _close(got, ref, bf16=bf16)
    live = (slice(None), slice(masked, None))
    _close(got, pallas, rows=live, bf16=bf16)
    # The TPU kernel (and the CUDA kernel) write zeros on all-masked rows.
    assert not np.asarray(pallas, np.float32)[:, :masked].any()


# --------------------------------------------------------------- kernels B/C

def _pool(seed, pages, hkv, page, dh):
    r = np.random.default_rng(seed)
    return (r.standard_normal((pages, hkv, page, dh)).astype(np.float32),
            r.standard_normal((pages, hkv, page, dh)).astype(np.float32))


@pytest.mark.parametrize("softcap,window,bf16", [
    (0.0, 0, False), (30.0, 0, False), (0.0, 9, False), (25.0, 13, True)])
def test_paged_decode_plain_matches_jax(softcap, window, bf16):
    """Mixed lengths, a slot on the dump page (len 1) and a zero-length
    slot, whose every key is masked."""
    b, h, hkv, dh, page, np_ = 4, 4, 2, 16, 32, 4
    pk, pv = _pool(1, 17, hkv, page, dh)
    q = np.random.default_rng(2).standard_normal((b, h, dh)).astype(
        np.float32)
    table = np.array([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                      [9, 10, 0, 0]], np.int32)
    lens = np.array([100, 1, 0, 40], np.int32)
    tq, jq = _both(q, bf16)
    tk, jk = _both(pk, bf16)
    tv, jv = _both(pv, bf16)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                       torch.from_numpy(lens), 0.25, **kw)
    jt, jl = jnp.asarray(table), jnp.asarray(lens)
    w = np_ * page
    view_k = jk[jt].transpose(0, 2, 1, 3, 4).reshape(b, hkv, w, dh)
    view_v = jv[jt].transpose(0, 2, 1, 3, 4).reshape(b, hkv, w, dh)
    ref = JA.decode_attention_ref(jq, view_k, view_v, jl, 0.25, **kw)
    pallas = JP.flash_paged_decode_attention(jq, jk, jv, jt, jl, 0.25, **kw)
    _close(got, ref, bf16=bf16)
    _close(got, pallas, rows=[0, 1, 3], bf16=bf16)


@pytest.mark.parametrize("softcap,window,chunk_len,bf16", [
    (0.0, 0, 40, False), (30.0, 0, 40, False), (0.0, 9, 40, False),
    (0.0, 0, 27, False), (20.0, 11, 40, True)])
def test_ragged_plain_matches_jax(softcap, window, chunk_len, bf16):
    """Decode rows at mixed lengths, an inactive slot (q_len 0) and a
    prefill chunk spanning a partial second query block; rows past the
    chunk's valid length carry no query."""
    b, h, hkv, dh, page = 3, 4, 2, 16, 32
    c, ctx, chunk_slot = 40, 16, 2
    pk, pv = _pool(3, 16, hkv, page, dh)
    q = np.random.default_rng(4).standard_normal((b + c, h, dh)).astype(
        np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    q_lens = np.array([1, 0, 0, chunk_len], np.int32)
    kv_lens = np.array([33, 1, 1, ctx + chunk_len], np.int32)
    cpos = ctx + np.arange(c)
    ck = pk[table[chunk_slot][cpos // page], :, cpos % page].transpose(
        1, 0, 2)[None]
    cv = pv[table[chunk_slot][cpos // page], :, cpos % page].transpose(
        1, 0, 2)[None]
    tq, jq = _both(q, bf16)
    tk, jk = _both(pk, bf16)
    tv, jv = _both(pv, bf16)
    tck, jck = _both(np.ascontiguousarray(ck), bf16)
    tcv, jcv = _both(np.ascontiguousarray(cv), bf16)
    kw = dict(softcap=softcap, sliding_window=window)
    got = ragged_paged_attention(
        tq, tck, tcv, tk, tv, torch.from_numpy(table),
        torch.from_numpy(q_lens), torch.from_numpy(kv_lens), chunk_slot,
        0.25, **kw)
    jt = jnp.asarray(table)
    ref = JP.ragged_paged_attention_ref(
        jq, jck, jcv, jk, jv, jt, jnp.asarray(q_lens), jnp.asarray(kv_lens),
        jnp.int32(chunk_slot), 0.25, **kw)
    pallas = JP.flash_ragged_paged_attention(
        jq, jk, jv, jt, jnp.asarray(q_lens), jnp.asarray(kv_lens),
        jnp.int32(chunk_slot), 0.25, **kw)
    _close(got, ref, bf16=bf16)
    live = [0] + [b + i for i in range(chunk_len)]
    _close(got, pallas, rows=live, bf16=bf16)
