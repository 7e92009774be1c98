"""Kernel A's fp32 entry on the tensor cores (``csrc/flash_prefill.cu``
``prefill_tf_kernel``): its 3xTF32 arithmetic pinned on the CPU.

A numpy emulation of the kernel's order (key tiles of 32; each operand
split into hi = tf32(x), rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` does, and lo = x - hi, which the mma truncates to
TF32 toward zero; each product lo*hi +
hi*lo + hi*hi, small terms first, fp32 sums; logits in log2 units with
softcap and the mask; the online max and sum; P split as it is fed to P
V) stays within atol 1e-5 + rtol 1e-5 of JAX's fp32 prefill reference
(``crowdllama_tpu.ops.attention.prefill_attention``, the CPU route) and
of the port's plain version, the bound ``chip_smoke.py`` and the card
tests hold the kernel to, on the shapes they use: TinyLlama's 512-token
prompt (32 / 4 heads, Dh 64), Llama-3-8B's (32 / 8, Dh 128), Gemma-2-9b's
(16 / 8, Dh 256), a group of 7 at Dh 64 and 128, the distillation step
(16 x 64 tokens) at Dh 64 and 256, and padded prompts with softcap, a
window and rows that see no key; and against JAX's Pallas kernel in
interpret mode at a small shape, at each head dim.  At Dh 256 the kernel
splits O's columns between the two warps of a pair, which both compute
the whole S and P: every output element still sums its products in the
order it does at Dh 64 and 128, so one emulation models all three.  One TF32 product alone (the
hi*hi term) misses that bound at these shapes, which is why the kernel
takes three.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.ops import attention as JA  # noqa: E402
from crowdllama_tpu.ops.pallas import flash as JF  # noqa: E402
from crowdllama_tpu_torch.ops.attention import prefill_attention_ref  # noqa: E402

ATOL = RTOL = 1e-5   # the kernel's check on the card
TILE = 32            # keys a tile (TF_K)
LOG2E = np.float32(1.4426950408889634)
NEG_INF = np.float32(-1e30)


def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _truncate(x: np.ndarray) -> np.ndarray:
    """A TF32 operand as the mma reads it: the low 13 bits dropped."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32(x)
    return hi, _truncate(x - hi)


def _mm(a, b, terms: int) -> np.ndarray:
    """a @ b in the kernel's TF32 terms (3: lo*hi, hi*lo, hi*hi; 1: hi*hi
    alone), fp32 sums."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if terms == 1:
        return np.matmul(ah, bh)
    s = np.matmul(al, bh)
    s += np.matmul(ah, bl)
    s += np.matmul(ah, bh)
    return s


def emulate(q, k, v, pos, valid, scale, softcap=0.0, window=0, terms=3):
    """The kernel's attention in numpy: q [B, T, H, Dh], k/v [B, Hkv, T,
    Dh] fp32, positions [B, T], valid [B, T] bool."""
    b, t, h, dh = q.shape
    g = h // k.shape[1]
    qh = q.transpose(0, 2, 1, 3)                       # [B, H, T, Dh]
    kh = np.repeat(k, g, axis=1)
    vh = np.repeat(v, g, axis=1)
    qp = pos[:, None, :, None]                         # [B, 1, T, 1]
    m = np.full((b, h, t, 1), NEG_INF, np.float32)
    l = np.zeros((b, h, t, 1), np.float32)
    o = np.zeros((b, h, t, dh), np.float32)
    for k0 in range(0, t, TILE):
        sl = slice(k0, min(t, k0 + TILE))
        s = _mm(qh, kh[:, :, sl].transpose(0, 1, 3, 2), terms)
        s = s * np.float32(scale)
        if softcap > 0:
            s = np.float32(softcap) * np.tanh(s / np.float32(softcap))
        s = (s * LOG2E).astype(np.float32)
        kp = pos[:, None, None, sl]
        seen = valid[:, None, None, sl] & (kp <= qp)
        if window > 0:
            seen &= kp > qp - window
        s = np.where(seen, s, NEG_INF)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp2(m - m_new)
        mref = np.where(m_new == NEG_INF, np.float32(0), m_new)
        p = np.where(s == NEG_INF, np.float32(0), np.exp2(s - mref))
        l = l * alpha + p.sum(-1, keepdims=True)
        o = o * alpha + _mm(p.astype(np.float32), vh[:, :, sl], terms)
        m = m_new
    out = o / np.where(l == 0, np.float32(1), l)
    return out.transpose(0, 2, 1, 3).astype(np.float32)


def _case(seed, b, t, h, hkv, dh, plen=None, masked=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, h, dh)).astype(np.float32)
    k = r.standard_normal((b, hkv, t, dh)).astype(np.float32)
    v = r.standard_normal((b, hkv, t, dh)).astype(np.float32)
    ar = np.arange(t, dtype=np.int32)
    plen = t if plen is None else plen
    pos = np.repeat(np.minimum(ar, plen - 1)[None], b, 0)
    valid = np.repeat(((ar < plen) & (ar >= masked))[None], b, 0)
    return q, k, v, pos, valid


def _within(got, want, rows=slice(None)) -> float:
    """Max |got - want| over ``rows`` of the time axis, asserting the
    elementwise bound."""
    g, w = got[:, rows], want[:, rows]
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    return float(np.abs(g - w).max())


CASES = {
    # name: (b, t, h, hkv, dh, plen, masked, softcap, window)
    "tinyllama_512": (1, 512, 32, 4, 64, None, 0, 0.0, 0),
    "llama3_512": (1, 512, 32, 8, 128, None, 0, 0.0, 0),
    "group7_dh64": (1, 512, 28, 4, 64, None, 0, 0.0, 0),
    "group7_dh128": (1, 512, 28, 4, 128, None, 0, 0.0, 0),
    "distill_step": (16, 64, 32, 4, 64, None, 0, 0.0, 0),
    "padded_dh64": (2, 200, 32, 4, 64, 190, 5, 30.0, 17),
    "padded_dh128": (2, 200, 32, 8, 128, 190, 5, 30.0, 17),
    "gemma9_512": (1, 512, 16, 8, 256, None, 0, 0.0, 0),
    "distill_step_dh256": (16, 64, 16, 8, 256, None, 0, 0.0, 0),
    "padded_dh256": (2, 200, 16, 8, 256, 190, 5, 50.0, 17),
}


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_stays_within_1e5_of_jax_fp32(name):
    """The emulated kernel against JAX's fp32 reference and the port's
    plain version: every element within atol 1e-5 + rtol 1e-5 (rows that
    see no key excluded, as the card's check excludes them: the kernel
    writes zeros there)."""
    b, t, h, hkv, dh, plen, masked, softcap, window = CASES[name]
    q, k, v, pos, valid = _case(list(CASES).index(name), b, t, h, hkv, dh,
                                plen, masked)
    scale = dh ** -0.5
    got = emulate(q, k, v, pos, valid, scale, softcap, window)
    want = np.asarray(JA.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale, softcap=softcap, sliding_window=window,
        kv_valid=jnp.asarray(valid)), np.float32)
    plain = prefill_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v, pos)), scale,
        softcap=softcap, sliding_window=window,
        kv_valid=torch.from_numpy(valid)).numpy()
    rows = slice(masked, None)
    _within(got, want, rows)
    _within(got, plain, rows)
    assert not got[:, :masked].any()  # rows that see no key


@pytest.mark.parametrize("name", ["tinyllama_512", "llama3_512"])
def test_one_tf32_product_misses_the_bound(name):
    """The hi*hi term alone (a single TF32 pass) is off by more than the
    1e-5 bound at the serving shapes: the reason for three terms."""
    b, t, h, hkv, dh, plen, masked, softcap, window = CASES[name]
    q, k, v, pos, valid = _case(list(CASES).index(name), b, t, h, hkv, dh)
    scale = dh ** -0.5
    one = emulate(q, k, v, pos, valid, scale, terms=1)
    want = np.asarray(JA.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale, kv_valid=jnp.asarray(valid)), np.float32)
    assert (np.abs(one - want) > ATOL + RTOL * np.abs(want)).any()


@pytest.fixture
def interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


@pytest.mark.parametrize("dh,hkv", [(64, 2), (128, 2), (256, 2)])
def test_3xtf32_matches_the_pallas_kernel_in_interpret_mode(interpret_mode,
                                                            dh, hkv):
    """The emulation against JAX's A itself (Pallas, interpret mode, fp32
    tiles) on a padded prompt with softcap and a window."""
    q, k, v, pos, valid = _case(11, 1, 128, 8, hkv, dh, plen=120, masked=3)
    scale = dh ** -0.5
    got = emulate(q, k, v, pos, valid, scale, 30.0, 40)
    want = np.asarray(JF.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale, softcap=30.0, sliding_window=40,
        kv_valid=jnp.asarray(valid)), np.float32)
    _within(got, want, slice(3, None))
