"""Kernel D's split-KV decode over the contiguous cache
(``csrc/flash_decode.cu`` on the stages of ``csrc/decode_common.cuh``)
emulated in plain PyTorch on the CPU.

The CUDA kernel runs one block per (kv head, slot, split) of
``flash_decode_launch_shape``: split i of a (slot, kv head) walks the keys
``[i * span, (i + 1) * span)`` of ``flash_decode_plan(S)`` below
``min(seq_len, S)`` and, with a window, from its first visible key; a
split with no such key returns at once; one live split writes its output
directly, several write fp32 partials (running max m, sum l, unnormalised
output acc per query head) that the last block merges in split order.
This file computes the same blocks and merge with torch (``split_decode``),
from the package's own plan and launch shape, and holds it on inputs made
from a numpy seed against:

- the port's plain version ``decode_attention_plain``: fp32 within 1e-5,
  bf16 within 2e-2 (one bf16 rounding of outputs ~1);
- JAX's ``flash_decode_attention`` run in interpret mode, as
  ``tests/test_torch_contiguous.py`` runs it, within the same tolerances
  (rows of zero-length slots, zeros from both, included).

Lengths sit at the split and stage edges (0, 1, 63, 64, 65, 255, 256,
257, S - 1, S) over caches of S = 512 (a multiple of the 256-key split),
600 and 300 (not; 300 also not a multiple of the 64-key stage), with
softcap and with windows that leave whole splits empty.  The plan depends
on S alone, so the grid is sized without reading the lengths.
"""

import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.ops.pallas import flash as JF  # noqa: E402
from crowdllama_tpu_torch.ops.attention import NEG_INF, _softcap  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.flash import (  # noqa: E402
    decode_attention_plain,
    flash_decode_attention,
    flash_decode_launch_shape,
    flash_decode_plan,
)
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    DECODE_STAGE_KEYS,
    MAX_SPLITS,
)

TOL = {"fp32": 1e-5, "bf16": 2e-2}
SIZES = [512, 600, 300]


def _lens(s: int) -> list[int]:
    return [0, 1, 63, 64, 65, 255, 256, 257, s - 1, s]


@pytest.fixture(autouse=True)
def _interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def split_decode(q, kc, vc, lens, scale, softcap=0.0,
                 window=0) -> torch.Tensor:
    """Kernel D's arithmetic, block by block of its grid, in fp32: block
    (h, b, i) gives (m, l, acc) per query head of kv head h over split i's
    live keys, or nothing; the merge reads the live splits in split order:
    M = max m, out = sum exp(m - M) acc / sum exp(m - M) l.  A slot with no
    key to see is zeros."""
    b, h, dh = q.shape
    _, hkv, s, _ = kc.shape
    g = h // hkv
    shape = flash_decode_launch_shape(q, kc)
    span = shape["span"]
    parts: dict[tuple[int, int], list] = {}
    for kv in range(shape["grid"][0]):
        for i in range(shape["grid"][1]):
            n = int(lens[i])
            qpos = n - 1
            bound = max(0, min(n, s))
            lo = max(0, qpos - window + 1) if window > 0 else 0
            s_lo, s_hi = lo // span, -(-bound // span)
            for sp in range(shape["grid"][2]):
                if sp < s_lo or sp >= s_hi:
                    continue  # the block returns at once
                k0, k1 = max(lo, sp * span), min(bound, (sp + 1) * span)
                kpos = torch.arange(k0, k1)
                qi = q[i, kv * g:(kv + 1) * g].float()
                logits = qi @ kc[i, kv, k0:k1].float().T * scale
                logits = _softcap(logits, softcap)
                seen = (kpos < n) & (kpos <= qpos)
                if window > 0:
                    seen &= kpos > qpos - window
                logits = torch.where(seen, logits,
                                     torch.full_like(logits, NEG_INF))
                m = logits.max(-1).values
                p = torch.exp(logits - m[:, None]) * seen
                parts.setdefault((i, kv), []).append(
                    (sp, m, p.sum(-1), p @ vc[i, kv, k0:k1].float()))
    out = torch.zeros((b, hkv, g, dh), dtype=torch.float32)
    for (i, kv), got in parts.items():
        got.sort(key=lambda x: x[0])  # split order, never arrival order
        big = torch.stack([m for _, m, _, _ in got]).max(0).values
        den = torch.zeros_like(big)
        acc = torch.zeros((g, dh))
        for _, m, l_, a in got:
            w = torch.exp(m - big)
            den = den + w * l_
            acc = acc + w[:, None] * a
        out[i, kv] = acc / torch.where(den == 0, torch.ones_like(den),
                                       den)[:, None]
    return out.reshape(b, h, dh).to(q.dtype)


def _case(kind: str, s: int, seed: int = 0, h: int = 4, hkv: int = 2,
          dh: int = 16):
    r = np.random.default_rng(seed)
    lens = _lens(s)
    q = r.standard_normal((len(lens), h, dh)).astype(np.float32)
    kc = r.standard_normal((len(lens), hkv, s, dh)).astype(np.float32)
    vc = r.standard_normal((len(lens), hkv, s, dh)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kc, vc))
    if kind == "bf16":
        tq, tk, tv = (x.to(torch.bfloat16) for x in (tq, tk, tv))
    return tq, tk, tv, torch.tensor(lens, dtype=torch.int32)


def _jx(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


# (softcap, window): none; softcap; a window of 40 (the longest slot's keys
# in its last split only, the others empty); windows of 300 (first key
# S - 300: split 0 empty at S 512 and 600, and at S 300 both splits live).
CASES = [(0.0, 0), (30.0, 0), (0.0, 40), (0.0, 300), (25.0, 300)]


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("softcap,window", CASES)
def test_split_decode_matches_plain_and_jax(kind, s, softcap, window):
    q, kc, vc, lens = _case(kind, s)
    kw = dict(softcap=softcap, sliding_window=window)
    got = split_decode(q, kc, vc, lens, 0.25, softcap=softcap, window=window)
    tol = TOL[kind]
    live = [i for i, n in enumerate(lens.tolist()) if n > 0]
    plain = decode_attention_plain(q, kc, vc, lens, 0.25, **kw)
    np.testing.assert_allclose(got[live].float().numpy(),
                               plain[live].float().numpy(), atol=tol, rtol=0)
    # The wrapper on CPU tensors is the plain version.
    assert torch.equal(flash_decode_attention(q, kc, vc, lens, 0.25, **kw),
                       plain)
    pallas = JF.flash_decode_attention(_jx(q), _jx(kc), _jx(vc), _jx(lens),
                                       0.25, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(pallas, jnp.float32)),
                               atol=tol, rtol=0)
    assert not got[0].any()  # the zero-length slot


@pytest.mark.parametrize("s,window,live", [
    (512, 0, [0, 1, 1, 1, 1, 1, 1, 2, 2, 2]),
    (512, 40, [0, 1, 1, 1, 1, 1, 1, 2, 1, 1]),
    (600, 0, [0, 1, 1, 1, 1, 1, 1, 2, 3, 3]),
    (600, 300, [0, 1, 1, 1, 1, 1, 1, 2, 2, 2]),
    (300, 40, [0, 1, 1, 1, 1, 1, 1, 2, 1, 1])])
def test_edge_lengths_cover_single_and_merged_splits(s, window, live):
    """The cases above reach every branch of the kernel: no key (zeros),
    one live split (written directly) and two or three merged, including
    slots whose first split is empty under the window."""
    span, splits = flash_decode_plan(s)
    assert span == 256 and splits == -(-s // 256)
    got = []
    for n in _lens(s):
        lo = max(0, n - window) if window > 0 else 0
        got.append(max(0, -(-min(n, s) // span) - lo // span))
    assert got == live


def test_plan_depends_only_on_the_cache_length():
    assert list(inspect.signature(flash_decode_plan).parameters) == ["s"]
    assert flash_decode_plan(2048) == (256, 8)   # the serving caches
    assert flash_decode_plan(300) == (256, 2)
    assert flash_decode_plan(1) == (256, 1)
    assert flash_decode_plan(8192) == (256, 32)
    assert flash_decode_plan(8193) == (320, 26)  # widened past 8,192 keys
    assert flash_decode_plan(131072) == (4096, 32)
    for s in range(1, 40000, 97):
        span, n = flash_decode_plan(s)
        assert span >= 256 and span % DECODE_STAGE_KEYS == 0
        assert 1 <= n <= MAX_SPLITS and span * (n - 1) < s <= span * n


@pytest.mark.parametrize("h,hkv,dh,live_blocks", [(32, 4, 64, 124),
                                                  (32, 8, 128, 248)])
def test_launch_shape_reads_no_lengths(h, hkv, dh, live_blocks):
    """The grid comes from the shapes of q and the cache alone: here from
    meta tensors, which hold no data.  At the kernel table's serving
    lengths over [8, Hkv, 2048, Dh] caches, 31 splits a kv head are live."""
    assert list(inspect.signature(flash_decode_launch_shape).parameters) \
        == ["q", "k_cache"]
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((8, h, dh), **meta)
    kc = torch.empty((8, hkv, 2048, dh), **meta)
    shape = flash_decode_launch_shape(q, kc)
    assert shape["grid"] == (hkv, 8, 8) and shape["threads"] == 256
    assert shape["rows"] == 8 * hkv
    assert shape["floats"] == 8 * hkv * 8 * (h // hkv) * (dh + 4)
    serve_lens = [1723, 1, 402, 2048, 77, 1200, 513, 960]
    live = sum(-(-n // shape["span"]) for n in serve_lens)
    assert live * hkv == live_blocks
