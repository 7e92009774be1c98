"""Kernel B's split-KV decode (``csrc/paged_attention.cu``) emulated in
plain PyTorch on the CPU.

The CUDA kernel cuts each (slot, kv head)'s keys into the runs of
``split_plan`` (one block each), computes per split the fp32 partial
(running max m, sum l, unnormalised output acc) of every query head, and
merges the live splits in split order in the same launch.  This file
computes the same partials and merge with torch (``split_decode``), using
the package's own plan and launch shape, and holds it on inputs made from
a numpy seed against:

- the port's plain version ``paged_decode_attention_plain``: fp32 within
  1e-5 (bf16 inputs: 2e-2, one bf16 rounding of outputs ~1);
- JAX's ``flash_paged_decode_attention`` run in interpret mode, as
  ``tests/test_torch_kernels.py`` runs it, within the same tolerances
  (rows of zero-length slots, zeros from both, included).

Lengths sit at the split edges (0, 1, page - 1, page, page + 1, one
split's keys, one more, the table's full width), on bf16-valued, fp32 and
int8 pools (bf16 scales: the K scale on the score, the V scale on the
probability after l is summed), with softcap and with windows that leave
whole splits empty.  The plan depends on the table width and the page
alone, so every tensor-parallel share of a pool is split as the whole pool
is; the emulated shares are bit-equal to the whole pool's answer.
"""

import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.ops.pallas import paged as JP  # noqa: E402
from crowdllama_tpu_torch.ops.attention import NEG_INF, _softcap  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    decode_launch_shape,
    flash_paged_decode_attention,
    paged_decode_attention_plain,
    split_plan,
)
from crowdllama_tpu_torch.ops.quant import quantize_kv  # noqa: E402

TOL = {"fp32": 1e-5, "bf16": 2e-2, "int8": 1e-5}

# Page 32 and a table of 20 pages: splits of 8 pages (256 keys), three of
# them.  Slot lengths at the split edges; the last is the table's width.
PAGE, NP = 32, 20
LENS = [0, 1, PAGE - 1, PAGE, PAGE + 1, 256, 257, NP * PAGE]


@pytest.fixture(autouse=True)
def _interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def _gather(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, page, ...] -> [Hkv, NP * page, ...] of one table row."""
    g = x[row.long()]
    return g.transpose(0, 1).reshape(x.shape[1], -1, *x.shape[3:])


def split_decode(q, pool_k, pool_v, table, lens, scale, softcap=0.0,
                 window=0, k_scale=None, v_scale=None) -> torch.Tensor:
    """Kernel B's arithmetic, split by split, in fp32: for each slot the
    live splits (keys from the window's first to min(len, NP * page)) each
    give (m, l, acc) per query head; the merge reads them in split order:
    M = max m, out = sum exp(m - M) acc / sum exp(m - M) l.  A slot with
    no key to see is zeros.  The split that holds no live key returns
    without a partial in the kernel; here it is skipped the same way (its
    partial would be m = NEG_INF, l = 0, which the merge weighs at 0)."""
    b, h, dh = q.shape
    _, hkv, page, _ = pool_k.shape
    np_ = table.shape[1]
    pps, _ = split_plan(np_, page)
    span = pps * page
    out = torch.zeros((b, hkv, h // hkv, dh), dtype=torch.float32)
    for i in range(b):
        n = int(lens[i])
        qpos = n - 1
        bound = max(0, min(n, np_ * page))
        lo = max(0, qpos - window + 1) if window > 0 else 0
        s_lo, s_hi = lo // span, -(-bound // span)
        k, v = _gather(pool_k, table[i]).float(), _gather(pool_v, table[i]).float()
        ks = vs = None
        if k_scale is not None:
            ks = _gather(k_scale, table[i]).float()
            vs = _gather(v_scale, table[i]).float()
        qi = q[i].float().reshape(hkv, h // hkv, dh)
        parts = []
        for s in range(s_lo, s_hi):
            k0, k1 = max(lo, s * span), min(bound, (s + 1) * span)
            kpos = torch.arange(k0, k1)
            logits = torch.einsum("hgd,hkd->hgk", qi, k[:, k0:k1]) * scale
            if ks is not None:
                logits = logits * ks[:, None, k0:k1]
            logits = _softcap(logits, softcap)
            seen = (kpos < n) & (kpos <= qpos)
            if window > 0:
                seen &= kpos > qpos - window
            logits = torch.where(seen, logits, torch.full_like(logits,
                                                               NEG_INF))
            m = logits.max(-1).values
            p = torch.exp(logits - m[..., None]) * seen
            l_ = p.sum(-1)
            if vs is not None:
                p = p * vs[:, None, k0:k1]
            parts.append((m, l_, torch.einsum("hgk,hkd->hgd", p,
                                              v[:, k0:k1])))
        if not parts:
            continue
        big = torch.stack([m for m, _, _ in parts]).max(0).values
        den = torch.zeros_like(big)
        acc = torch.zeros_like(out[i])
        for m, l_, a in parts:
            w = torch.exp(m - big)
            den = den + w * l_
            acc = acc + w[..., None] * a
        out[i] = acc / torch.where(den == 0, torch.ones_like(den),
                                   den)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def _case(kind: str, seed: int = 0, h: int = 4, hkv: int = 2, dh: int = 16):
    """Pools of distinct random pages per slot (the last page is the dump
    page that pads every table row), q, table and the edge lengths."""
    r = np.random.default_rng(seed)
    need = [-(-n // PAGE) for n in LENS]
    pages = sum(need) + 1
    pk = r.standard_normal((pages, hkv, PAGE, dh)).astype(np.float32)
    pv = r.standard_normal((pages, hkv, PAGE, dh)).astype(np.float32)
    q = r.standard_normal((len(LENS), h, dh)).astype(np.float32)
    table = np.full((len(LENS), NP), pages - 1, np.int32)
    perm = r.permutation(pages - 1)
    used = 0
    for i, k in enumerate(need):
        table[i, :k] = perm[used:used + k]
        used += k
    tq, tk, tv = (torch.from_numpy(x) for x in (q, pk, pv))
    scales = {}
    if kind == "bf16":
        tq, tk, tv = (x.to(torch.bfloat16) for x in (tq, tk, tv))
    elif kind == "int8":
        (tk, ks), (tv, vs) = quantize_kv(tk), quantize_kv(tv)
        scales = dict(k_scale=ks, v_scale=vs)
    return (tq, tk, tv, torch.from_numpy(table),
            torch.tensor(LENS, dtype=torch.int32), scales)


def _jx(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


# (softcap, window): none; softcap; a window that leaves splits 0 and 1 of
# the longest slot empty (first key 600) and splits 257's first split live
# from key 217; a window that empties split 0 only (first key 340).
CASES = [(0.0, 0), (30.0, 0), (0.0, 40), (0.0, 300), (25.0, 300)]


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("softcap,window", CASES)
def test_split_decode_matches_plain_and_jax(kind, softcap, window):
    q, pk, pv, table, lens, scales = _case(kind)
    kw = dict(softcap=softcap, sliding_window=window)
    got = split_decode(q, pk, pv, table, lens, 0.25, softcap=softcap,
                       window=window, **scales)
    tol = TOL[kind]
    live = [i for i, n in enumerate(LENS) if n > 0]
    plain = paged_decode_attention_plain(q, pk, pv, table, lens, 0.25, **kw,
                                         **scales)
    np.testing.assert_allclose(got[live].float().numpy(),
                               plain[live].float().numpy(), atol=tol, rtol=0)
    # The wrapper on CPU tensors is the plain version.
    assert torch.equal(flash_paged_decode_attention(
        q, pk, pv, table, lens, 0.25, **kw, **scales), plain)
    jscales = {k: _jx(v) for k, v in scales.items()}
    pallas = JP.flash_paged_decode_attention(
        _jx(q), _jx(pk), _jx(pv), _jx(table), _jx(lens), 0.25, **kw,
        **jscales)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(pallas, jnp.float32)),
                               atol=tol, rtol=0)
    assert not got[0].any()  # the zero-length slot


@pytest.mark.parametrize("window,live", [
    (0, [0, 1, 1, 1, 1, 1, 2, 3]), (40, [0, 1, 1, 1, 1, 1, 2, 1]),
    (300, [0, 1, 1, 1, 1, 1, 2, 2])])
def test_edge_lengths_cover_single_and_merged_splits(window, live):
    """The cases above reach every branch of the kernel: no key (zeros),
    one live split (written directly) and two or three merged, including
    slots whose first split is empty under the window."""
    pps, splits = split_plan(NP, PAGE)
    span = pps * PAGE
    assert (pps, splits) == (8, 3)
    got = []
    for n in LENS:
        lo = max(0, n - window) if window > 0 else 0
        got.append(max(0, -(-min(n, NP * PAGE) // span) - lo // span))
    assert got == live


def test_split_plan_depends_only_on_table_width_and_page():
    assert list(inspect.signature(split_plan).parameters) == ["np_", "page"]
    assert split_plan(16, 128) == (2, 8)     # the serving shapes
    assert split_plan(16, 16) == (16, 1)
    assert split_plan(600, 16) == (19, 32)   # at most 32 splits
    assert split_plan(1, 128) == (2, 1)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shares_split_as_the_whole_pool(tp):
    """Every tensor-parallel share of a pool (kv-major heads) gets the
    whole pool's plan and grid depth, and its emulated output is, head for
    head, the whole pool's bit for bit."""
    q, pk, pv, table, lens, scales = _case("fp32", seed=1, h=16, hkv=4)

    def cut(x):
        return [part.contiguous() for part in x.chunk(tp, dim=1)]

    whole = decode_launch_shape([q], [pk], table)
    shares = decode_launch_shape(cut(q), cut(pk), table)
    assert (shares["pps"], shares["splits"]) == (whole["pps"],
                                                 whole["splits"])
    assert shares["grid"] == whole["grid"]   # (ranks x Hkv, B, splits)
    assert shares["threads"] == whole["threads"]
    per_rank = decode_launch_shape(cut(q)[:1], cut(pk)[:1], table)
    assert per_rank["grid"][1:] == whole["grid"][1:]
    full = split_decode(q, pk, pv, table, lens, 0.25, window=300)
    parts = [split_decode(qs, ks, vs, table, lens, 0.25, window=300)
             for qs, ks, vs in zip(cut(q), cut(pk), cut(pv))]
    assert torch.equal(torch.cat(parts, dim=1), full)


def test_tp_wrapper_refuses_more_ranks_on_a_device_than_one_launch_takes():
    """Kernel F folds the ranks of a device into one launch of B's grid,
    which carries at most MAX_RANKS ranks' pointers."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        MAX_RANKS,
        flash_paged_decode_attention_tp,
    )

    n = MAX_RANKS + 1
    meta = dict(device="meta", dtype=torch.bfloat16)
    qs = [torch.empty((2, 4, 64), **meta) for _ in range(n)]
    pools = [torch.empty((5, 2, 128, 64), **meta) for _ in range(n)]
    table = torch.empty((2, 4), device="meta", dtype=torch.int32)
    lens = torch.empty((2,), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {MAX_RANKS} ranks"):
        flash_paged_decode_attention_tp(qs, pools, pools, table, lens, 0.125)
