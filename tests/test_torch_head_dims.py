"""The port at head dims 80 (H2O-Danube-1.8B), 96, 128 (Llama-3, Mistral,
Qwen, Gemma-2-27b) and 256 (Gemma-2-9b and -2b) against the JAX package, on
the CPU.  Every test runs at each (``dh``).

- Every kernel's plain version (what its wrapper runs on CPU tensors)
  against the JAX kernel in interpret mode: A at groups of 4 and 7 with
  softcap, window and padded rows; B, C, E on bf16 and int8 pools; D over
  the contiguous cache; F on a 2-device CPU mesh.  Tolerance 2e-2 +
  1e-2·|x| on bf16 inputs (both sides accumulate in fp32 in different
  orders, then round to bf16); rows where the TPU kernel writes zeros (no
  key, no query) are left out, as in ``tests/test_torch_kernels.py``.
- A torch emulation of kernel A's order on the CUDA tile (query blocks of
  128 / G rows, key tiles of 8192 / Dh keys rounded down to a multiple of
  32: 96 at Dh 80, 64 at Dh 96 and 128 and 32 at Dh 256, up to the block's causal bound, positions and valid flags per key,
  an online softmax rescaled once per tile, P rounded to bf16) against
  JAX's A in interpret mode, at the same tolerance, all-masked rows zeros
  on both.  Where the tile reads Q (registers below Dh 256, shared memory
  at Dh 256) and whether a k-step pairs with another (Dh 80 ends on an odd
  one) changes no sum: each S element adds its k-steps in the same order.
- The model and the engine on ``tiny-test`` with ``head_dim`` 80, 96 and
  128 and on
  ``tiny-test-gemma`` (softcaps, post-norms, a window of 32 on every
  other layer, group 2) with ``head_dim=256`` (from
  ``dataclasses.replace``; registered for the test in both packages'
  registries, handed to ``TorchEngine`` as its ``model_config``): prefill
  logits and K/V against JAX's on the same fp32 weights (within 1e-4),
  and greedy streams token-identical to ``JaxEngine`` on the permutation
  checkpoint, paged (bf16 and int8 pools, ragged chunks, a prefix hit and
  a prompt longer than the window) and contiguous (legacy chunks).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import config as JC  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.ops.pallas import flash as JF  # noqa: E402
from crowdllama_tpu.ops.pallas import paged as JP  # noqa: E402
from crowdllama_tpu.parallel import mesh as JM  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models import config as TC  # noqa: E402
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.flash import (  # noqa: E402
    flash_decode_attention,
    flash_prefill_attention,
)
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_paged_decode_attention,
    flash_paged_decode_attention_tp,
    flash_ragged_chunk_attention,
    ragged_paged_attention,
)
from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv  # noqa: E402

ATOL, RTOL = 2e-2, 1e-2
HEAD_DIMS = (80, 96, 128, 256)
NEG_INF = -1e30

# Every test runs at each head dim.
pytestmark = pytest.mark.parametrize("dh", HEAD_DIMS)


@pytest.fixture
def interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def _bf(r, shape) -> torch.Tensor:
    return torch.from_numpy(r.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


def _jx(x: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _close(got: torch.Tensor, want, rows=None):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if rows is not None:
        g, w = g[rows], w[rows]
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ kernel A

def _prefill_case(seed: int, h: int, hkv: int, dh: int, t: int = 48,
                  plen: int = 41, masked: int = 3):
    """Two batch rows padded past their prompt (positions clamped at plen
    - 1, padding keys invalid); row 1's first ``masked`` keys invalid too,
    so its first queries see no key."""
    r = np.random.default_rng(seed)
    q, k, v = _bf(r, (2, t, h, dh)), _bf(r, (2, hkv, t, dh)), _bf(
        r, (2, hkv, t, dh))
    pos = torch.clamp(torch.arange(t, dtype=torch.int32),
                      max=plen - 1)[None].repeat(2, 1)
    valid = (torch.arange(t) < plen)[None].repeat(2, 1)
    valid[1, :masked] = False
    return q, k, v, pos, valid


A_CASES = [  # (query heads, kv heads, softcap, window): groups of 4 and 7
    (8, 2, 0.0, 0), (8, 2, 30.0, 9), (14, 2, 0.0, 0), (14, 2, 25.0, 13)]


@pytest.mark.parametrize("h,hkv,softcap,window", A_CASES)
def test_prefill_plain_matches_jax_kernel(interpret_mode, dh, h, hkv,
                                          softcap, window):
    q, k, v, pos, valid = _prefill_case(h + window, h, hkv, dh)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_prefill_attention(q, k, v, pos, dh ** -0.5, kv_valid=valid,
                                  **kw)
    want = JF.flash_prefill_attention(_jx(q), _jx(k), _jx(v), _jx(pos),
                                      dh ** -0.5, kv_valid=_jx(valid), **kw)
    assert got.shape == (2, 48, h, dh) and got.dtype == torch.bfloat16
    _close(got[0], want[0])
    _close(got[1, 3:], want[1, 3:])
    assert not np.asarray(want, np.float32)[1, :3].any()


def a_tile(dh: int) -> int:
    """Keys of kernel A's staged tile (``tc_tile`` in
    csrc/attention_common.cuh): 8192 / Dh rounded down to a multiple of
    32."""
    return 8192 // dh // 32 * 32


def test_a_tile_sizes(dh):
    assert a_tile(dh) == {80: 96, 96: 64, 128: 64, 256: 32}[dh]
    assert a_tile(dh) % 32 == 0


def _tile_emulation_a(q, k, v, pos, valid, scale, softcap=0.0, window=0):
    """Kernel A's order on the CUDA tile, in torch: per (batch row, kv
    head, block of 128 // G queries), tiles of ``a_tile(dh)`` keys (96 at
    Dh 80, 64 at Dh 96 and 128, 32 at Dh 256) from key 0 up to the block's causal bound min(T, q0 + 128 // G) (whole tiles: keys past
    the bound but inside the last tile are masked by their positions and
    flags, not skipped), logits dot * scale then the softcap, masked where
    kv_valid fails, kpos > qpos or the window drops the key; an fp32
    online softmax rescaled once per tile; P summed into l in fp32 and
    rounded to bf16 before P V; rows that saw no key are zeros."""
    b, t, h, dh = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qb, tile = 128 // g, a_tile(dh)
    out = torch.zeros((b, t, h, dh))
    for bi in range(b):
        for hi in range(hkv):
            for q0 in range(0, t, qb):
                rows = q[bi, q0:q0 + qb, hi * g:(hi + 1) * g].float()
                nq = rows.shape[0]
                rows = rows.reshape(nq * g, dh)
                qpos = pos[bi, q0:q0 + nq].repeat_interleave(g)[:, None]
                m = torch.full((nq * g,), NEG_INF)
                l = torch.zeros(nq * g)
                o = torch.zeros((nq * g, dh))
                k_hi = min(t, q0 + qb)
                for base in range(0, k_hi, tile):
                    kk = k[bi, hi, base:base + tile].float()
                    vv = v[bi, hi, base:base + tile].float()
                    kpos = pos[bi, base:base + tile][None, :]
                    ok = valid[bi, base:base + tile][None, :] & (kpos <= qpos)
                    if window > 0:
                        ok &= kpos > qpos - window
                    s = rows @ kk.T * scale
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    ref = torch.where(m_new == NEG_INF,
                                      torch.zeros_like(m_new), m_new)
                    p = torch.exp(s - ref[:, None]) * ok
                    l = l * alpha + p.sum(-1)
                    p = p.to(torch.bfloat16).float()
                    o = o * alpha[:, None] + p @ vv
                    m = m_new
                res = o / torch.where(l == 0, torch.ones_like(l), l)[:, None]
                out[bi, q0:q0 + nq, hi * g:(hi + 1) * g] = res.reshape(
                    nq, g, dh)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("h,hkv,softcap,window", A_CASES)
def test_a_tile_order_stays_within_tolerance_of_jax(interpret_mode, dh, h,
                                                    hkv, softcap, window):
    """The CUDA tile's order for kernel A (PosMask on the tile) against
    JAX's A: the bf16 rounding of P and the per-tile rescaling stay inside
    the kernels' tolerance, the causal tile walk drops no key any row sees,
    and all-masked rows are zeros on both."""
    q, k, v, pos, valid = _prefill_case(2 * h + window, h, hkv, dh,
                                        t=80, plen=70)
    got = _tile_emulation_a(q, k, v, pos, valid, dh ** -0.5, softcap, window)
    want = JF.flash_prefill_attention(
        _jx(q), _jx(k), _jx(v), _jx(pos), dh ** -0.5, kv_valid=_jx(valid),
        softcap=softcap, sliding_window=window)
    _close(got, want)


# ------------------------------------------------------------ kernels B, F

def _decode_case(seed: int, int8: bool, dh: int, h: int = 8, hkv: int = 2,
                 page: int = 16):
    r = np.random.default_rng(seed)
    q = _bf(r, (4, h, dh))
    pk, pv = _bf(r, (17, hkv, page, dh)), _bf(r, (17, hkv, page, dh))
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([60, 1, 0, 23], dtype=torch.int32)
    scales = {}
    if int8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, pk, pv, table, lens, scales


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 9)])
def test_paged_decode_plain_matches_jax_kernel(interpret_mode, dh, int8,
                                               softcap, window):
    q, pk, pv, table, lens, scales = _decode_case(5, int8, dh)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_paged_decode_attention(q, pk, pv, table, lens, dh ** -0.5,
                                       **scales, **kw)
    want = JP.flash_paged_decode_attention(
        _jx(q), _jx(pk), _jx(pv), _jx(table), _jx(lens), dh ** -0.5,
        **{k: _jx(v) for k, v in scales.items()}, **kw)
    _close(got, want, rows=[0, 1, 3])  # slot 2 has no key: zeros on TPU


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tp_decode_plain_matches_jax_kernel(interpret_mode, dh, int8):
    """Kernel F's plain version on 2 kv-major shares against JAX's F on a
    2-device CPU mesh, and equal to B's plain version on the whole pool."""
    q, pk, pv, table, lens, scales = _decode_case(6, int8, dh)

    def cut(x):
        return [part.contiguous() for part in x.chunk(2, dim=1)]

    skw = {f"{k}s": cut(v) for k, v in scales.items()}
    got = torch.cat(flash_paged_decode_attention_tp(
        cut(q), cut(pk), cut(pv), table, lens, dh ** -0.5, **skw), dim=1)
    want = JP.flash_paged_decode_attention_tp(
        _jx(q), _jx(pk), _jx(pv), _jx(table), _jx(lens), dh ** -0.5,
        JM.build_mesh("2"), **{k: _jx(v) for k, v in scales.items()})
    _close(got, want, rows=[0, 1, 3])
    assert torch.equal(got, flash_paged_decode_attention(
        q, pk, pv, table, lens, dh ** -0.5, **scales))


# ------------------------------------------------------------------ kernel D

@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 9)])
def test_flash_decode_plain_matches_jax_kernel(interpret_mode, dh, softcap,
                                               window):
    r = np.random.default_rng(7)
    q = _bf(r, (4, 8, dh))
    kc, vc = _bf(r, (4, 2, 64, dh)), _bf(r, (4, 2, 64, dh))
    lens = torch.tensor([64, 1, 0, 37], dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_decode_attention(q, kc, vc, lens, dh ** -0.5, **kw)
    want = JF.flash_decode_attention(_jx(q), _jx(kc), _jx(vc), _jx(lens),
                                     dh ** -0.5, **kw)
    _close(got, want, rows=[0, 1, 3])


# ------------------------------------------------------------- kernels C, E

def _chunk_pool(seed: int, int8: bool, dh: int, hkv: int = 2,
                page: int = 16):
    r = np.random.default_rng(seed)
    pk, pv = _bf(r, (13, hkv, page, dh)), _bf(r, (13, hkv, page, dh))
    if not int8:
        return r, pk, pv, {}
    (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
    return r, pk, pv, dict(k_scale=ks, v_scale=vs)


CHUNK_CASES = [  # (ctx_len, valid rows, softcap, window)
    (0, 40, 0.0, 0), (32, 27, 0.0, 0), (16, 40, 30.0, 0), (48, 33, 0.0, 9)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ctx,valid,softcap,window", CHUNK_CASES)
def test_chunk_plain_matches_jax_kernel(interpret_mode, dh, ctx, valid,
                                        softcap, window, int8):
    r, pk, pv, scales = _chunk_pool(ctx + valid, int8, dh)
    q = _bf(r, (40, 8, dh))
    pages = torch.tensor([7, 2, 11, 4, 0, 9], dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_ragged_chunk_attention(
        q, pk, pv, pages, torch.tensor(ctx, dtype=torch.int32),
        torch.tensor(ctx + valid, dtype=torch.int32), dh ** -0.5, **scales,
        **kw)
    want = JP.flash_ragged_chunk_attention(
        _jx(q), _jx(pk), _jx(pv), _jx(pages), jnp.int32(ctx),
        jnp.int32(ctx + valid), dh ** -0.5,
        **{k: _jx(v) for k, v in scales.items()}, **kw)
    _close(got[:valid], np.asarray(want, np.float32)[:valid])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("softcap,window,chunk_len", [
    (0.0, 0, 40), (30.0, 0, 27), (0.0, 9, 40)])
def test_ragged_plain_matches_jax_kernel(interpret_mode, dh, int8, softcap,
                                         window, chunk_len):
    """Decode rows at mixed lengths and an inactive slot, and a prefill
    chunk whose KV is in the pool (read back as the pool holds it)."""
    b, c, ctx, chunk_slot, page = 3, 40, 16, 2, 16
    r, pk, pv, scales = _chunk_pool(40 + chunk_len, int8, dh)
    q = _bf(r, (b + c, 8, dh))
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                         dtype=torch.int32)
    q_lens = torch.tensor([1, 0, 0, chunk_len], dtype=torch.int32)
    kv_lens = torch.tensor([33, 1, 1, ctx + chunk_len], dtype=torch.int32)
    rows = np.minimum(ctx + np.arange(c), ctx + chunk_len - 1)
    rp, ro = table[chunk_slot].numpy()[rows // page], rows % page

    def chunk(pool, sc):
        x = pool[rp, :, ro]
        if sc is not None:
            x = dequantize_kv(x, sc[rp, :, ro])
        return x.transpose(0, 1)[None].contiguous()

    ck = chunk(pk, scales.get("k_scale"))
    cv = chunk(pv, scales.get("v_scale"))
    kw = dict(softcap=softcap, sliding_window=window)
    got = ragged_paged_attention(q, ck, cv, pk, pv, table, q_lens, kv_lens,
                                 chunk_slot, dh ** -0.5, **scales, **kw)
    want = JP.flash_ragged_paged_attention(
        _jx(q), _jx(pk), _jx(pv), _jx(table), _jx(q_lens), _jx(kv_lens),
        jnp.int32(chunk_slot), dh ** -0.5,
        **{k: _jx(v) for k, v in scales.items()}, **kw)
    _close(got, want, rows=[0] + [b + i for i in range(chunk_len)])


# ---------------------------------------------------------- model, engine

# head dim -> (the registry model it widens, the test's name for it): Dh
# 80, 96 and 128 on tiny-test, Dh 256 on tiny-test-gemma (Gemma-2's
# features at a group of 2, as Gemma-2-9b).
MODELS = {80: ("tiny-test", "tiny-test-dh80"),
          96: ("tiny-test", "tiny-test-dh96"),
          128: ("tiny-test", "tiny-test-dh128"),
          256: ("tiny-test-gemma", "tiny-test-gemma-dh256")}


@pytest.fixture
def wide_model(monkeypatch, dh):
    """The registry model of ``MODELS[dh]`` with head_dim ``dh``,
    registered under the test's name in both packages' registries (JAX's
    engine and checkpoint writer look the name up); returns (name, the
    port's config)."""
    base, name = MODELS[dh]
    jcfg = dataclasses.replace(JC.get_config(base), name=name, head_dim=dh)
    cfg = dataclasses.replace(TC.get_config(base), name=name, head_dim=dh)
    monkeypatch.setitem(JC._REGISTRY, name, jcfg)
    monkeypatch.setitem(TC._REGISTRY, name, cfg)
    return name, cfg


def test_prefill_logits_and_kv_match_jax(wide_model, dh):
    name, cfg = wide_model
    jcfg = JC.get_config(name, max_context_length=256)
    cfg = dataclasses.replace(cfg, max_context_length=256)
    assert cfg.resolved_head_dim() == dh
    flat = _flatten_params(JT.init_params(jcfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    jparams: dict = {}
    for name, arr in flat.items():
        node = jparams
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    r = np.random.default_rng(1)
    b, t, plen = 2, 40, 37  # past tiny-test-gemma's window of 32
    tokens = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.minimum(np.arange(t), plen - 1)[None].repeat(b, 0).astype(
        np.int32)
    valid = (np.arange(t) < plen)[None].repeat(b, 0)
    jl, jk, jv = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                            jnp.asarray(pos), kv_valid=jnp.asarray(valid))
    tl, (tk,), (tv,) = T.prefill([params_from_numpy(flat)], cfg,
                                 torch.from_numpy(tokens).long(),
                                 torch.from_numpy(pos),
                                 kv_valid=torch.from_numpy(valid))
    assert tk.shape[-1] == dh
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


class _Recorder:
    """Tokenizer proxy recording every token an engine streams."""

    def __init__(self, tok):
        self._tok = tok
        self.ids: list[int] = []

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), self.ids

        class _Dec:
            def feed(self, token_id):
                ids.append(int(token_id))
                return dec.feed(token_id)

        return _Dec()


async def _streams(engine, prompts, max_tokens=10):
    rec = _Recorder(engine.tokenizer)
    engine.tokenizer = rec
    out = []
    for p in prompts:
        rec.ids.clear()
        final = None
        async for chunk in engine.generate(p, max_tokens=max_tokens):
            final = chunk
        assert final.done and final.completion_tokens == max_tokens
        out.append(list(rec.ids))
    engine.tokenizer = rec._tok
    return out


@pytest.mark.parametrize("layout,kv_dtype", [
    ("paged", "bf16"), ("paged", "int8"), ("contiguous", "bf16")])
async def test_greedy_streams_match_jax_engine(wide_model, dh, tmp_path,
                                               layout, kv_dtype):
    """A short prompt, a prefix hit on its first page (paged) and a prompt
    longer than a chunk and than tiny-test-gemma's window of 32 (ragged
    chunks when paged, legacy chunks when contiguous), token-identical to
    ``JaxEngine`` at the head dim."""
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )

    name, cfg = wide_model
    ckpt = permutation_checkpoint(name, tmp_path / "perm", max_context=256)
    flat = _flatten_params(permutation_params(
        JC.get_config(name, max_context_length=256)))
    prompts = ["the quick brown fox jumps over",
               "the quick brown fox leaps high",
               "a long prompt rides the chunks while the others wait " * 2]
    common = dict(max_context_length=256, kv_page_size=16,
                  step_token_budget=36, max_batch_slots=4, kv_layout=layout,
                  kv_dtype=kv_dtype)
    jeng = JaxEngine(Configuration(model=name, model_path=ckpt, warmup=False,
                                   intervals=Intervals.default(), **common))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model=name, model_config=cfg,
        warmup=False, **common)
    await jeng.start()
    try:
        jeng.scheduler.runner.prefill_chunk = 32
        want = await _streams(jeng, prompts)
    finally:
        await jeng.stop()
    await teng.start()
    try:
        teng.runner.prefill_chunk = 32
        assert teng.runner.cfg.resolved_head_dim() == dh
        got = await _streams(teng, prompts)
        sched = teng.scheduler
        if layout == "paged":
            assert teng.runner.prefix_hits >= 1 and sched.ragged_chunks >= 2
        else:
            assert sched.prefill_chunks >= 2
    finally:
        await teng.stop()
    assert got == want
