"""The port's int8 KV cache against the JAX package (``kv_dtype="int8"``).

- ``ops/quant.py quantize_kv``: bit-identical int8 values and bf16 scales
  (fp32 and bf16 inputs, an all-zero vector, exact .5 ties).
- ``decode_attention_q`` against JAX's: fp32 within 1e-5.
- Kernel B's and C's int8 plain versions (what the wrappers run on CPU
  tensors) against the JAX Pallas kernels with scales in interpret mode
  and against the jnp references: fp32 within 1e-5.  Rows where the TPU
  kernel writes zeros (a zero-length slot, rows that carry no query) are
  compared with the references only.  Kernel C reads the chunk's KV back
  from the int8 pool, so its plain version is fed the dequantized chunk
  rows for that comparison, and the fresh chunk KV for the comparison
  with ``ragged_paged_attention_ref``.
- The runners: after one prompt and after four greedy decode steps on
  random fp32 weights, the int8 pools/caches and their scales match the
  JAX runners' (values within 1 LSB, scales within one bf16 ulp, the
  differing share below 1e-3) and the greedy tokens are equal, on both
  layouts.
- The engine: greedy and seeded sampled streams token-identical to
  ``JaxEngine(kv_dtype="int8")`` on the permutation checkpoint, paged with
  the ragged path and a prefix hit, paged with legacy chunks, and
  contiguous with legacy chunks.
- Prefill reuses the runner's rope tables (no rebuild per call) and gives
  the same logits as the tables built inside ``T.prefill``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.ops import attention as JA  # noqa: E402
from crowdllama_tpu.ops.pallas import paged as JP  # noqa: E402
from crowdllama_tpu.ops.quant import quantize_kv as j_quantize_kv  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.ops.attention import decode_attention_q  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_paged_decode_attention,
    ragged_paged_attention,
)
from crowdllama_tpu_torch.ops.quant import dequantize_kv, quantize_kv  # noqa: E402

TOL = 1e-5
MAX_SEQ = 256


@pytest.fixture
def interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _jx(x: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _close(got, want, rows=None):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if rows is not None:
        g, w = g[rows], w[rows]
    np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


# ---------------------------------------------------------------- quantize

def _quant_case(name: str) -> np.ndarray:
    r = np.random.default_rng(11)
    if name == "zeros":
        x = r.standard_normal((3, 4, 16)).astype(np.float32)
        x[1, 2] = 0.0  # one all-zero vector: scale 1e-12, values 0
        return x
    if name == "ties":
        # max |x| = 127 makes the scale exactly 1.0 in fp32 (1e-12 is below
        # its ulp), so these entries divide to exact .5 ties.
        row = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                        -126.5, 4.5, -4.5, 0, 1, -127, 5.5], np.float32)
        return np.stack([row, -row, row * 0.5])[None]
    return (r.standard_normal((2, 3, 5, 16)) * 3).astype(np.float32)


@pytest.mark.parametrize("case,bf16", [
    ("random", False), ("random", True), ("zeros", False), ("ties", False),
    ("ties", True)])
def test_quantize_kv_bit_identical_to_jax(case, bf16):
    x = _quant_case(case)
    tx = torch.from_numpy(x)
    jxv = jnp.asarray(x)
    if bf16:
        tx, jxv = tx.to(torch.bfloat16), jxv.astype(jnp.bfloat16)
    q, s = quantize_kv(tx)
    jq, js = j_quantize_kv(jxv)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert tuple(s.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))
    if case == "ties":
        # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4, 126.5 -> 126
        np.testing.assert_array_equal(
            q.numpy()[0, 0, :10], [127, 0, 2, 2, 0, -2, -2, 4, 126, -126])
    back = dequantize_kv(q, s)
    assert back.dtype == torch.float32 and back.shape == tx.shape


# ------------------------------------------------------- decode_attention_q

def _int8(arr: np.ndarray):
    """fp32 numpy -> (int8 values, bf16 scales) as torch tensors."""
    return quantize_kv(torch.from_numpy(arr))


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 9)])
def test_decode_attention_q_matches_jax(softcap, window):
    r = np.random.default_rng(5)
    b, h, hkv, s, dh = 4, 4, 2, 48, 16
    q = torch.from_numpy(r.standard_normal((b, h, dh)).astype(np.float32))
    kc, ks = _int8(r.standard_normal((b, hkv, s, dh)).astype(np.float32))
    vc, vs = _int8(r.standard_normal((b, hkv, s, dh)).astype(np.float32))
    lens = torch.tensor([48, 1, 0, 30], dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    got = decode_attention_q(q, kc, ks, vc, vs, lens, 0.25, **kw)
    want = JA.decode_attention_q(*(_jx(t) for t in (q, kc, ks, vc, vs, lens)),
                                 0.25, **kw)
    _close(got, want)


# ------------------------------------------------------------- kernel B int8

def _int8_pool(seed, pages, hkv, page, dh):
    r = np.random.default_rng(seed)
    pk = r.standard_normal((pages, hkv, page, dh)).astype(np.float32)
    pv = r.standard_normal((pages, hkv, page, dh)).astype(np.float32)
    return pk, pv


@pytest.mark.parametrize("softcap,window", [
    (0.0, 0), (30.0, 0), (0.0, 9), (25.0, 13)])
def test_paged_decode_int8_plain_matches_jax(interpret_mode, softcap, window):
    """Mixed lengths, a slot on the dump page (len 1) and a zero-length
    slot, over an int8 pool with per-position scales."""
    b, h, hkv, dh, page, np_ = 4, 4, 2, 16, 32, 4
    pk, pv = _int8_pool(21, 17, hkv, page, dh)
    pk8, ksc = _int8(pk)
    pv8, vsc = _int8(pv)
    q = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (b, h, dh)).astype(np.float32))
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([100, 1, 0, 40], dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    got = flash_paged_decode_attention(q, pk8, pv8, table, lens, 0.25,
                                       k_scale=ksc, v_scale=vsc, **kw)
    jq, jk, jv, jks, jvs, jt, jl = (_jx(t) for t in (q, pk8, pv8, ksc, vsc,
                                                      table, lens))
    w = np_ * page
    view_k = jk[jt].transpose(0, 2, 1, 3, 4).reshape(b, hkv, w, dh)
    view_v = jv[jt].transpose(0, 2, 1, 3, 4).reshape(b, hkv, w, dh)
    sk = jks[jt].transpose(0, 2, 1, 3).reshape(b, hkv, w)
    sv = jvs[jt].transpose(0, 2, 1, 3).reshape(b, hkv, w)
    ref = JA.decode_attention_q(jq, view_k, sk, view_v, sv, jl, 0.25, **kw)
    pallas = JP.flash_paged_decode_attention(jq, jk, jv, jt, jl, 0.25,
                                             k_scale=jks, v_scale=jvs, **kw)
    _close(got, ref)
    _close(got, pallas, rows=[0, 1, 3])
    assert not np.asarray(pallas, np.float32)[2].any()


# ------------------------------------------------------------- kernel C int8

@pytest.mark.parametrize("softcap,window,chunk_len", [
    (0.0, 0, 40), (30.0, 0, 40), (0.0, 9, 40), (0.0, 0, 27)])
def test_ragged_int8_plain_matches_jax(interpret_mode, softcap, window,
                                       chunk_len):
    """Decode rows at mixed lengths and an inactive slot, plus a prefill
    chunk whose fresh KV the engine has quantized into the pool."""
    b, h, hkv, dh, page = 3, 4, 2, 16, 32
    c, ctx, chunk_slot = 40, 16, 2
    pk, pv = _int8_pool(31, 16, hkv, page, dh)
    r = np.random.default_rng(32)
    q = torch.from_numpy(r.standard_normal((b + c, h, dh)).astype(np.float32))
    fresh_k = r.standard_normal((c, hkv, dh)).astype(np.float32)
    fresh_v = r.standard_normal((c, hkv, dh)).astype(np.float32)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                         dtype=torch.int32)
    cpos = ctx + np.arange(chunk_len)
    cpages = table[chunk_slot].numpy()[cpos // page]
    pk[cpages, :, cpos % page] = fresh_k[:chunk_len]
    pv[cpages, :, cpos % page] = fresh_v[:chunk_len]
    pk8, ksc = _int8(pk)  # per-vector: the same as quantize-then-scatter
    pv8, vsc = _int8(pv)
    q_lens = torch.tensor([1, 0, 0, chunk_len], dtype=torch.int32)
    kv_lens = torch.tensor([33, 1, 1, ctx + chunk_len], dtype=torch.int32)
    kw = dict(softcap=softcap, sliding_window=window)
    scales = dict(k_scale=ksc, v_scale=vsc)
    # The chunk rows as the pool holds them (rows past the valid length
    # repeat the last valid position, as the engine clamps them).
    rows = np.minimum(ctx + np.arange(c), ctx + chunk_len - 1)
    rp = table[chunk_slot].numpy()[rows // page]
    deq_k = dequantize_kv(pk8[rp, :, rows % page], ksc[rp, :, rows % page])
    deq_v = dequantize_kv(pv8[rp, :, rows % page], vsc[rp, :, rows % page])
    deq_k, deq_v = (x.transpose(0, 1)[None] for x in (deq_k, deq_v))
    args = (table, q_lens, kv_lens, chunk_slot, 0.25)
    got_pool = ragged_paged_attention(q, deq_k, deq_v, pk8, pv8, *args,
                                      **scales, **kw)
    fk, fv = (torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))[None]
              for x in (fresh_k, fresh_v))
    got_fresh = ragged_paged_attention(q, fk, fv, pk8, pv8, *args, **scales,
                                       **kw)
    jq, jk, jv, jks, jvs, jt, jql, jkl = (
        _jx(t) for t in (q, pk8, pv8, ksc, vsc, table, q_lens, kv_lens))
    pallas = JP.flash_ragged_paged_attention(
        jq, jk, jv, jt, jql, jkl, jnp.int32(chunk_slot), 0.25, k_scale=jks,
        v_scale=jvs, **kw)
    ref = JP.ragged_paged_attention_ref(
        jq, _jx(fk), _jx(fv), jk, jv, jt, jql, jkl, jnp.int32(chunk_slot),
        0.25, k_scale=jks, v_scale=jvs, **kw)
    live = [0] + [b + i for i in range(chunk_len)]
    _close(got_pool, pallas, rows=live)
    _close(got_fresh, ref)
    dead = [1, 2] + [b + i for i in range(chunk_len, c)]
    assert not np.asarray(pallas, np.float32)[dead].any()


# ------------------------------------------------------------------ runners

def _flat(seed=3):
    cfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    return _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))


def _jparams(flat):
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _kv_arrays(state, layout: str):
    """(name, values) of the int8 KV and its scales in a decode state."""
    names = (("pool_k", "pool_v") if layout == "paged"
             else ("k_cache", "v_cache")) + ("k_scale", "v_scale")
    out = {}
    for n in names:
        x = getattr(state, n)
        if layout == "paged" and isinstance(x, list):  # the port's one rank
            (x,) = x
        out[n] = (_np(x) if isinstance(x, torch.Tensor)
                  else np.asarray(jnp.asarray(x, jnp.float32)
                                  if x.dtype == jnp.bfloat16 else x))
    return out


def _assert_kv_match(got: dict, want: dict) -> None:
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name.endswith("scale"):  # bf16: within one ulp (2^-8 relative)
            diff = np.abs(g - w) > np.abs(w) * 2.0 ** -8
        else:  # int8 values: within one LSB
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, f"{name}: off by {d.max()}"
            diff = d > 0
        # Entries that differ at all come from fp32 ties at a rounding
        # boundary; they must stay rare.
        assert diff.mean() < 1e-3, f"{name}: {int(diff.sum())} entries differ"


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_int8_runner_kv_and_tokens_match_jax(layout):
    """One prompt, then four greedy decode steps on random fp32 weights
    (attention in play): the int8 KV, its scales and the tokens match the
    JAX runner of the same layout."""
    from crowdllama_tpu.engine.paged import (
        PagedModelRunner as JaxPagedModelRunner,
    )
    from crowdllama_tpu.engine.runner import ModelRunner as JaxModelRunner

    flat = _flat()
    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    kw = dict(max_slots=2, max_seq=MAX_SEQ, kv_dtype="int8")
    if layout == "paged":
        jrun = JaxPagedModelRunner(jcfg, params=_jparams(flat),
                                   dtype=jnp.float32, mesh_spec="1",
                                   page_size=16, **kw)
        trun = PagedModelRunner(cfg, params=params_from_numpy(flat),
                                device="cpu", page_size=16, **kw)
    else:
        jrun = JaxModelRunner(jcfg, params=_jparams(flat), dtype=jnp.float32,
                              mesh_spec="1", **kw)
        trun = ModelRunner(cfg, params=params_from_numpy(flat), device="cpu",
                           **kw)
    prompt = [int(t) for t in np.random.default_rng(7).integers(0, 500, 37)]
    jst, tst = jrun.init_state(), trun.init_state()
    jtok, jks, jvs, plen = jrun.prefill(prompt, 0.0, 1.0,
                                        jax.random.PRNGKey(0), state=jst)
    jst = jrun.insert(jst, 0, jks, jvs, plen, jtok, 0.0, 1.0,
                      prompt_tokens=prompt)
    ttok, tks, tvs, _ = trun.prefill(prompt, 0.0, 1.0, None, state=tst)
    tst = trun.insert(tst, 0, tks, tvs, plen, ttok, 0.0, 1.0,
                      prompt_tokens=prompt)
    assert ttok == jtok
    if layout == "paged":
        np.testing.assert_array_equal(trun.page_table, jrun.page_table)
    _assert_kv_match(_kv_arrays(tst, layout), _kv_arrays(jst, layout))
    jout, jst = jrun.decode_steps(jst, 4)
    tout, tst = trun.decode_steps(tst, 4)
    np.testing.assert_array_equal(tout[:, 0], np.asarray(jout)[:, 0])
    _assert_kv_match(_kv_arrays(tst, layout), _kv_arrays(jst, layout))


def test_prefill_reuses_the_runner_rope_tables(monkeypatch):
    """The runner's prefill paths (monolithic, prefix-hit suffix, legacy
    chunk, embeddings) take its rope tables instead of rebuilding them,
    and the logits equal T.prefill's with tables built inside."""
    flat = _flat()
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    run = PagedModelRunner(cfg, params=params_from_numpy(flat), device="cpu",
                           max_slots=2, max_seq=MAX_SEQ, page_size=16)
    run.prefill_chunk = 32
    prompt = [int(t) for t in np.random.default_rng(8).integers(0, 500, 40)]
    ar = torch.arange(64, dtype=torch.int32)
    tokens = torch.zeros((1, 64), dtype=torch.long)
    tokens[0, :40] = torch.tensor(prompt)
    want = T.prefill(run.params, cfg, tokens,
                     torch.clamp(ar, max=39)[None], (ar < 40)[None])[0]

    def no_rebuild(*a, **k):
        raise AssertionError("rope tables rebuilt inside a prefill call")

    monkeypatch.setattr(T, "rope_for", no_rebuild)
    got = T.prefill(run.params, cfg, tokens, torch.clamp(ar, max=39)[None],
                    (ar < 40)[None], rope=run.ropes)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.inference_mode():
        st = run.init_state()
        first, ks, vs, plen = run.prefill(prompt, 0.0, 1.0, None, state=st)
        st = run.insert(st, 0, ks, vs, plen, first, 0.0, 1.0,
                        prompt_tokens=prompt)
        assert first == int(want[0, 39].argmax())
        run.prefill(prompt[:33] + [7, 8], 0.0, 1.0, None, state=st)
        assert run.prefix_hits == 1
        job = run.prefill_begin(prompt * 2)
        while not run.prefill_step(job):
            pass
    run.embed_prompts([prompt])


# ------------------------------------------------------------------- engine

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


async def _streams(engine, reqs, max_tokens=10):
    rec = _Recorder(engine.tokenizer)
    engine.tokenizer = rec
    out = []
    for prompt, kw in reqs:
        rec.ids.clear()
        final = None
        async for chunk in engine.generate(prompt, max_tokens=max_tokens,
                                           **kw):
            final = chunk
        assert final.done and final.completion_tokens == max_tokens
        out.append(list(rec.ids))
    engine.tokenizer = rec._tok
    return out


_LONG_A = "chunked admission of a long prompt, one chunk per loop! " * 2
_SEEDED = ("seeded", dict(temperature=0.8, seed=1234))


@pytest.mark.parametrize("layout,ragged", [
    ("paged", True), ("paged", False), ("contiguous", False)])
async def test_int8_streams_match_jax_engine(tmp_path, layout, ragged):
    """Greedy streams (a short prompt, a long prompt admitted in chunks, a
    long prompt sharing the previous one's first 48 tokens) and a seeded
    sampled stream on the permutation checkpoint with ``kv_dtype="int8"``:
    ragged chunks plus a prefix hit, legacy chunks seeded from cached int8
    pages, and legacy chunks into the contiguous int8 cache."""
    from crowdllama_tpu.config import Configuration as JaxConfiguration
    from crowdllama_tpu.config import Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=MAX_SEQ)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=MAX_SEQ)))
    long_b = _LONG_A[:47] + " and then a tail that only the second one has"
    reqs = [("short one", {}), (_LONG_A, {}), (long_b, {}), _SEEDED]
    common = dict(max_context_length=MAX_SEQ, kv_page_size=16,
                  max_batch_slots=4, kv_layout=layout, ragged_prefill=ragged,
                  step_token_budget=36, kv_dtype="int8")
    jeng = JaxEngine(JaxConfiguration(model="tiny-test", model_path=ckpt,
                                      warmup=False,
                                      intervals=Intervals.default(),
                                      **common))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False,
        **common)
    await jeng.start()
    try:
        jeng.scheduler.runner.prefill_chunk = 32
        want = await _streams(jeng, reqs)
        jhits = getattr(jeng.scheduler.runner, "prefix_hits", 0)
    finally:
        await jeng.stop()
    await teng.start()
    try:
        teng.runner.prefill_chunk = 32
        assert teng.describe()["kv_dtype"] == "int8"
        got = await _streams(teng, reqs)
        sched = teng.scheduler
        if ragged:
            assert sched.ragged_chunks >= 2 and sched.prefill_chunks == 0
        else:
            assert sched.prefill_chunks >= 4 and sched.ragged_chunks == 0
        if layout == "paged":
            assert teng.runner.prefix_hits == jhits >= 1
            assert teng.runner.init_state().pool_k[0].dtype == torch.int8
    finally:
        await teng.stop()
    assert got == want
    assert len(set(got[-1])) > 2  # the seeded stream really sampled
