"""Mixture-of-experts layers of the port against the JAX package.

- Routing: ``_route_topk`` against JAX's on random router logits, ties
  included (all-tied rows take the lowest expert ids, as ``lax.top_k``).
- Dispatch: ``_moe_sorted`` and ``_moe_dense`` against JAX's
  ``_moe_sorted`` and ``_moe_dense`` on fp32 weights at every shape JAX's
  ``tests/test_moe_dispatch.py`` uses, within its rtol 2e-4 / atol 2e-5
  (fp32 sums in another order), at K = 2 and at K = 3 (where the
  per-token sum's order matters: ascending expert ids, JAX's scatter
  order); on int8 / int4 expert banks too.
- Kernel G's plain version (``grouped_gemm_plain``): empty groups, one
  group holding every row, a bank of one, against a per-group loop and
  ``lax.ragged_dot`` (1e-5).
- No host sync: the MoE forward (both dispatches, bf16 and quantized
  banks) under a ``TorchDispatchMode`` that raises on
  ``aten._local_scalar_dense``, ``nonzero``, ``bincount`` and
  ``masked_select``, and on the meta device, where any read of a value
  on the host fails.
- The model: ``tiny-test-moe`` and ``tiny-test-qwen3-moe`` prefill and
  decode logits against JAX's transformer (1e-4).
- The engine: greedy streams equal to ``JaxEngine``'s on a permutation
  checkpoint of ``tiny-test-moe`` whose attention and experts are kept
  live (``wo`` and ``w_down`` small random instead of zero, so every
  path's experts reach the logits while greedy decode keeps margins of
  2.9 or more): paged bf16 and int8 KV, contiguous, tp=2, n-gram
  speculation, megastep through ``fake_capture`` graphs, the dense
  dispatch, and int8 / int4 experts.  The port's paged runner's greedy
  tokens equal JAX's runner's on random fp32 weights (sorted and dense
  dispatch).
"""

import asyncio
import contextvars
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.ops import quant as JQ  # noqa: E402
from crowdllama_tpu_torch.engine.weights import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.ops import quant as Q  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.gemm import grouped_gemm_plain  # noqa: E402

MOE = ["tiny-test-moe", "tiny-test-qwen3-moe"]
RTOL, ATOL = 2e-4, 2e-5  # tests/test_moe_dispatch.py


def _layer(model: str, seed: int = 0, **over):
    """(JAX layer-0 params, the port's, JAX cfg, port cfg), fp32."""
    jcfg = j_get_config(model, max_context_length=64, **over)
    cfg = get_config(model, max_context_length=64, **over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(_flatten_params(jp))
    return (JT._layer_params(jp["layers"], 0),
            {k: v[0] for k, v in tp["layers"].items()}, jcfg, cfg)


def test_route_topk_matches_jax_with_ties():
    jlp, lp, jcfg, cfg = _layer("tiny-test-moe")
    r = np.random.default_rng(0)
    x = r.standard_normal((6, 64)).astype(np.float32)
    jw, ji = JT._route_topk(jlp, jcfg, jnp.asarray(x))
    tw, ti = T._route_topk(lp, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    # Ties: an all-zero router ties every expert; a router whose columns
    # repeat ties pairs.
    for router in (np.zeros((64, 4), np.float32),
                   np.repeat(r.standard_normal((64, 2)).astype(np.float32),
                             2, axis=1)):
        jw, ji = JT._route_topk({"router": jnp.asarray(router)}, jcfg,
                                jnp.asarray(x))
        tw, ti = T._route_topk({"router": torch.from_numpy(router)}, cfg,
                               torch.from_numpy(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert (ti.numpy()[:, 0] < ti.numpy()[:, 1]).all()  # lower id first


@pytest.mark.parametrize("model", MOE)
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_moe_dispatch_matches_jax(model, k, quant):
    """Both dispatches against both of JAX's on every shape of JAX's
    dispatch test; quantized banks are JAX's ``quantize_params`` carried
    across as ``q`` / ``s``."""
    jlp, lp, jcfg, cfg = _layer(model, num_experts_per_tok=k)
    if quant:
        fn = JQ.quantize_weight if quant == "int8" else \
            JQ.quantize_weight_int4
        cls = Q.QTensor if quant == "int8" else Q.QTensor4
        for name in ("w_gate", "w_up", "w_down"):
            jlp[name] = fn(jlp[name])
            lp[name] = cls(q=torch.from_numpy(np.asarray(jlp[name].q)),
                           s=torch.from_numpy(np.asarray(
                               jlp[name].s, np.float32)).to(torch.bfloat16))
    for shape in ((1, 64), (8, 64), (2, 17, 64), (1, 128, 64)):
        x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
            np.float32)
        want_sorted = np.asarray(JT._moe_sorted(jlp, jcfg, jnp.asarray(x)))
        want_dense = np.asarray(JT._moe_dense(jlp, jcfg, jnp.asarray(x)))
        got_sorted = T._moe_sorted(lp, cfg, torch.from_numpy(x)).numpy()
        got_dense = T._moe_dense(lp, cfg, torch.from_numpy(x)).numpy()
        for got in (got_sorted, got_dense):
            if quant:  # JAX's jitted ragged dot drops the dequant rounding
                want = np.asarray(JT._moe_sorted(
                    {**jlp, **{n: jnp.asarray(JQ.dequant(jlp[n]), jnp.float32)
                               for n in ("w_gate", "w_up", "w_down")}},
                    jcfg, jnp.asarray(x)))
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_allclose(got, want_sorted, rtol=RTOL,
                                           atol=ATOL)
                np.testing.assert_allclose(got, want_dense, rtol=RTOL,
                                           atol=ATOL)


def test_sorted_sum_is_in_ascending_expert_order():
    """At K = 3 the per-token fp32 sum of the sorted dispatch equals the
    contributions added in ascending expert order, bit for bit."""
    jlp, lp, jcfg, cfg = _layer("tiny-test-moe", num_experts_per_tok=3)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (9, 64)).astype(np.float32))
    got = T._moe_sorted(lp, cfg, x)
    w, ids = T._route_topk(lp, cfg, x)
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in torch.argsort(ids[t], stable=True).tolist():
            e = int(ids[t, j])
            h = T._mlp({n: lp[n][e] for n in ("w_gate", "w_up", "w_down")},
                       dataclasses.replace(cfg, num_experts=0), x[t:t + 1])
            want[t] = want[t] + h[0].float() * w[t, j]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_grouped_gemm_plain_groups(quant):
    """G's plain version: empty groups, every row in one group, a bank of
    one without offsets; against a per-group loop and JAX's ragged dot."""
    r = np.random.default_rng(1)
    bank = r.standard_normal((4, 64, 128)).astype(np.float32) / 8
    if quant:
        jbank = (JQ.quantize_weight if quant == "int8"
                 else JQ.quantize_weight_int4)(jnp.asarray(bank))
        tbank = (Q.quantize_weight if quant == "int8"
                 else Q.quantize_weight_int4)(torch.from_numpy(bank))
    else:
        jbank, tbank = jnp.asarray(bank), torch.from_numpy(bank)
    xs = r.standard_normal((10, 64)).astype(np.float32)
    for sizes in ([3, 0, 7, 0], [0, 0, 10, 0], [10, 0, 0, 0], [2, 3, 4, 1]):
        off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32)
        got = grouped_gemm_plain(torch.from_numpy(xs), tbank, off)
        loop = torch.cat([torch.from_numpy(xs[a:b]) @ Q.dequant(
            tbank[e]).float() for e, (a, b) in enumerate(
                zip(off[:-1].tolist(), off[1:].tolist()))])
        np.testing.assert_allclose(got.numpy(), loop.numpy(), atol=1e-5)
        want = JQ.qragged_dot(jnp.asarray(xs), jbank,
                              jnp.asarray(sizes, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    one = grouped_gemm_plain(torch.from_numpy(xs), tbank[2])
    np.testing.assert_allclose(one.numpy(), xs @ Q.dequant(
        tbank[2]).float().numpy(), atol=1e-5)


class _NoHostSync(TorchDispatchMode):
    """Raises on the operators that read device values on the host."""

    SYNCS = ("_local_scalar_dense", "nonzero", "bincount", "masked_select")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.SYNCS:
            raise AssertionError(f"host sync: aten.{name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dispatch", ["sorted", "dense"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_moe_forward_makes_no_host_sync(dispatch, quant, monkeypatch):
    """The MoE layer (routing, sort, offsets, grouped products, combine)
    and a whole decode step of an MoE model reach none of the sync
    operators, and run on the meta device (no value can be read there)."""
    _, lp, _, cfg = _layer("tiny-test-moe", moe_dispatch=dispatch)
    if quant:
        lp = Q.quantize_params({"layers": lp}, extra_keys=(),
                               mode=quant)["layers"]
    x = torch.randn(5, 64)
    with _NoHostSync():
        T._moe(lp, cfg, x)
    with _NoHostSync():  # the detector catches a sync
        with pytest.raises(AssertionError, match="host sync"):
            torch.bincount(torch.tensor([1, 2]))
    meta = {k: v.to("meta") for k, v in lp.items()}
    # G's plain version (its wrapper takes no meta tensor)
    monkeypatch.setattr(T, "grouped_gemm", grouped_gemm_plain)
    out = T._moe(meta, cfg, x.to("meta"))
    monkeypatch.undo()
    assert out.shape == x.shape and out.device.type == "meta"
    params = init_params(cfg, 0, dtype=torch.float32, quantize=quant)
    kc = torch.zeros(cfg.num_layers, 3, cfg.num_kv_heads, 16,
                     cfg.resolved_head_dim())
    with _NoHostSync():
        logits = T.decode_step([params], cfg, torch.tensor([5, 6, 7]),
                               torch.tensor([0, 3, 9], dtype=torch.int32),
                               kc, kc.clone(),
                               torch.tensor([1, 4, 10], dtype=torch.int32))[0]
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("model", MOE)
def test_moe_model_logits_match_jax(model):
    """Prefill logits and KV over padded rows, then one decode step over
    the contiguous cache, on random fp32 weights (1e-4)."""
    jcfg = j_get_config(model, max_context_length=256)
    cfg = get_config(model, max_context_length=256)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    tp = params_from_numpy(_flatten_params(jp))
    r = np.random.default_rng(3)
    b, t, plen = 2, 20, 17
    tokens = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.minimum(np.arange(t), plen - 1)[None].repeat(b, 0).astype(
        np.int32)
    valid = (np.arange(t) < plen)[None].repeat(b, 0)
    jl, jk, jv = JT.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                            kv_valid=jnp.asarray(valid))
    tl, (tk,), (tv,) = T.prefill([tp], cfg, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(pos),
                                 kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    kc = np.zeros((cfg.num_layers, b, cfg.num_kv_heads, 32,
                   cfg.resolved_head_dim()), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :, :t] = np.asarray(jk)
    vc[:, :, :, :t] = np.asarray(jv)
    nxt = np.array([3, 9], np.int32)
    dpos = np.full((b,), plen, np.int32)
    lens = dpos + 1
    jd = JT.decode_step(jp, jcfg, jnp.asarray(nxt), jnp.asarray(dpos),
                        jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(lens))[0]
    td = T.decode_step([tp], cfg, torch.from_numpy(nxt),
                       torch.from_numpy(dpos), torch.from_numpy(kc),
                       torch.from_numpy(vc), torch.from_numpy(lens))[0]
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


@pytest.mark.parametrize("dispatch", ["sorted", "dense"])
def test_paged_runner_tokens_match_jax_runner(dispatch):
    """The paged runner on random fp32 weights: the prefill's first
    tokens and four decode steps of three slots, greedy, equal to JAX's
    paged runner's (routing decides every token here)."""
    from crowdllama_tpu.engine.paged import PagedModelRunner as JRunner
    from crowdllama_tpu_torch.engine.paged import PagedModelRunner

    jcfg = j_get_config("tiny-test-moe", max_context_length=128,
                        moe_dispatch=dispatch)
    cfg = get_config("tiny-test-moe", max_context_length=128,
                     moe_dispatch=dispatch)
    flat = _flatten_params(JT.init_params(jcfg, jax.random.PRNGKey(4),
                                          dtype=jnp.float32))
    jp: dict = {}
    for name, arr in flat.items():
        node = jp
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    kw = dict(max_slots=4, max_seq=128, page_size=16)
    jr = JRunner(jcfg, params=jp, dtype=jnp.float32, mesh_spec="1", **kw)
    tr = PagedModelRunner(cfg, params=params_from_numpy(flat), device="cpu",
                          dtype=torch.float32, **kw)
    jst, tst = jr.init_state(), tr.init_state()
    prompts = [[257, 5, 6, 7], [257] + list(range(30, 50)), [257, 9] * 9]
    for slot, ids in enumerate(prompts):
        jtok, jks, jvs, jn = jr.prefill(ids, 0.0, 1.0,
                                        jax.random.PRNGKey(0))
        ttok, tks, tvs, tn = tr.prefill(ids, 0.0, 1.0, None)
        assert int(ttok) == int(jtok)
        jst = jr.insert(jst, slot, jks, jvs, jn, jtok, 0.0, 1.0,
                        prompt_tokens=ids)
        tst = tr.insert(tst, slot, tks, tvs, tn, ttok, 0.0, 1.0,
                        prompt_tokens=ids)
    jr.pre_decode_check(4)
    tr.pre_decode_check(4)
    jout, _ = jr.decode_steps(jst, 4)
    tout, _ = tr.decode_steps(tst, 4)
    np.testing.assert_array_equal(np.asarray(tout)[:, :3],
                                  np.asarray(jout)[:, :3])


# ----------------------------------------------------------------- engines

MAX_SEQ, PAGE = 256, 16
COMMON = dict(max_context_length=MAX_SEQ, kv_page_size=PAGE,
              step_token_budget=36, max_batch_slots=4, warmup=False)
PROMPTS = {"short": "the quick brown fox jumps over",
           "hit": "the quick brown fox leaps high",
           "long": "a long prompt rides the ragged chunks while others "
                   "wait " * 2}
DENSE_NAME = "tiny-test-moe-dense"


@pytest.fixture(scope="module")
def live_ckpt(tmp_path_factory):
    """A native checkpoint (written by the JAX package) of the
    permutation weights of ``tiny-test-moe`` with ``wo`` and ``w_down``
    random at 0.005 instead of zero: attention and every expert reach the
    logits (they move the smallest top-2 gap of these streams' greedy
    steps from 3.7 to 2.9), while greedy decode keeps margins of 2.9 or
    more in bf16, int8 and int4 (at 0.02 they fall to 0.1: near-ties,
    which would make the comparison a lottery)."""
    from crowdllama_tpu.engine.weights import save_params
    from crowdllama_tpu.testing.modelgen import permutation_params

    jcfg = j_get_config("tiny-test-moe", max_context_length=MAX_SEQ)
    params = permutation_params(jcfg)
    r = np.random.default_rng(11)
    for name in ("wo", "w_down"):
        shape = params["layers"][name].shape
        params["layers"][name] = jnp.asarray(
            0.005 * r.standard_normal(shape).astype(np.float32))
    out = tmp_path_factory.mktemp("moe") / "ckpt"
    save_params(jcfg, params, out)
    return str(out)


@pytest.fixture(scope="module")
def dense_registered():
    """``tiny-test-moe`` with ``moe_dispatch="dense"`` under its own name
    in both registries."""
    from crowdllama_tpu.models import config as jconfig
    from crowdllama_tpu_torch.models import config as tconfig

    for mod in (jconfig, tconfig):
        mod._REGISTRY[DENSE_NAME] = dataclasses.replace(
            mod._REGISTRY["tiny-test-moe"], name=DENSE_NAME,
            moe_dispatch="dense")
    yield
    for mod in (jconfig, tconfig):
        mod._REGISTRY.pop(DENSE_NAME, None)


# The token ids the running stream's decoder was fed (per asyncio task).
_IDS: contextvars.ContextVar = contextvars.ContextVar("ids", default=None)


class _Ids:
    """Tokenizer proxy appending every decoded token id to ``_IDS``."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), _IDS.get()

        class _Dec:
            def feed(self, t):
                ids.append(int(t))
                return dec.feed(t)

        return _Dec()


async def _streams(engine, max_tokens=12):
    """The short prompt, then the prefix hit and the long one while it
    decodes: name -> token ids."""
    out = {}

    async def run(name):
        ids: list[int] = []
        _IDS.set(ids)
        final = None
        async for chunk in engine.generate(PROMPTS[name],
                                           max_tokens=max_tokens):
            final = chunk
        assert final.done and final.completion_tokens == max_tokens
        out[name] = ids

    engine.tokenizer = _Ids(engine.tokenizer)
    first = asyncio.create_task(run("short"))
    await asyncio.sleep(0)
    rest = [asyncio.create_task(run(n)) for n in ("hit", "long")]
    await asyncio.gather(first, *rest)
    return out


def _serve(engine, graphs: bool = False):
    async def go():
        await engine.start()
        try:
            if graphs:
                from crowdllama_tpu_torch.engine.graphs import GraphCache
                from tests.test_torch_megastep import fake_capture

                engine.runner._graphs = GraphCache(capture=fake_capture)
            got = await _streams(engine)
            return got, engine
        finally:
            await engine.stop()

    return asyncio.run(go())


ENGINE_CASES = {
    "paged": {},
    "paged_int8kv": dict(kv_dtype="int8"),
    "contiguous": dict(kv_layout="contiguous"),
    "tp2": dict(mesh_shape="2"),
    "ngram": dict(spec_decode="ngram", spec_draft=3),
    "megastep": dict(megastep_k=4, decode_chunk=4),
    "dense": dict(model=DENSE_NAME),
    "int8_experts": dict(quantize="int8"),
    "int4_experts": dict(quantize="int4"),
    "int8_experts_tp2": dict(quantize="int8", mesh_shape="2"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_moe_engine_streams_match_jax_engine(case, live_ckpt,
                                             dense_registered):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import load_native_params

    kw = dict(ENGINE_CASES[case])
    model = kw.pop("model", "tiny-test-moe")
    tkw = dict(kw, devices=["cpu", "cpu"]) if "mesh_shape" in kw else dict(
        kw, device="cpu")
    cfg = get_config(model, max_context_length=MAX_SEQ)
    teng = TorchEngine(params=load_native_params(cfg, live_ckpt,
                                                 dtype=torch.float32),
                       dtype=torch.float32, model=model, **COMMON, **tkw)
    got, teng = _serve(teng, graphs=case == "megastep")
    jeng = JaxEngine(Configuration(model=model, model_path=live_ckpt,
                                   intervals=Intervals.default(), **COMMON,
                                   **kw))
    want, _ = _serve(jeng)
    assert got == want
    assert teng.scheduler.ragged_chunks >= 1 or case == "contiguous"
    if case == "megastep":
        assert teng.runner._graphs.captures >= 1
    if case == "ngram":
        assert teng.scheduler.spec_steps > 0
