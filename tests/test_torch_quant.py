"""Weight-only int8 / int4 quantization of the port against the JAX
package.

- ``ops/quant.py``: ``quantize_weight``, ``quantize_weight_int4`` and
  ``dequant`` bit-identical to JAX's on hypothesis shapes (``d_in`` a
  multiple of 64 and not, leading axes, odd ``d_out`` refused with JAX's
  message); ``qeinsum`` / ``qragged_dot`` (kernel G's plain version)
  against JAX's within 1e-5 (fp32 sums in another order over
  bf16-exact operands); ``quantize_params`` and
  ``random_quantized_params`` with JAX's structure (names, classes,
  shapes, dtypes); tp slices of ``QTensor`` / ``QTensor4`` concatenating
  back to the whole leaf.
- The model: prefill and decode logits on one quantized tree (JAX's
  ``quantize_params`` of fp32 weights, carried across as ``q`` / ``s``)
  against JAX's transformer for every ``tiny-test*`` family, within 1e-4
  (the same dequantised bf16 weights, fp32 products in another order);
  JAX's own correlation checks (``tests/test_quant.py``) mirrored on the
  port.
- The engine: ``TorchEngine(quantize=int8|int4)`` greedy streams equal
  to ``JaxEngine``'s on the permutation checkpoint (both packages
  quantize the same bf16 weights, bit-identically), on paged bf16 and
  int8 KV, the contiguous layout and tp=2.
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

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

FAMILIES = ["tiny-test", "tiny-test-gemma", "tiny-test-qwen2",
            "tiny-test-qwen3", "tiny-test-mistral", "tiny-test-moe",
            "tiny-test-qwen3-moe"]
ATOL = 1e-4


def _bits(a) -> np.ndarray:
    """A numpy (ml_dtypes) or torch array's raw bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.uint16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _weight(seed: int, shape, scale_spread: bool = True) -> np.ndarray:
    """Random weights whose output channels differ in scale (and hold
    exact ties at the channel maximum now and then)."""
    r = np.random.default_rng(seed)
    w = r.standard_normal(shape).astype(np.float32)
    if scale_spread:
        w *= np.exp(r.uniform(-3, 3, shape[-1])).astype(np.float32)
    return w


shapes = st.tuples(st.sampled_from([(), (2,), (2, 3)]),
                   st.sampled_from([1, 7, 48, 64, 100, 128, 192]),
                   st.sampled_from([2, 6, 32, 64, 130]))


@settings(max_examples=20, deadline=None)
@given(shapes, st.integers(0, 2 ** 31 - 1), st.sampled_from(["f32", "bf16"]))
def test_quantize_and_dequant_bit_identical_to_jax(shape, seed, dtype):
    lead, d_in, d_out = shape
    w = _weight(seed, (*lead, d_in, d_out))
    jw = jnp.asarray(w, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.float32 if dtype == "f32"
                                else torch.bfloat16)
    for jfn, tfn in ((JQ.quantize_weight, Q.quantize_weight),
                     (JQ.quantize_weight_int4, Q.quantize_weight_int4)):
        want = jfn(jw)
        got = tfn(tw)
        assert type(got).__name__ == type(want).__name__
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_bits(got.q), _bits(want.q))
        np.testing.assert_array_equal(_bits(got.s), _bits(want.s))
        np.testing.assert_array_equal(_bits(Q.dequant(got)),
                                      _bits(JQ.dequant(want)))


def test_int4_refuses_odd_output_dim_with_jax_message():
    w = np.ones((64, 5), np.float32)
    with pytest.raises(ValueError) as jerr:
        JQ.quantize_weight_int4(jnp.asarray(w))
    with pytest.raises(ValueError) as terr:
        Q.quantize_weight_int4(torch.from_numpy(w))
    assert str(terr.value) == str(jerr.value)


def test_int4_packing_is_jax_column_order():
    """Column 2j in the low nibble, 2j + 1 in the high one: values -7..7
    packed and unpacked through both packages."""
    vals = np.tile(np.arange(-7, 8, dtype=np.float32), 2)  # 30 columns
    w = np.concatenate([vals[None], np.full((63, 30), 7, np.float32)])
    got = Q.quantize_weight_int4(torch.from_numpy(w))  # every scale ~1
    want = JQ.quantize_weight_int4(jnp.asarray(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(Q.unpack_int4(got.q).numpy()[0], vals)
    lo, hi = got.q.numpy()[0] << 4 >> 4, got.q.numpy()[0] >> 4
    np.testing.assert_array_equal(lo, vals[0::2])
    np.testing.assert_array_equal(hi, vals[1::2])


def _qtensor_pair(kind: str, shape, seed: int):
    w = _weight(seed, shape)
    fn = {"int8": (JQ.quantize_weight, Q.quantize_weight),
          "int4": (JQ.quantize_weight_int4, Q.quantize_weight_int4)}[kind]
    return fn[0](jnp.asarray(w)), fn[1](torch.from_numpy(w))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_qeinsum_and_qragged_dot_match_jax(kind, act):
    """The plain products against JAX's on the same quantized weights:
    a dense einsum, and a ragged dot over a bank of 4 experts with an
    empty group, at fp32 and bf16 activations (fp32: 1e-5; bf16 output:
    one bf16 rounding, 1e-2 of the output's scale)."""
    jdt, tdt = ((jnp.float32, torch.float32) if act == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    r = np.random.default_rng(3)
    x = r.standard_normal((5, 64)).astype(np.float32)
    jq, tq = _qtensor_pair(kind, (64, 96), 1)
    want = JQ.qeinsum("td,dn->tn", jnp.asarray(x, jdt), jq)
    got = Q.qeinsum("td,dn->tn", torch.from_numpy(x).to(tdt), tq)
    tol = 1e-5 if act == "f32" else 1e-2 * float(np.abs(
        np.asarray(want, np.float32)).max())
    assert got.dtype == tdt and str(want.dtype) == str(tdt).split(".")[1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)
    xs = r.standard_normal((11, 64)).astype(np.float32)
    sizes = np.array([4, 0, 6, 1], np.int32)
    jbank, tbank = _qtensor_pair(kind, (4, 64, 96), 2)
    want = JQ.qragged_dot(jnp.asarray(xs, jdt), jbank, jnp.asarray(sizes))
    got = Q.qragged_dot(torch.from_numpy(xs).to(tdt), tbank,
                        torch.from_numpy(sizes))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def _structure(tree, prefix="") -> dict:
    """name -> (class, shapes and dtypes of its arrays), JAX or port."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_structure(v, key))
        elif hasattr(v, "q"):
            out[key] = (type(v).__name__, tuple(v.q.shape), tuple(v.s.shape),
                        str(v.q.dtype).split(".")[-1],
                        str(v.s.dtype).split(".")[-1], tuple(v.shape))
        else:
            out[key] = ("array", tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_trees_have_jax_structure(model, mode):
    """``quantize_params`` of an init and ``random_quantized_params``:
    the JAX package's names, classes, shapes and dtypes."""
    jcfg = j_get_config(model, max_context_length=64)
    cfg = get_config(model, max_context_length=64)
    jp = JQ.quantize_params(JT.init_params(jcfg, jax.random.PRNGKey(0)),
                            mode=mode)
    gen = torch.Generator().manual_seed(0)
    tp = Q.quantize_params(T.init_params(cfg, gen), mode=mode)
    assert _structure(tp) == _structure(jp)
    jr = JQ.random_quantized_params(jcfg, jax.random.PRNGKey(0), mode=mode)
    tr = Q.random_quantized_params(cfg, torch.Generator().manual_seed(0),
                                   mode=mode)
    assert _structure(tr) == _structure(jr)
    # The runner's quantized random init is random_quantized_params: the
    # structure of a quantized init.
    born = init_params(cfg, 0, quantize=mode)
    assert _structure(born) == _structure(tr) == _structure(jp)


@pytest.mark.parametrize("kind,spec,shape", [
    ("int8", (None, None, "tp"), (2, 128, 96)),    # column-parallel
    ("int8", (None, "tp", None), (2, 128, 96)),    # row-parallel
    ("int4", (None, None, "tp"), (2, 128, 96)),
    ("int4", (None, "tp", None), (2, 256, 96)),    # 4 groups over tp
    ("int4", (None, "tp", None), (2, 48, 96)),     # one group, replicated
    ("int8", (None, None, None, "tp"), (2, 3, 64, 64)),  # experts on F
    ("int4", (None, None, "tp", None), (2, 3, 256, 64)),
])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_slices_concatenate_back(kind, spec, shape, tp):
    from crowdllama_tpu_torch.parallel.mesh import AXIS_TP
    from crowdllama_tpu_torch.parallel.sharding import _slice_to

    spec = tuple(AXIS_TP if a == "tp" else None for a in spec)
    _, w = _qtensor_pair(kind, shape, 5)
    ranks = [_slice_to(w, spec, r, tp, torch.device("cpu")) for r in range(tp)]
    axis = spec.index(AXIS_TP)
    np.testing.assert_array_equal(
        torch.cat([p.q for p in ranks], axis).numpy(), w.q.numpy())
    # Each rank dequantises to its slice of the whole weight.
    whole = Q.dequant(w)
    got = torch.cat([Q.dequant(p) for p in ranks], axis)
    assert torch.equal(got.view(torch.uint16), whole.view(torch.uint16))
    if kind == "int8" and axis == len(shape) - 2:
        assert all(torch.equal(p.s, w.s) for p in ranks)  # replicated


def test_tp_refuses_int4_groups_that_do_not_split():
    from crowdllama_tpu_torch.parallel.mesh import AXIS_TP
    from crowdllama_tpu_torch.parallel.sharding import _slice_to

    _, w = _qtensor_pair("int4", (192, 64), 0)  # 3 groups
    with pytest.raises(ValueError, match="do not split"):
        _slice_to(w, (AXIS_TP, None), 0, 2, torch.device("cpu"))


# ------------------------------------------------------------------- model

def _quantized_flat(model: str, mode: str, seed: int = 1,
                    max_ctx: int = 256):
    """JAX's quantized tree of random fp32 weights, and its flat numpy
    form (``q`` / ``s`` per quantized leaf: JAX's ``_flatten_params``
    cannot flatten a QTensor)."""
    jcfg = j_get_config(model, max_context_length=max_ctx)
    jp = JQ.quantize_params(JT.init_params(jcfg, jax.random.PRNGKey(seed),
                                           dtype=jnp.float32), mode=mode)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            elif hasattr(v, "q"):
                flat[key + "/q"] = np.asarray(v.q)
                flat[key + "/s"] = np.asarray(v.s)
            else:
                flat[key] = np.asarray(v, np.float32)

    walk(jp)
    return jp, flat


def _dequantized(tree):
    """JAX's tree with every quantized leaf replaced by its eager
    ``dequant`` (q * s rounded to bf16), widened to fp32."""
    return {k: (_dequantized(v) if isinstance(v, dict)
                else jnp.asarray(JQ.dequant(v), jnp.float32)
                if hasattr(v, "q") else v)
            for k, v in tree.items()}


# JAX's products on the quantized tree inside its jitted layer scan: XLA
# fuses the dequant into an fp32 operand and drops the bf16 rounding of
# q * s that ``dequant`` (and the port) makes, a 2^-9 relative change of
# each weight, which random fp32 layers carry to ~1e-2 of the outputs'
# scale and which flips near-tied router choices of MoE layers: there the
# two agree as a whole (their correlation), not element by element.
JIT_CORR = 0.995  # JAX's own int8 bar (tests/test_quant.py)


def _jax_and_port(jp, tp, jcfg, cfg, tokens, pos):
    """Prefill then one decode step over the contiguous cache: the JAX
    outputs and the port's."""
    b, t = tokens.shape
    jl, jk, jv = JT.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    tl, (tk,), (tv,) = T.prefill([tp], cfg, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(pos))
    s = 32
    l, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    kc = np.zeros((l, b, hkv, s, dh), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :, :t] = np.asarray(jk)
    vc[:, :, :, :t] = np.asarray(jv)
    nxt = np.arange(b, dtype=np.int32) * 7 + 3
    dpos = np.full((b,), t, np.int32)
    lens = dpos + 1
    jd = JT.decode_step(jp, jcfg, jnp.asarray(nxt), jnp.asarray(dpos),
                        jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(lens))[0]
    td = T.decode_step([tp], cfg, torch.from_numpy(nxt),
                       torch.from_numpy(dpos), torch.from_numpy(kc),
                       torch.from_numpy(vc), torch.from_numpy(lens))[0]
    return ([np.asarray(a, np.float32) for a in (jl, jk, jd)],
            [a.numpy() for a in (tl, tk, td)])


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_logits_match_jax(model, mode):
    """Prefill logits and KV, then a decode step over the contiguous
    cache, on one quantized tree carried across as ``q`` / ``s``: within
    1e-4 of JAX's transformer on the tree's dequantised weights (the
    port's arithmetic); the prefill's correlated above ``JIT_CORR`` with
    JAX's transformer on the quantized tree itself (a decode step's two
    rows are too few: one flipped router choice decorrelates a row)."""
    jp, flat = _quantized_flat(model, mode)
    tp = params_from_numpy(flat)
    assert isinstance(tp["layers"]["wq"], Q.QTensor)
    assert tp["layers"]["wq"].q.dtype == torch.int8
    assert tp["layers"]["wq"].s.dtype == torch.bfloat16
    jcfg = j_get_config(model, max_context_length=256)
    cfg = get_config(model, max_context_length=256)
    r = np.random.default_rng(4)
    b, t = 2, 12
    tokens = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    want, got = _jax_and_port(_dequantized(jp), tp, jcfg, cfg, tokens, pos)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    fused, _ = _jax_and_port(jp, tp, jcfg, cfg, tokens, pos)
    for g, w in zip(got[:2], fused[:2]):  # prefill logits and keys
        assert _corr(g, w) > JIT_CORR


def _corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64).ravel(),
                             np.asarray(b, np.float64).ravel())[0, 1])


@pytest.mark.parametrize("mode,families,bar", [
    ("int8", ("tiny-test", "tiny-test-moe", "tiny-test-gemma"), 0.995),
    ("int4", ("tiny-test", "tiny-test-moe", "tiny-test-gemma",
              "tiny-test-qwen2", "tiny-test-qwen3"), 0.7),
])
def test_quantized_logits_correlate_with_full_precision(mode, families, bar):
    """JAX's checks (``tests/test_quant.py``) on the port: quantized
    logits correlate with the fp32 model's above the same bars, and the
    port's correlation is JAX's within 1e-3 (JAX's jitted products drop
    the bf16 rounding of the dequantised weights: ``JIT_CORR``)."""
    tokens = np.array([[257, 104, 105, 32, 119]], np.int32)
    pos = np.arange(5)[None].astype(np.int32)
    for name in families:
        cfg = get_config(name, max_context_length=32)
        jcfg = j_get_config(name, max_context_length=32)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(1),
                                 dtype=jnp.float32)
        tparams = params_from_numpy(_flatten_params(jparams))
        ref = T.prefill([tparams], cfg, torch.from_numpy(tokens).long(),
                        torch.from_numpy(pos))[0]
        got = T.prefill([Q.quantize_params(tparams, mode=mode)], cfg,
                        torch.from_numpy(tokens).long(),
                        torch.from_numpy(pos))[0]
        jref = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                          jnp.asarray(pos))[0]
        jgot = JT.prefill(JQ.quantize_params(jparams, mode=mode), jcfg,
                          jnp.asarray(tokens), jnp.asarray(pos))[0]
        corr = _corr(ref.numpy(), got.numpy())
        assert corr > bar, f"{name}: {mode} logits corr {corr}"
        assert abs(corr - _corr(jref, jgot)) < 1e-3


def test_quantize_roundtrip_error_small():
    """JAX's round-trip bound on the port: per-channel int8 errs by at
    most half a scale plus the bf16 rounding of the scale."""
    w = _weight(0, (64, 128), scale_spread=False)
    qt = Q.quantize_weight(torch.from_numpy(w))
    back = Q.dequant(qt).float().numpy()
    scale = qt.s.float().numpy()
    bound = scale[None, :] * 0.51 + np.abs(w) * 0.01 + 1e-6
    assert (np.abs(back - w) <= bound).all()


# ----------------------------------------------------------------- engines

MAX_SEQ, PAGE = 256, 16
COMMON = dict(max_context_length=MAX_SEQ, kv_page_size=PAGE,
              step_token_budget=36, max_batch_slots=4, warmup=False)
PROMPTS = ["the quick brown fox jumps over",
           "the quick brown fox leaps high",
           "a long prompt rides the ragged chunks while others wait " * 2]


class _Recorder:
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
    return out


def _serve(engine):
    async def go():
        await engine.start()
        try:
            return await _streams(engine, PROMPTS)
        finally:
            await engine.stop()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def perm_ckpt(tmp_path_factory):
    from crowdllama_tpu.testing.modelgen import permutation_checkpoint

    return permutation_checkpoint("tiny-test",
                                  tmp_path_factory.mktemp("perm") / "ckpt",
                                  max_context=MAX_SEQ)


QUANT_CASES = {
    "int8_paged": dict(quantize="int8"),
    "int4_paged": dict(quantize="int4"),
    "int8_paged_int8kv": dict(quantize="int8", kv_dtype="int8"),
    "int4_paged_int8kv": dict(quantize="int4", kv_dtype="int8"),
    "int8_contiguous": dict(quantize="int8", kv_layout="contiguous"),
    "int4_contiguous": dict(quantize="int4", kv_layout="contiguous"),
    "int8_tp2": dict(quantize="int8", mesh_shape="2"),
    "int4_tp2": dict(quantize="int4", mesh_shape="2"),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantized_engine_streams_match_jax_engine(case, perm_ckpt):
    """Both engines load the permutation checkpoint in bf16 and quantize
    it (bit-identically): greedy streams token for token, and the port's
    runner holds quantized leaves (its unembedding too)."""
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import load_native_params

    kw = QUANT_CASES[case]
    tkw = dict(kw, devices=["cpu", "cpu"]) if "mesh_shape" in kw else dict(
        kw, device="cpu")
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    teng = TorchEngine(params=load_native_params(cfg, perm_ckpt,
                                                 dtype=torch.bfloat16),
                       dtype=torch.bfloat16, model="tiny-test", **COMMON,
                       **tkw)
    got = _serve(teng)
    lp = teng.runner.params[0]
    want_cls = Q.QTensor4 if kw["quantize"] == "int4" else Q.QTensor
    assert type(lp["layers"]["w_up"]) is want_cls
    assert type(lp["lm_head"]) is want_cls
    assert teng.plan.quantize == kw["quantize"]
    jeng = JaxEngine(Configuration(model="tiny-test", model_path=perm_ckpt,
                                   intervals=Intervals.default(), **COMMON,
                                   **kw))
    assert got == _serve(jeng)


def test_load_params_for_quantizes_as_jax(perm_ckpt):
    """``load_params_for`` with ``quantize``: the checkpoint loaded in
    bf16 and quantized, JAX's structure; every leaf bit-equal to JAX's
    ``quantize_weight`` / ``quantize_weight_int4`` of the same bf16
    weight.  JAX's ``load_params_for`` quantizes in one jitted program,
    where XLA turns the divisions by 127 (7) and by the scale into
    products with reciprocals: its values differ from its own eager
    function's by one level at a few elements (0.3% of them here, at
    most 1%), its scales not at all."""
    from crowdllama_tpu.config import Configuration as JConfiguration
    from crowdllama_tpu.engine import weights as jw
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine import weights as tw

    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    plain = jw.load_or_init_params(jcfg, perm_ckpt)
    for mode, jfn in (("int8", JQ.quantize_weight),
                      ("int4", JQ.quantize_weight_int4)):
        jp = jw.load_params_for(JConfiguration(
            model="tiny-test", model_path=perm_ckpt, quantize=mode), jcfg)
        tp = tw.load_params_for(Configuration(
            model="tiny-test", model_path=perm_ckpt, quantize=mode),
            get_config("tiny-test", max_context_length=MAX_SEQ))
        assert _structure(tp) == _structure(jp)
        leaves = [(tp["layers"][k], plain["layers"][k], jp["layers"][k])
                  for k in Q.QUANT_KEYS]
        leaves.append((tp["lm_head"], plain["lm_head"], jp["lm_head"]))
        for got, w, jitted in leaves:
            want = jfn(w)
            np.testing.assert_array_equal(_bits(got.q), _bits(want.q))
            np.testing.assert_array_equal(_bits(got.s), _bits(want.s))
            np.testing.assert_array_equal(_bits(got.s), _bits(jitted.s))
            gq = Q.unpack_int4(got.q) if mode == "int4" else got.q
            jq = torch.from_numpy(np.array(jitted.q))
            jq = Q.unpack_int4(jq) if mode == "int4" else jq
            diff = (gq.int() - jq.int()).abs()
            assert int(diff.max()) <= 1
            assert float((diff > 0).float().mean()) <= 1e-2
