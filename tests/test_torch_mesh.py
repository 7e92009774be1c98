"""The port's in-mesh axes (dp, pp, sp, ep, tp on the contiguous layout)
against the JAX package.

Weights are the JAX package's permutation checkpoint
(``testing/modelgen.py``: O(1) greedy margins) with attention and the
MLP kept live (``wo`` and ``w_down`` random at 0.3 / sqrt(fan_in *
hidden), so every layer reaches the logits), made from a numpy seed and
crossed through numpy.  The JAX side runs on the conftest's 8 virtual
CPU devices, the port's ranks on ``devices=["cpu"] * n``.

- The mesh record: rank coordinates in JAX's device-array order, the
  ranks along an axis; ``param_pspecs`` and ``cache_pspec`` equal JAX's;
  ``shard_params`` on a pp x ep x tp mesh concatenates back exactly.
- Runners: greedy streams token-identical to JAX's ``ModelRunner`` on the
  same mesh spec ("2" contiguous, "2x1x1x1x1", "1x2x1x1x2", "1x1x2x1x1",
  "2x2x1x2"), int8 KV on dp and tp, int8 weights on pp; the step logits
  within 2e-2 + 1e-2·|x| of JAX's dense forward (bf16); the embeddings
  on pp and sp against JAX's runner's (fp32, 1e-5).
- ep: the paged int8 runner on ``tiny-test-moe`` under "1x2x2" against
  JAX's (``tests/test_multichip_matrix.py``) and against ep=1.
- Engines: ``TorchEngine`` streams on dp, pp and sp meshes (the default
  paged config, moved to the contiguous layout with JAX's note) equal
  ``JaxEngine``'s, a seeded sampled stream included.
- Megastep equals eager on every new axis (the graph path on the CPU
  through the megastep tests' ``fake_capture``).
- The plan: ``sweep()`` equals JAX's cell for cell (status, runner,
  layout, notes), ``multihost-tp`` included.
- ``MultiEngine.capture_profile`` traces the child with the most live
  streams (ROADMAP Queue 3 item 16).
"""

import logging
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.testing.modelgen import permutation_params  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.graphs import GraphCache  # noqa: E402
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.parallel import mesh as M  # noqa: E402
from crowdllama_tpu_torch.parallel import sharding as S  # noqa: E402

MAX_SEQ = 128
PROMPTS = {0: list(range(1, 20)), 1: [5, 9, 5, 9, 5, 7, 11],
           3: list(range(30, 70))}
STEPS = 8


def _n(spec: str) -> int:
    return math.prod(M.mesh_axes(spec))


def _cpus(spec: str) -> list[str]:
    return ["cpu"] * _n(spec)


def _live_flat(model: str = "tiny-test", seed: int = 0) -> dict:
    """The permutation weights with ``wo`` and ``w_down`` made live."""
    jcfg = j_get_config(model, max_context_length=MAX_SEQ)
    flat = {k: np.asarray(v, np.float32) for k, v in
            _flatten_params(permutation_params(jcfg)).items()}
    rng = np.random.default_rng(seed)
    for name in ("layers/wo", "layers/w_down"):
        w = flat[name]
        fan_in = w.shape[-2]
        flat[name] = (rng.standard_normal(w.shape) * (
            0.3 / np.sqrt(fan_in * jcfg.hidden_size))).astype(np.float32)
    return flat


def _tree_flat(tree: dict, prefix: str = "") -> dict:
    """A JAX tree as flat numpy, ``q`` / ``s`` per quantized leaf (JAX's
    ``_flatten_params`` cannot flatten a QTensor)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_tree_flat(v, key))
        elif hasattr(v, "q"):
            flat[key + "/q"] = np.asarray(v.q)
            flat[key + "/s"] = np.asarray(v.s)
        else:
            flat[key] = np.asarray(v, np.float32)
    return flat


def _jtree(flat: dict, dtype=jnp.bfloat16) -> dict:
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, dtype)
    return out


# ------------------------------------------------------------ mesh record

@pytest.mark.parametrize("spec", ["2", "2x1", "2x2x2", "1x2x2x2",
                                  "2x2x1x1x2", "1x2x1x2x2"])
def test_mesh_coords_follow_jax_device_array(spec):
    from crowdllama_tpu.parallel.mesh import build_mesh as j_build_mesh

    jmesh = j_build_mesh(spec)
    mesh = M.build_mesh(spec, devices=[f"cpu:{i}" for i in range(_n(spec))])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(mesh.size):
        (where,) = np.argwhere(ids == jax.devices()[r].id)
        assert mesh.coords(r) == tuple(int(c) for c in where)
        assert mesh.rank(*mesh.coords(r)) == r
        assert mesh.devices[r] == torch.device("cpu", r)
    for axis in M.AXES:
        ranks = mesh.ranks_along(axis)
        assert [mesh.coords(r)[M.AXES.index(axis)] for r in ranks] == list(
            range(mesh.axes[axis]))


@pytest.mark.parametrize("model", ["tiny-test", "tiny-test-moe",
                                   "tiny-test-qwen2", "tiny-test-gemma",
                                   "tiny-test-qwen3-moe"])
def test_partition_specs_are_jax(model):
    from crowdllama_tpu.parallel.sharding import cache_pspec, param_pspecs

    def walk(ours, theirs):
        assert set(ours) == set(theirs)
        for k, v in ours.items():
            if isinstance(v, dict):
                walk(v, theirs[k])
            else:
                assert v == tuple(theirs[k]), k

    walk(S.param_pspecs(get_config(model)), param_pspecs(j_get_config(model)))
    assert S.cache_pspec() == tuple(cache_pspec())


def test_shard_params_on_pp_ep_tp_join_back():
    """Every leaf's ranks, joined along the axes its spec names, give the
    full leaf; replicated leaves are whole copies on every rank."""
    cfg = get_config("tiny-test-moe", max_context_length=MAX_SEQ)
    params = params_from_numpy(_live_flat("tiny-test-moe"))
    mesh = M.build_mesh("1x2x1x2x2", devices=_cpus("1x2x1x2x2"))
    shards = S.shard_params(params, cfg, mesh)
    specs = S.param_pspecs(cfg)

    def leaves(tree, spec, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, spec[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v, spec[k]

    for name, full, spec in leaves(params, specs):
        path = name.split("/")

        def at(r):
            node = shards[r]
            for p in path:
                node = node[p]
            return node

        def join(fixed: dict, axes: list):
            if not axes:
                return at(mesh.rank(**fixed))
            axis, rest = axes[0], axes[1:]
            dim = spec.index(axis)
            return torch.cat([join({**fixed, axis: c}, rest)
                              for c in range(mesh.axes[axis])], dim=dim)

        named = [a for a in spec if a is not None]
        assert torch.equal(join({}, named), full), name
        for r in range(mesh.size):  # every rank: its slice, or a copy
            c = dict(zip(M.AXES, mesh.coords(r)))
            want = full
            for axis in named:
                dim = spec.index(axis)
                n = full.shape[dim] // mesh.axes[axis]
                want = want.narrow(dim, c[axis] * n, n)
            assert torch.equal(at(r), want), (name, r)
    groups = S.rank_groups(shards, mesh)
    assert set(groups) == {(0, 0, 0), (0, 1, 0)}
    banks = groups[(0, 1, 0)][1]["layers"]["w_gate"]
    assert isinstance(banks, S.ExpertBanks) and len(banks) == 2
    assert banks[0].banks[1].shape == (cfg.num_experts // 2, cfg.hidden_size,
                                       cfg.intermediate_size // 2)


# ---------------------------------------------------------------- runners

def _jax_runner(flat, spec, kv_dtype="bf16", quantize="", dtype=jnp.bfloat16,
                model="tiny-test"):
    from crowdllama_tpu.engine.runner import ModelRunner as JRunner
    from crowdllama_tpu.ops.quant import quantize_params

    jcfg = j_get_config(model, max_context_length=MAX_SEQ)
    tree = _jtree(flat, dtype)
    if quantize:
        tree = quantize_params(tree, mode=quantize)
    return JRunner(jcfg, params=tree, mesh_spec=spec, max_slots=4,
                   max_seq=MAX_SEQ, dtype=dtype, kv_dtype=kv_dtype), tree


def _port_runner(flat_or_params, spec, kv_dtype="bf16",
                 dtype=torch.bfloat16, model="tiny-test", cls=ModelRunner,
                 **kw):
    cfg = get_config(model, max_context_length=MAX_SEQ)
    params = (flat_or_params if "layers" in flat_or_params
              else params_from_numpy(flat_or_params, dtype=dtype))
    where = (dict(device="cpu") if not spec
             else dict(mesh_shape=spec, devices=_cpus(spec)))
    return cls(cfg, params=params, max_slots=4, max_seq=MAX_SEQ, dtype=dtype,
               kv_dtype=kv_dtype, **where, **kw)


def _drive(r, key=None, steps=STEPS):
    """Prefill and insert PROMPTS (slot 3 lies on dp rank 1 of a dp=2
    mesh), then decode ``steps`` greedy steps: (first tokens, the decode
    tokens [K, B], the state)."""
    st = r.init_state()
    firsts = {}
    for slot, p in PROMPTS.items():
        tok, ks, vs, plen = r.prefill(p, 0.0, 1.0, key, state=st)
        st = r.insert(st, slot, ks, vs, plen, tok, 0.0, 1.0,
                      prompt_tokens=p)
        firsts[slot] = int(tok)
    toks, st = r.decode_steps(st, steps)
    return firsts, np.asarray(toks), st


RUNNER_CASES = [
    ("2", "bf16", ""),
    ("2x1x1x1x1", "bf16", ""),
    ("1x2x1x1x2", "bf16", ""),
    ("1x1x2x1x1", "bf16", ""),
    ("2x2x1x2", "bf16", ""),
    ("2x1", "int8", ""),
    ("2", "int8", ""),
    ("1x2x1x1x1", "bf16", "int8"),
]


@pytest.mark.parametrize("spec,kv_dtype,quantize", RUNNER_CASES)
def test_runner_greedy_streams_match_jax(spec, kv_dtype, quantize):
    flat = _live_flat()
    jr, jtree = _jax_runner(flat, spec, kv_dtype, quantize)
    want_first, want, _ = _drive(jr, key=jax.random.PRNGKey(0))
    tparams = params_from_numpy(_tree_flat(jtree), dtype=torch.bfloat16)
    r = _port_runner(tparams, spec, kv_dtype)
    assert r.mesh.shape == M.parse_mesh_spec(spec, _n(spec))
    got_first, got, st = _drive(r)
    assert got_first == want_first
    np.testing.assert_array_equal(got[:, list(PROMPTS)],
                                  want[:, list(PROMPTS)])

    # One more step's logits against JAX's dense forward over each
    # sequence so far (bf16 weights; the mesh's cache, int8 or not).
    with torch.inference_mode():
        logits = r.decode_logits(st).float().numpy()
    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    for slot, p in PROMPTS.items():
        seq = p + [got_first[slot]] + [int(t) for t in got[:, slot]]
        ref = np.asarray(JT.prefill(jtree, jcfg, jnp.asarray(seq)[None],
                                    jnp.arange(len(seq))[None])[0][0, -1],
                         np.float32)
        np.testing.assert_allclose(logits[slot], ref, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("spec", ["2x1x1x1x1", "2"])
def test_spec_runner_on_dp_and_tp_matches_jax(spec):
    """n-gram speculation on the contiguous dp and tp meshes (JAX's "spec
    on dp2" cell): the packed verify blocks equal JAX's; sp and pp are
    refused as JAX refuses them."""
    from crowdllama_tpu.engine.spec import SpecModelRunner as JSpec
    from crowdllama_tpu_torch.engine.spec import SpecModelRunner

    flat = _live_flat(seed=5)
    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    jr = JSpec(jcfg, params=_jtree(flat), mesh_spec=spec, max_slots=4,
               max_seq=MAX_SEQ, dtype=jnp.bfloat16, draft_len=3)
    r = _port_runner(flat, spec, cls=SpecModelRunner, draft_len=3)
    # The permutation model continues t with t + 1: prompts that echo a
    # run make the n-gram drafts right.
    prompts = {0: list(range(10, 20)) + [10, 11],
               3: list(range(40, 52)) + [40, 41]}
    out = []
    for runner, key in ((jr, jax.random.PRNGKey(0)), (r, None)):
        st = runner.init_state()
        for slot, p in prompts.items():
            tok, ks, vs, plen = runner.prefill(p, 0.0, 1.0, key)
            st = runner.insert(st, slot, ks, vs, plen, tok, 0.0, 1.0,
                               prompt_tokens=p)
        packed, st = runner.decode_steps(st, 4)
        out.append(np.asarray(packed)[:, :, list(prompts)])
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1][:, 0].max() > 1  # drafts were accepted
    for bad in ("1x2x1x1x1", "1x1x2x1x1"):
        with pytest.raises(ValueError, match="sp/pp"):
            _port_runner(flat, bad, cls=SpecModelRunner)


@pytest.mark.parametrize("spec", ["1x2x1x1x1", "1x1x2x1x1"])
def test_embeddings_on_pp_and_sp_match_jax(spec):
    flat = _live_flat(seed=1)
    jr, _ = _jax_runner(flat, spec, dtype=jnp.float32)
    r = _port_runner(flat, spec, dtype=torch.float32)
    prompts = [list(range(1, 12)), [7, 8, 9], list(range(40, 90))]
    np.testing.assert_allclose(r.embed_prompts(prompts),
                               np.asarray(jr.embed_prompts(prompts)),
                               atol=1e-5, rtol=1e-5)
    one = _port_runner(flat, "", dtype=torch.float32)
    np.testing.assert_allclose(r.embed_prompts(prompts),
                               one.embed_prompts(prompts), atol=1e-5)


def test_paged_int8_moe_runner_under_ep_tp_matches_jax_and_ep1():
    """JAX's ``test_paged_int8_runner_under_tp_mesh`` cell: paged int8
    pools, ``tiny-test-moe`` on an ep x tp mesh (each bank's rows through
    its own rank, the combine in the one-device order)."""
    from crowdllama_tpu.engine.paged import PagedModelRunner as JPaged
    from crowdllama_tpu.parallel.mesh import build_mesh as j_build_mesh

    flat = _live_flat("tiny-test-moe", seed=2)
    jcfg = j_get_config("tiny-test-moe", max_context_length=MAX_SEQ)
    jr = JPaged(jcfg, params=_jtree(flat, jnp.float32),
                mesh=j_build_mesh((1, 1, 1, 2, 2),
                                  devices=jax.devices()[:4]),
                max_slots=4, max_seq=MAX_SEQ, page_size=32,
                kv_dtype="int8", dtype=jnp.float32)
    want_first, want, _ = _drive(jr, key=jax.random.PRNGKey(1), steps=4)
    runs = {}
    for spec in ("1x2x2", "1"):
        r = _port_runner(flat, spec, "int8", torch.float32, "tiny-test-moe",
                         PagedModelRunner, page_size=32)
        runs[spec] = _drive(r, steps=4)[:2]
        if spec == "1x2x2":
            assert (r.ep, r.tp) == (2, 2)
            assert isinstance(r.params[0]["layers"]["w_up"], S.ExpertBanks)
            st = r.init_state()
            assert len(st.pool_k) == 2  # the pools shard on tp only
    got_first, got = runs["1x2x2"]
    assert got_first == want_first
    np.testing.assert_array_equal(got[:, list(PROMPTS)],
                                  want[:, list(PROMPTS)])
    assert runs["1"][0] == got_first
    np.testing.assert_array_equal(runs["1"][1], got)


def test_runner_mesh_rules_follow_jax():
    """max_slots rounds down to a multiple of dp (with JAX's warning); sp
    needs max_seq % sp == 0 and filters the buckets; pp needs L % pp ==
    0 and no sp; int8 KV refuses sp and pp; chunked admission is off on
    pp and sp; paged refuses dp, sp and pp."""
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    kw = dict(dtype=torch.float32)
    r = ModelRunner(cfg, mesh_shape="2x1", devices=_cpus("2x1"),
                    max_slots=5, max_seq=MAX_SEQ, **kw)
    assert r.max_slots == 4 and r.prefill_chunk > 0
    r = ModelRunner(cfg, mesh_shape="1x4x1x1", devices=_cpus("1x4x1x1"),
                    max_slots=1, max_seq=96, **kw)
    assert all(b % 4 == 0 for b in r.buckets) and r.prefill_chunk == 0
    with pytest.raises(ValueError, match="divide by sp"):
        ModelRunner(cfg, mesh_shape="1x4x1x1", devices=_cpus("1x4x1x1"),
                    max_seq=90, **kw)
    with pytest.raises(ValueError, match="not divisible by pp"):
        ModelRunner(cfg, mesh_shape="1x4x1x1x1", devices=_cpus("1x4x1x1x1"),
                    **kw)
    with pytest.raises(ValueError, match="pp x sp"):
        ModelRunner(cfg, mesh_shape="1x2x2x1x1", devices=_cpus("1x2x2x1x1"),
                    **kw)
    for spec in ("1x2x1x1x1", "1x1x2x1x1"):
        with pytest.raises(ValueError, match="int8 KV cache"):
            ModelRunner(cfg, mesh_shape=spec, devices=_cpus(spec),
                        kv_dtype="int8", **kw)
    for spec in ("2x1", "1x2x1x1x1", "1x1x2x1x1"):
        with pytest.raises(ValueError, match="plain/tp/ep meshes only"):
            PagedModelRunner(cfg, mesh_shape=spec, devices=_cpus(spec), **kw)
    r = ModelRunner(cfg, mesh_shape="1x2x1x1x1", devices=_cpus("1x2x1x1x1"),
                    max_slots=3, max_seq=32, **kw)  # JAX's odd slots case
    st = r.init_state()
    tok, ks, vs, plen = r.prefill([1, 2, 3], 0.0, 1.0)
    st = r.insert(st, 0, ks, vs, plen, tok, 0.0, 1.0)
    toks, _ = r.decode_steps(st, 2)
    assert toks.shape == (2, 3)


# ---------------------------------------------------------------- engines

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


_LONG = "a long prompt goes through the mesh while the others decode!"
_REQS = [("short one", {}), (_LONG, {}),
         ("seeded", dict(temperature=0.8, seed=1234))]


@pytest.mark.parametrize("spec", ["2x1x1x1x1", "1x2x1x1x1", "1x1x2x1x1"])
async def test_engine_streams_on_dp_pp_sp_match_jax_engine(tmp_path, spec):
    from crowdllama_tpu.config import Configuration as JaxConfiguration
    from crowdllama_tpu.config import Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.engine.weights import save_params

    flat = _live_flat(seed=3)
    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    ckpt = save_params(jcfg, _jtree(flat, jnp.float32), tmp_path / "live",
                       {"note": "live permutation weights"})
    common = dict(max_context_length=MAX_SEQ, max_batch_slots=4,
                  mesh_shape=spec)
    jeng = JaxEngine(JaxConfiguration(model="tiny-test", model_path=str(ckpt),
                                      warmup=False,
                                      intervals=Intervals.default(),
                                      **common))
    await jeng.start()
    try:
        jeng.scheduler.runner.prefill_chunk = min(
            32, jeng.scheduler.runner.prefill_chunk)
        want = await _streams(jeng, _REQS)
    finally:
        await jeng.stop()
    eng = TorchEngine(params=params_from_numpy(flat, dtype=torch.bfloat16),
                      model="tiny-test", warmup=False, devices=_cpus(spec),
                      **common)
    await eng.start()
    try:
        eng.runner.prefill_chunk = min(32, eng.runner.prefill_chunk)
        got = await _streams(eng, _REQS)
    finally:
        await eng.stop()
    assert got == want
    assert len(set(got[-1])) > 2  # the seeded stream really sampled
    assert type(eng.runner) is ModelRunner
    assert eng.plan.kv_layout == "contiguous" and eng.plan.fallback
    assert eng.plan.notes == [
        f"paged layout does not compose with mesh {spec} (dp/sp/pp > 1); "
        f"using the contiguous layout"]
    d = eng.describe()
    assert d["mesh"] == dict(zip(M.AXES, M.mesh_axes(spec)))
    assert d["devices"] == ["cpu"] * _n(spec)
    if spec.startswith("2x"):
        assert eng.scheduler.prefill_chunks >= 2  # legacy chunks on dp


async def test_engine_logs_the_plan_note(caplog):
    eng = TorchEngine(model="tiny-test", warmup=False, devices=["cpu"] * 2,
                      dtype=torch.float32, max_context_length=MAX_SEQ,
                      max_batch_slots=2, mesh_shape="2x1")
    with caplog.at_level(logging.WARNING, logger="crowdllama.torch.engine"):
        await eng.start()
    await eng.stop()
    assert any("using the contiguous layout" in r.getMessage()
               for r in caplog.records)


# --------------------------------------------------------------- megastep

def _fake_capture(fn):
    outs = fn()

    def replay():
        for o, r in zip(outs, fn()):
            o.copy_(r)

    return replay, outs, 0


@pytest.mark.parametrize("spec,model,cls", [
    ("2", "tiny-test", ModelRunner),
    ("2x1", "tiny-test", ModelRunner),
    ("1x2x1x1x2", "tiny-test", ModelRunner),
    ("1x1x2x1x1", "tiny-test", ModelRunner),
    ("1x2x1", "tiny-test-moe", PagedModelRunner),
])
def test_megastep_equals_eager_on_every_new_axis(spec, model, cls):
    """A K-step flight through the graph path (captured by the CPU
    stand-in) emits the eager steps' tokens, a sampled slot included."""
    flat = _live_flat(model, seed=4)
    extra = dict(page_size=32) if cls is PagedModelRunner else {}
    runs = []
    for mega in (False, True):
        r = _port_runner(flat, spec, dtype=torch.float32, model=model,
                         cls=cls, **extra)
        if mega:
            r._graphs = GraphCache(capture=_fake_capture)
        st = r.init_state()
        for slot, p in PROMPTS.items():
            tok, ks, vs, plen = r.prefill(p, 0.0, 1.0, state=st)
            temp = 0.7 if slot == 1 else 0.0
            st = r.insert(st, slot, ks, vs, plen, tok, temp, 1.0,
                          prompt_tokens=p, slot_key=np.array([slot, 99],
                                                             np.uint32))
        if mega:
            toks, done, st = r.decode_megastep(st, 4)
            toks2, _, st = r.decode_megastep(st, 4)
            assert sum(g.replays for g in r._graphs._graphs.values()) == 2
            runs.append(torch.cat([toks, toks2]).numpy())
        else:
            runs.append(r.decode_steps(st, 8)[0])
    np.testing.assert_array_equal(runs[1], runs[0])


# ------------------------------------------------------------------- plan

def test_sweep_matches_jax_cell_for_cell():
    from crowdllama_tpu.engine.plan import sweep as j_sweep
    from crowdllama_tpu_torch.engine.plan import MESH_KINDS, sweep

    from crowdllama_tpu.engine.plan import MESH_KINDS as J_MESH_KINDS

    assert MESH_KINDS == J_MESH_KINDS
    ours, theirs = list(sweep()), list(j_sweep(8))
    assert len(ours) == len(theirs) == 144
    for (axes, got), (jaxes, want) in zip(ours, theirs):
        assert axes == jaxes
        # multihost-tp included: n_processes=2 resolves as JAX's does.
        assert got[0] == want[0], axes
        if got[0] != "error":
            g, w = got[1], want[1]
            assert (g.runner, g.kv_layout, g.kv_dtype, g.quantize, g.spec,
                    g.notes) == (w.runner, w.kv_layout, w.kv_dtype,
                                 w.quantize, w.spec, w.notes), axes


def test_plan_refusals_name_their_items():
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.plan import (
        render_markdown,
        resolve_serving_plan,
    )

    from crowdllama_tpu.config import Configuration as JConfiguration
    from crowdllama_tpu.engine.plan import (
        resolve_serving_plan as j_resolve,
    )

    # Two processes resolve as JAX's plan does (no refusal).
    got = resolve_serving_plan(Configuration(mesh_shape="2"), n_processes=2)
    want = j_resolve(JConfiguration(mesh_shape="2"), 8, n_processes=2)
    assert (got.runner, got.kv_layout, got.notes) == (
        want.runner, want.kv_layout, want.notes)
    with pytest.raises(ValueError, match="Queue 1 item 8.3"):
        resolve_serving_plan(Configuration(mesh_shape="2x1", megastep_k=4))
    with pytest.raises(ValueError, match="Queue 1 item 8.3"):
        resolve_serving_plan(Configuration(mesh_shape="1x2x1x1x1",
                                           megastep_k=4),
                             devices=["cuda:0", "cuda:1"])
    plan = resolve_serving_plan(Configuration(mesh_shape="1x1x2x1x1",
                                              megastep_k=4),
                                devices=["cpu", "cpu"])
    assert plan.runner == "ModelRunner" and plan.fallback
    table = render_markdown()
    assert table.count("\n") == 145 and "⚠ ModelRunner" in table


# ------------------------------------------------------------ MultiEngine

async def test_multi_engine_profiles_the_busiest_child(tmp_path, caplog):
    """All traffic goes to the second child: the profile opens on that
    child's dispatch thread (its operators are in the trace) and the log
    names it."""
    import json
    import threading

    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.multi import MultiEngine

    cfg = Configuration(model="tiny-test, tiny-test-qwen2",
                        max_context_length=256, kv_page_size=16,
                        max_batch_slots=4, warmup=False,
                        profile_dir=str(tmp_path))
    multi = MultiEngine(cfg, device="cpu", dtype=torch.float32)
    await multi.start()
    try:
        second = multi._engines["tiny-test-qwen2"]
        tid = await second.scheduler.on_dispatch_thread(
            threading.get_native_id)
        gen = multi.generate("abc", model="tiny-test-qwen2", max_tokens=300)
        await gen.__anext__()
        with caplog.at_level(logging.INFO,
                             logger="crowdllama.torch.engine.multi"):
            out = await multi.capture_profile(0.3)
        await gen.aclose()
    finally:
        await multi.stop()
    assert any("tiny-test-qwen2" in r.getMessage() for r in caplog.records)
    (trace,) = [t for t in (tmp_path / "plugins" / "profile").rglob(
        "*.pt.trace.json") if str(t.parent) == out]
    ops = [e for e in json.loads(trace.read_text())["traceEvents"]
           if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops and {e["tid"] for e in ops} == {tid}


def test_mesh_state_shards_the_cache():
    """The mesh state's cache is one shard a (dp, pp, sp, tp) rank with
    the shape the partition rules give; a slot's prompt lands in its dp
    rank's shards only, each sp shard holding the positions it owns (the
    prompt's bucket, padding included, as JAX's insert writes it)."""
    r = _port_runner(_live_flat(), "2x2x1x2", dtype=torch.float32)
    st = r.init_state()
    cfg = r.cfg
    assert len(st.k_cache) == 2 * 2 * 2
    assert all(k.shape == (cfg.num_layers, 2, cfg.num_kv_heads // 2,
                           MAX_SEQ // 2, cfg.resolved_head_dim())
               for k in st.k_cache)
    p = list(range(1, 41))  # a 64-token bucket: the first shard only
    tok, ks, vs, plen = r.prefill(p, 0.0, 1.0)
    st = r.insert(st, 3, ks, vs, plen, tok, 0.0, 1.0)  # dp rank 1, slot 1
    for i, k in enumerate(st.k_cache):
        d, s = i // 4, (i // 2) % 2
        used = k[:, 1].abs().sum(dim=(0, 1, 3)) > 0  # [S/sp] positions
        assert not k[:, 0].any()
        assert int(used.sum()) == (64 if (d, s) == (1, 0) else 0)
