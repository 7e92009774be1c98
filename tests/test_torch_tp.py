"""Tensor-parallel paged serving of the port against the JAX package.

- The mesh helpers (``parallel/mesh.py``) give JAX's results over a sweep
  of specs and device counts, errors included; the default device list is
  the visible CUDA devices, each once.
- ``shard_params`` follows JAX's partition rules, and its slices
  concatenate back to the full parameters exactly (``tiny-test``,
  ``tiny-test-qwen2`` with sharded biases, ``tiny-test-gemma`` with
  softcaps, windows and post-norms); the reductions are exact where GSPMD's
  are.
- Kernel F's plain version against JAX's F in interpret mode on a
  2-device CPU mesh (bf16 and int8 pools, within 2e-2 + 1e-2·|x|), and
  equal to kernel B's plain version on the unsharded pool.
- The tp=2 runner (``devices=["cpu", "cpu"]``) against the tp=1 runner on
  random fp32 weights: the same greedy tokens through monolithic prefill,
  a prefix hit, the ragged step, decode and legacy chunks; the pools,
  concatenated over ranks, bit-equal; step logits within 2% of their
  scale (bf16 and int8 pools).
- ``TorchEngine(mesh_shape="2", devices=["cpu", "cpu"])`` against
  ``JaxEngine(mesh_shape="2")`` on the permutation checkpoint: greedy
  streams (short prompt, prefix hit, ragged or legacy chunks) and a seeded
  sampled stream token-identical, bf16 and int8 pools; and against the
  port's one-device engine.
- The serving plan: paged + tp serves, every other mesh raises.
"""

import itertools
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
from crowdllama_tpu.ops.pallas import paged as JP  # noqa: E402
from crowdllama_tpu.parallel import mesh as JM  # noqa: E402
from crowdllama_tpu.parallel.sharding import param_pspecs as j_pspecs  # noqa: E402
from crowdllama_tpu_torch.config import Configuration  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.plan import resolve_serving_plan  # noqa: E402
from crowdllama_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_paged_decode_attention,
    flash_paged_decode_attention_tp,
    paged_decode_attention_plain,
    paged_decode_attention_tp_plain,
)
from crowdllama_tpu_torch.ops.quant import quantize_kv  # noqa: E402
from crowdllama_tpu_torch.parallel import mesh as M  # noqa: E402
from crowdllama_tpu_torch.parallel import sharding as S  # noqa: E402

MAX_SEQ = 256


@pytest.fixture
def interpret_mode():
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)


def _jx(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


# ----------------------------------------------------------------- mesh

SPECS = ["", "1", "2", "3", "4", "8", "1x2", "2x2", "4x1", "2x1x2", "1x2x2",
         "1x1x2x2", "1x2x1x1x2", "2x1x1x1x1", "1 x 2", "1x1x1x1x1x1"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_helpers_match_jax(n):
    for spec in SPECS:
        assert (_outcome(M.parse_mesh_spec, spec, n)
                == _outcome(JM.parse_mesh_spec, spec, n)), spec
    for hkv, experts in itertools.product(range(1, 9), (0, 2, 4, 8)):
        assert M.largest_tp(n, hkv) == JM.largest_tp(n, hkv)
        assert (M.choose_mesh_shape(n, hkv, experts)
                == JM.choose_mesh_shape(n, hkv, experts))


def test_build_mesh_devices(monkeypatch):
    """The default device list is the visible CUDA devices, each once; a
    spec needing more raises like JAX's; an explicit list may repeat."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        M.build_mesh("2")
    assert M.build_mesh("1").devices == (torch.device("cuda", 0),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = M.build_mesh("2")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert len(set(M.build_mesh("").devices)) == 4
    mesh = M.build_mesh("2", devices=["cpu", "cpu"])
    assert (mesh.tp, mesh.size) == (2, 2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        M.build_mesh("")


# ------------------------------------------------------------- sharding

def _flat(model: str, seed: int = 0) -> dict:
    cfg = j_get_config(model, max_context_length=MAX_SEQ)
    flat = _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))
    r = np.random.default_rng(seed)  # biases/norms away from zeros/ones
    return {k: (a + 0.1 * r.standard_normal(a.shape)).astype(np.float32)
            if k.split("/")[-1] in ("bq", "bk", "bv", "ln1", "final_norm")
            else a for k, a in flat.items()}


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _tp_dim(spec) -> int | None:
    axes = tuple(spec)
    return axes.index("tp") if "tp" in axes else None


@pytest.mark.parametrize("model", ["tiny-test", "tiny-test-qwen2",
                                   "tiny-test-gemma"])
def test_shard_params_slices_concatenate_to_the_full_params(model):
    cfg = get_config(model, max_context_length=MAX_SEQ)
    params = params_from_numpy(_flat(model))
    mesh = M.build_mesh("2", devices=["cpu", "cpu"])
    shards = S.shard_params(params, cfg, mesh)
    (one,) = S.shard_params(params, cfg, M.Mesh.single(torch.device("cpu")))
    # tp=1: the caller's own tensors, no copy
    assert all(a is b for (_, a), (_, b) in zip(_leaves(one),
                                                _leaves(params)))
    ours, jax_specs = S.param_pspecs(cfg), j_pspecs(
        j_get_config(model, max_context_length=MAX_SEQ))
    for name, full in _leaves(params):
        *path, leaf = name.split("/")
        spec, jspec = ours, jax_specs
        parts = shards
        for p in path:
            spec, jspec = spec[p], jspec[p]
            parts = [s[p] for s in parts]
        spec, jspec = spec[leaf], jspec[leaf]
        parts = [s[leaf] for s in parts]
        assert _tp_dim(spec) == _tp_dim(jspec), name  # JAX's rule
        for x in parts:  # copies, not views of the full tensor
            assert x._base is None and x.is_contiguous()
            assert x.untyped_storage().data_ptr() != \
                full.untyped_storage().data_ptr()
        dim = _tp_dim(spec)
        back = parts[0] if dim is None else torch.cat(parts, dim=dim)
        assert torch.equal(back, full), name
        if dim is None:
            assert torch.equal(parts[1], full), name


def test_reductions_are_exact():
    r = np.random.default_rng(3)
    table = torch.from_numpy(r.standard_normal((16, 8)).astype(np.float32))
    tokens = torch.tensor([[0, 7, 8, 15], [3, 12, 9, 1]])
    halves = list(table.chunk(2))
    assert torch.equal(S.vocab_embed(halves, tokens), table[tokens])
    assert S.vocab_embed([table], tokens).data_ptr() != 0
    parts = [torch.from_numpy(r.standard_normal((3, 8)).astype(np.float32))
             for _ in range(2)]
    assert torch.equal(S.row_parallel_sum(parts), parts[0] + parts[1])
    assert S.row_parallel_sum(parts[:1]) is parts[0]
    assert torch.equal(S.vocab_gather(parts), torch.cat(parts, -1))
    bf = [p.to(torch.bfloat16) for p in parts]  # one rounding of the sum
    assert torch.equal(S.row_parallel_sum(bf),
                       (bf[0].float() + bf[1].float()).to(torch.bfloat16))


# -------------------------------------------------------------- kernel F

def _decode_case(int8: bool):
    r = np.random.default_rng(9)
    b, h, hkv, dh, page = 4, 8, 4, 16, 16
    q = torch.from_numpy(r.standard_normal((b, h, dh)).astype(
        np.float32)).to(torch.bfloat16)
    pk = torch.from_numpy(r.standard_normal((17, hkv, page, dh)).astype(
        np.float32)).to(torch.bfloat16)
    pv = torch.from_numpy(r.standard_normal((17, hkv, page, dh)).astype(
        np.float32)).to(torch.bfloat16)
    table = torch.tensor([[1, 2, 3, 4], [16, 0, 0, 0], [5, 6, 7, 8],
                          [9, 10, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([60, 1, 0, 23], dtype=torch.int32)
    scales = {}
    if int8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, pk, pv, table, lens, scales


def _shard(q, pk, pv, scales, tp):
    """q heads and pool kv heads cut into tp kv-major shares."""
    qs = [x.contiguous() for x in q.chunk(tp, dim=1)]
    pks = [x.contiguous() for x in pk.chunk(tp, dim=1)]
    pvs = [x.contiguous() for x in pv.chunk(tp, dim=1)]
    kw = {}
    if scales:
        kw = {f"{n}s": [x.contiguous() for x in scales[n].chunk(tp, dim=1)]
              for n in ("k_scale", "v_scale")}
    return qs, pks, pvs, kw


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 9)])
def test_tp_decode_plain_matches_jax_kernel(interpret_mode, int8, softcap,
                                            window):
    q, pk, pv, table, lens, scales = _decode_case(int8)
    kw = dict(softcap=softcap, sliding_window=window)
    qs, pks, pvs, skw = _shard(q, pk, pv, scales, 2)
    got = torch.cat(flash_paged_decode_attention_tp(
        qs, pks, pvs, table, lens, 0.25, **skw, **kw), dim=1)
    jscales = {k: _jx(v) for k, v in scales.items()}
    want = JP.flash_paged_decode_attention_tp(
        _jx(q), _jx(pk), _jx(pv), _jx(table), _jx(lens), 0.25,
        JM.build_mesh("2"), **jscales, **kw)
    live = [0, 1, 3]  # slot 2 has no key (the TPU kernel writes zeros)
    np.testing.assert_allclose(got[live].float().numpy(),
                               np.asarray(want, np.float32)[live],
                               atol=2e-2, rtol=1e-2)
    assert torch.equal(got, paged_decode_attention_plain(
        q, pk, pv, table, lens, 0.25, **scales, **kw))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_wrapper_runs_plain_on_cpu_without_launching(tp):
    q, pk, pv, table, lens, scales = _decode_case(False)
    qs, pks, pvs, _ = _shard(q, pk, pv, scales, tp)
    counts = lambda: (flash_paged_decode_attention_tp.launches,  # noqa: E731
                      flash_paged_decode_attention.launches)
    before = counts()
    got = flash_paged_decode_attention_tp(qs, pks, pvs, table, lens, 0.25)
    want = paged_decode_attention_tp_plain(qs, pks, pvs, table, lens, 0.25)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta = [[x.to("meta") for x in xs] for xs in (qs, pks, pvs)]
    with pytest.raises(ValueError):
        flash_paged_decode_attention_tp(*meta, table.to("meta"),
                                        lens.to("meta"), 0.25)
    with pytest.raises(ValueError, match="mixed"):
        flash_paged_decode_attention_tp([qs[0]] + meta[0][1:], pks, pvs,
                                        table, lens, 0.25)
    assert counts() == before


# --------------------------------------------------------------- runners

def _drive(run, prompts):
    """Monolithic prefill (slot 0), a prefix hit (slot 2), the ragged step
    (slot 1) while they decode, four decode steps, step logits, then a
    legacy chunked admission; returns (tokens, logits, state)."""
    p0, p2, p1 = prompts
    toks = []
    with torch.inference_mode():
        st = run.init_state()
        for slot, p in ((0, p0), (2, p2)):
            first, ks, vs, plen = run.prefill(p, 0.0, 1.0, None, state=st)
            st = run.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                            prompt_tokens=p)
            toks.append(first)
        job = run.ragged_begin(p1, 1, st)
        while not job.finished:
            out, st = run.ragged_step(st, job, 1)
            toks += out[0].tolist()
        first, st = run.ragged_finish(st, job, 0.0, 1.0, None)
        toks.append(first)
        out, st = run.decode_steps(st, 4)
        toks += out.ravel().tolist()
        logits = run.decode_logits(st, run._table())
        job = run.prefill_begin(p1 + [5, 6], state=st)
        while not run.prefill_step(job):
            pass
        toks.append(run.prefill_finish(job, 0.0, 1.0, None)[0])
    assert run.prefix_hits >= 2
    return toks, logits, st


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tp_runner_matches_the_one_device_runner(kv_dtype):
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    flat = _flat("tiny-test", 3)
    r = np.random.default_rng(4)
    p0 = [int(t) for t in r.integers(0, 500, 21)]
    prompts = (p0, p0[:18] + [int(t) for t in r.integers(0, 500, 9)],
               [int(t) for t in r.integers(0, 500, 75)])
    kw = dict(max_slots=3, max_seq=MAX_SEQ, page_size=16,
              step_token_budget=35, kv_dtype=kv_dtype)
    one = PagedModelRunner(cfg, params=params_from_numpy(flat), device="cpu",
                           **kw)
    two = PagedModelRunner(cfg, params=params_from_numpy(flat),
                           mesh_shape="2", devices=["cpu", "cpu"], **kw)
    assert (one.tp, two.tp, one.decode_attn, two.decode_attn) == (
        1, 2, flash_paged_decode_attention_tp,
        flash_paged_decode_attention_tp)
    for run in (one, two):
        run.prefill_chunk = 32
    t1, l1, s1 = _drive(one, prompts)
    t2, l2, s2 = _drive(two, prompts)
    assert t1 == t2
    names = ("pool_k", "pool_v") + (("k_scale", "v_scale")
                                    if kv_dtype == "int8" else ())
    for name in names:
        (full,), ranks = getattr(s1, name), getattr(s2, name)
        assert isinstance(ranks, list) and len(ranks) == 2
        assert ranks[0].shape[2] == full.shape[2] // 2
        # Layer 0's K/V come before any reduction: bit-equal.
        assert torch.equal(torch.cat([x[0] for x in ranks], dim=1),
                           full[0]), name
    assert float((l2 - l1).abs().max()) <= 0.02 * float(l1.abs().max())


def test_tp_runner_refusals():
    """JAX's outcomes: the contiguous runner serves a tp mesh; the paged
    runner refuses a dp mesh (JAX's runner asserts: the shared page pool
    cannot shard over dp)."""
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    contiguous = ModelRunner(cfg, mesh_shape="2", devices=["cpu", "cpu"],
                             max_slots=1)
    assert (contiguous.tp, contiguous.kv_layout) == (2, "contiguous")
    with pytest.raises(ValueError, match="cannot shard over dp"):
        PagedModelRunner(cfg, mesh_shape="2x1", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        PagedModelRunner(cfg, device="cpu", mesh_shape="2",
                         devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="kv heads"):  # 2 kv heads, tp=4
        PagedModelRunner(cfg, mesh_shape="4", devices=["cpu"] * 4)
    # The default mesh takes the largest tp the given devices and the kv
    # heads allow (3 devices, 2 kv heads: one device).
    assert PagedModelRunner(cfg, devices=["cpu"] * 3, max_slots=1).tp == 1
    assert PagedModelRunner(cfg, devices=["cpu"] * 2, max_slots=1).tp == 2


# ---------------------------------------------------------------- engine

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


_LONG = "a long prompt rides the ragged chunks while others decode! " * 2
_REQS = [("short one", {}), (_LONG, {}),
         (_LONG[:47] + " and a tail that only the third one has", {}),
         ("seeded", dict(temperature=0.8, seed=1234))]


def _perm(tmp_path):
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=MAX_SEQ)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=MAX_SEQ)))
    return ckpt, flat


async def _torch_streams(flat, common, **kw):
    eng = TorchEngine(params=params_from_numpy(flat, dtype=torch.bfloat16),
                      model="tiny-test", warmup=False, **common, **kw)
    await eng.start()
    try:
        eng.runner.prefill_chunk = 32
        got = await _streams(eng, _REQS)
        return got, eng
    finally:
        await eng.stop()


@pytest.mark.parametrize("kv_dtype,ragged", [
    ("bf16", True), ("bf16", False), ("int8", True), ("int8", False)])
async def test_tp_engine_streams_match_jax_engine(tmp_path, kv_dtype, ragged):
    """Greedy streams (a short prompt, a long prompt admitted in chunks, a
    long prompt sharing its first 47 bytes, so a prefix hit) and a seeded
    sampled stream, token-identical to ``JaxEngine(mesh_shape="2")``."""
    from crowdllama_tpu.config import Configuration as JaxConfiguration
    from crowdllama_tpu.config import Intervals
    from crowdllama_tpu.engine.engine import JaxEngine

    ckpt, flat = _perm(tmp_path)
    common = dict(max_context_length=MAX_SEQ, kv_page_size=16,
                  max_batch_slots=4, ragged_prefill=ragged,
                  step_token_budget=36, kv_dtype=kv_dtype, mesh_shape="2")
    jeng = JaxEngine(JaxConfiguration(model="tiny-test", model_path=ckpt,
                                      warmup=False,
                                      intervals=Intervals.default(),
                                      **common))
    await jeng.start()
    try:
        jeng.scheduler.runner.prefill_chunk = 32
        want = await _streams(jeng, _REQS)
        jhits = jeng.scheduler.runner.prefix_hits
    finally:
        await jeng.stop()
    got, eng = await _torch_streams(flat, common, devices=["cpu", "cpu"])
    sched = eng.scheduler
    chunks = sched.ragged_chunks if ragged else sched.prefill_chunks
    assert chunks >= 2
    assert eng.runner.prefix_hits == jhits >= 1
    assert eng.describe()["tp"] == 2
    assert eng.describe()["devices"] == ["cpu", "cpu"]
    assert got == want
    assert len(set(got[-1])) > 2  # the seeded stream really sampled


async def test_tp_engine_streams_match_the_one_device_engine(tmp_path):
    _, flat = _perm(tmp_path)
    common = dict(max_context_length=MAX_SEQ, kv_page_size=16,
                  max_batch_slots=4, step_token_budget=36)
    want, one = await _torch_streams(flat, common, device="cpu")
    got, two = await _torch_streams(flat, common, mesh_shape="2",
                                    devices=["cpu", "cpu"])
    assert (one.runner.tp, two.runner.tp) == (1, 2)
    assert got == want


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("mesh,layout,fallback", [
    ("2", "paged", False), ("1x2", "paged", False),
    ("1", "contiguous", False), ("2", "contiguous", False),
    ("2x1", "paged", True), ("1x2x1x1x1", "paged", True),
    ("1x1x2x1x1", "paged", True), ("1x2x2", "paged", False)])
def test_plan_serves_paged_tp_only(mesh, layout, fallback):
    """Every mesh gets the JAX plan's runner and layout: a paged request
    on a dp/sp/pp mesh falls back to the contiguous layout with JAX's
    note; tp and ep x tp meshes keep the paged layout."""
    from crowdllama_tpu.config import Configuration as JConfiguration
    from crowdllama_tpu.engine.plan import resolve_serving_plan as jresolve

    plan = resolve_serving_plan(Configuration(mesh_shape=mesh,
                                              kv_layout=layout))
    want = jresolve(JConfiguration(mesh_shape=mesh, kv_layout=layout), 8)
    assert (plan.runner, plan.kv_layout, plan.notes) == (
        want.runner, want.kv_layout, want.notes)
    assert plan.fallback == fallback
    assert plan.kv_layout == ("contiguous" if fallback else layout)
    assert plan.mesh_shape == mesh


def test_engine_mesh_without_enough_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        TorchEngine(mesh_shape="2")
    with pytest.raises(ValueError, match="not both"):
        TorchEngine(device="cpu", devices=["cpu", "cpu"])
