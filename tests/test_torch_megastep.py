"""The port's megastep (``ops/megastep.py``, the runners'
``decode_megastep`` / ``ragged_megastep``, ``engine/graphs.py``) against
the JAX package's.

- Runners on the same fp32 weights (JAX ``init_params`` carried across by
  ``params_from_numpy``), ``tiny-test`` at context 128, both layouts, K in
  {1, 4, 8}: ``decode_megastep`` tokens equal JAX's ``decode_megastep``
  and the port's own ``decode_steps`` bit for bit, with every flag false,
  and the next flight of 4 from the returned state equals JAX's too.
- Budgets [3, 2]: the flags fire once each, at steps 2 and 1; the rows
  after the whole-batch exit are zero; ``seq_lens``, ``tokens`` and
  ``recent`` end as JAX's exited loop leaves them.  An EOS id fires on
  the exact step.
- ``ragged_megastep`` against JAX's (context 512, chunks of 32 beside two
  decoding slots): tokens, flags, ``done_tokens`` and the chunk slot's KV
  (within 1e-5, fp32), the last chunk row's logits within 1e-5.
- The int8 pools against JAX's ``kv_dtype="int8"`` runner, and tp=2 on a
  CPU mesh (two ranks on the CPU) against JAX's one-device runner.
- Engine streams: ``TorchEngine(megastep_k=4)`` against
  ``JaxEngine(megastep_k=4)`` on the permutation checkpoint, greedy,
  seeded, and a mixed batch whose long prompt prefills through
  ``ragged_mega`` flights, token-identical.
- Addresses: ``insert``, ``release``, ``pre_decode_check`` and a ragged
  admission keep every state tensor's ``data_ptr``; the graph path run on
  the CPU through a stand-in capture (``fake_capture``: it runs the body
  where a CUDA graph would record it) equals the eager harness, keeps the
  warm-up's capture across ``init_state`` (which zeroes the captured
  state in place), and captures anew for state tensors at other
  addresses, never replaying against them.
- The plan refuses megastep with tp ranks on distinct devices.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.paged import (  # noqa: E402
    PagedModelRunner as JaxPagedModelRunner,
)
from crowdllama_tpu.engine.runner import ModelRunner as JaxModelRunner  # noqa: E402
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.engine.graphs import (  # noqa: E402
    GraphCache,
    MegastepGraph,
    state_tensors,
)
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402

KEY = jax.random.PRNGKey(0)
MAX_SEQ = 128
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8])


def fake_capture(fn):
    """A stand-in for ``graphs.cuda_capture`` on the CPU: "capture" runs
    ``fn`` once (the static budgets are 0 then, so every step is masked
    and the state does not move) and "replay" runs it again, copying its
    results into the first call's outputs, as a graph writes its static
    outputs."""
    outs = fn()

    def replay():
        for o, r in zip(outs, fn()):
            o.copy_(r)

    return replay, outs, 0


@pytest.fixture(scope="module")
def flat128():
    cfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    return _flatten_params(JT.init_params(cfg, KEY, dtype=jnp.float32))


def _jparams(flat):
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _runners(flat, layout, max_seq=MAX_SEQ, max_slots=2, **kw):
    """(JAX runner, port runner, port control runner) on ``flat``."""
    jcfg = j_get_config("tiny-test", max_context_length=max_seq)
    cfg = get_config("tiny-test", max_context_length=max_seq)
    common = dict(max_slots=max_slots, max_seq=max_seq, **kw)
    if layout == "paged":
        common.setdefault("page_size", 32)
        j = JaxPagedModelRunner(jcfg, params=_jparams(flat),
                                dtype=jnp.float32, mesh_spec="1", **common)
        mk = lambda **x: PagedModelRunner(  # noqa: E731
            cfg, params=params_from_numpy(flat), **common, **x)
    else:
        j = JaxModelRunner(jcfg, params=_jparams(flat), dtype=jnp.float32,
                           mesh_spec="1", **common)
        mk = lambda **x: ModelRunner(  # noqa: E731
            cfg, params=params_from_numpy(flat), **common, **x)
    return j, mk(device="cpu"), mk(device="cpu")


@pytest.fixture(scope="module", params=["paged", "contiguous"])
def trio(request, flat128):
    return (request.param, *_runners(flat128, request.param))


def _insert_both(j, t, prompts=PROMPTS, temperature=0.0):
    """Prefill and insert ``prompts`` into fresh states of the JAX runner
    and the port runner(s) ``t``; returns (JAX state, port states)."""
    jst = j.init_state()
    tsts = [r.init_state() for r in t]
    for slot, p in enumerate(prompts):
        jf, jks, jvs, plen = j.prefill(p, 0.0, 1.0, KEY)
        jst = j.insert(jst, slot, jks, jvs, plen, jf, temperature, 1.0,
                       prompt_tokens=p)
        for r, st in zip(t, tsts):
            f, ks, vs, _ = r.prefill(p, 0.0, 1.0, None)
            assert f == jf
            r.insert(st, slot, ks, vs, plen, f, temperature, 1.0,
                     prompt_tokens=p)
    return jst, tsts


@pytest.mark.parametrize("k", [1, 4, 8])
def test_decode_megastep_matches_jax_and_decode_steps(trio, k):
    _, j, t, ctrl = trio
    jst, (tst, cst) = _insert_both(j, (t, ctrl))
    jtoks, jdone, jst = j.decode_megastep(jst, k)
    ttoks, tdone, tst = t.decode_megastep(tst, k)
    ctoks, cst = ctrl.decode_steps(cst, k)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(ttoks.numpy(), ctoks)
    assert ttoks.dtype == torch.int32 and tdone.dtype == torch.bool
    assert not tdone.any() and not np.asarray(jdone).any()
    jtoks, _, _ = j.decode_megastep(jst, 4)
    ttoks, _, _ = t.decode_megastep(tst, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_budgets_fire_once_and_the_exited_rows_are_zero(trio):
    _, j, t, _ = trio
    jst, (tst,) = _insert_both(j, (t,), [p[:5] for p in PROMPTS])
    budgets = np.array([3, 2], np.int32)
    jtoks, jdone, jst = j.decode_megastep(jst, 8, budgets=budgets)
    ttoks, tdone, tst = t.decode_megastep(tst, 8, budgets=budgets)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    fired = [tuple(np.nonzero(tdone.numpy()[:, s])[0]) for s in range(2)]
    assert fired == [(2,), (1,)]
    assert not ttoks[3:].any() and ttoks[:3].all()
    for name in ("seq_lens", "tokens", "recent", "active"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), name)


def test_eos_fires_on_the_exact_step(trio):
    _, j, t, ctrl = trio
    _, (cst,) = _insert_both(j, (ctrl,), PROMPTS[:1])
    ref, _ = ctrl.decode_steps(cst, 8)
    eos = np.array([int(ref[3, 0]), -1], np.int32)
    first = int(np.nonzero(ref[:, 0] == eos[0])[0][0])
    jst, (tst,) = _insert_both(j, (t,), PROMPTS[:1])
    jtoks, jdone, _ = j.decode_megastep(jst, 8, eos_ids=eos)
    ttoks, tdone, _ = t.decode_megastep(tst, 8, eos_ids=eos)
    assert np.nonzero(tdone.numpy()[:, 0])[0].tolist() == [first]
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(ttoks.numpy()[:first + 1, 0],
                                  ref[:first + 1, 0])


def _slot_kv(pool, pages, n):
    """A slot's first ``n`` positions of one pool [L, P, Hkv, page, Dh]
    through its page list: [L, Hkv, n, Dh] fp32."""
    x = np.asarray(pool, np.float32)[:, list(pages)]
    l, np_, hkv, pg, dh = x.shape
    return x.transpose(0, 2, 1, 3, 4).reshape(l, hkv, np_ * pg, dh)[:, :, :n]


@pytest.fixture(scope="module")
def ragged_pair():
    cfg = j_get_config("tiny-test", max_context_length=512)
    flat = _flatten_params(JT.init_params(cfg, KEY, dtype=jnp.float32))
    j, t, _ = _runners(flat, "paged", max_seq=512, max_slots=4,
                       step_token_budget=36, prefix_cache=False)
    return j, t


@pytest.mark.parametrize("k", [1, 4, 8])
def test_ragged_megastep_matches_jax(ragged_pair, k):
    j, t = ragged_pair
    assert j.ragged_chunk == t.ragged_chunk == 32
    vocab = t.cfg.vocab_size
    prompt = [int(x) % vocab for x in range(17, 17 + 300)]
    jst, (tst,) = _insert_both(j, (t,))
    jjob = j.ragged_begin(prompt, 2, state=jst)
    tjob = t.ragged_begin(prompt, 2, state=tst)
    budgets = np.array([3, 9, 0, 0], np.int32)
    jtoks, jdone, jst = j.ragged_megastep(jst, jjob, k, budgets=budgets)
    ttoks, tdone, tst = t.ragged_megastep(tst, tjob, k, budgets=budgets)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert tjob.done_tokens == jjob.done_tokens == k * 32
    np.testing.assert_allclose(tjob.last_logits.numpy(),
                               np.asarray(jjob.last_logits), atol=1e-5,
                               rtol=0)
    n = tjob.done_tokens
    for tp, jp in ((tst.pool_k[0], jst.pool_k), (tst.pool_v[0], jst.pool_v)):
        np.testing.assert_allclose(
            _slot_kv(tp.numpy(), t._slot_pages[2], n),
            _slot_kv(jp, j._slot_pages[2], n), atol=1e-5, rtol=0)
    # Both finish the prompt and decode on identically.
    while not tjob.finished:
        _, _, tst = t.ragged_megastep(tst, tjob, 8)
        _, _, jst = j.ragged_megastep(jst, jjob, 8)
    tf, tst = t.ragged_finish(tst, tjob, 0.0, 1.0, None)
    jf, jst = j.ragged_finish(jst, jjob, 0.0, 1.0, KEY)
    assert tf == jf
    ttoks, _, _ = t.decode_megastep(tst, 4)
    jtoks, _, _ = j.decode_megastep(jst, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    t.ragged_abort(tjob)


def test_int8_pools_match_jax(flat128):
    j, t, ctrl = _runners(flat128, "paged", kv_dtype="int8")
    jst, (tst, cst) = _insert_both(j, (t, ctrl))
    jtoks, jdone, jst = j.decode_megastep(jst, 8, budgets=[6, 8])
    ttoks, tdone, tst = t.decode_megastep(tst, 8, budgets=[6, 8])
    ctoks, cst = ctrl.decode_steps(cst, 8)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(ttoks.numpy(), ctoks)
    assert tst.pool_k[0].dtype == torch.int8
    for a, b in ((tst.pool_k[0], cst.pool_k[0]),
                 (tst.k_scale[0], cst.k_scale[0])):
        assert torch.equal(a, b)


def test_tp2_on_a_cpu_mesh_matches_jax(flat128):
    j, t, _ = _runners(flat128, "paged")
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    two = PagedModelRunner(cfg, params=params_from_numpy(flat128),
                           mesh_shape="2", devices=["cpu", "cpu"],
                           max_slots=2, max_seq=MAX_SEQ, page_size=32)
    assert two.tp == 2
    jst, (tst,) = _insert_both(j, (two,))
    for k, budgets in ((8, None), (4, [2, 3])):
        jtoks, jdone, jst = j.decode_megastep(jst, k, budgets=budgets)
        ttoks, tdone, tst = two.decode_megastep(tst, k, budgets=budgets)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


# -------------------------------------------------------- graph addresses

def _ptrs(st):
    return [x.data_ptr() for x in state_tensors(st)]


def test_state_updates_keep_their_addresses(flat128):
    t = PagedModelRunner(get_config("tiny-test", max_context_length=512),
                         params=params_from_numpy(flat128), max_slots=3,
                         max_seq=512, page_size=32, step_token_budget=36,
                         device="cpu")
    st = t.init_state()
    before = _ptrs(st)
    f, ks, vs, plen = t.prefill(PROMPTS[0], 0.0, 1.0, None, state=st)
    t.insert(st, 0, ks, vs, plen, f, 0.7, 1.0, prompt_tokens=PROMPTS[0])
    t.pre_decode_check(8)
    job = t.ragged_begin(list(range(5, 105)), 1, state=st)
    while not job.finished:
        t.ragged_step(st, job, 1)
    t.ragged_finish(st, job, 0.0, 1.0, None)
    t.decode_megastep(st, 4)
    t.release(st, 1)
    t.release(st, 0)
    assert _ptrs(st) == before


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_graph_path_on_the_cpu_equals_the_eager_harness(flat128, layout):
    """The graph path through ``fake_capture``: greedy and sampled flights
    equal the eager harness; the captures survive ``init_state`` (the
    captured state zeroed in place); a state at other addresses is
    captured anew and the old graph refuses it."""
    _, g, e = _runners(flat128, layout)
    g._graphs = cache = GraphCache(capture=fake_capture)
    for r in (g, e):
        r.max_seq = MAX_SEQ
    sts = []
    for r in (g, e):
        st = r.init_state()
        for slot, (p, temp) in enumerate(zip(PROMPTS, (0.0, 0.9))):
            f, ks, vs, plen = r.prefill(p, 0.0, 1.0, None)
            r.insert(st, slot, ks, vs, plen, f, temp, 1.0, prompt_tokens=p,
                     slot_key=np.array([slot, 7], np.uint32))
        sts.append(st)
    gst, est = sts
    for k, budgets in ((4, None), (8, [5, 3]), (4, None)):
        gt, gd, _ = g.decode_megastep(gst, k, budgets=budgets)
        et, ed, _ = e.decode_megastep(est, k, budgets=budgets)
        assert torch.equal(gt, et) and torch.equal(gd, ed)
    assert cache.captures == 2  # K = 4 and K = 8, both sampled
    assert all(x.replays >= 1 for x in cache._graphs.values())
    # init_state keeps the captured tensors (zeroed), so no new capture.
    fresh = g.init_state()
    assert fresh is gst and not fresh.active.any()
    assert not any(bool(x.any()) for x in state_tensors(fresh)
                   if x.dtype != torch.bool and x is not fresh.recent
                   and x is not fresh.top_p
                   and x is not fresh.repeat_penalty)
    f, ks, vs, plen = g.prefill(PROMPTS[0], 0.0, 1.0, None)
    g.insert(fresh, 0, ks, vs, plen, f, 0.0, 1.0, prompt_tokens=PROMPTS[0])
    g.decode_megastep(fresh, 4)
    assert cache.captures == 3  # the greedy graph; the sampled one kept
    # A state at other addresses: captured anew, never replayed stale.
    (old,) = [x for key, x in cache._graphs.items() if key[-1] is False]
    moved = dataclasses.replace(fresh, seq_lens=fresh.seq_lens.clone())
    with pytest.raises(RuntimeError, match="other than the captured"):
        old.replay(moved, budgets=torch.zeros(2, dtype=torch.int32))
    g.decode_megastep(moved, 4)
    assert cache.captures == 4 and cache.state is moved
    assert all(x.state is moved for x in cache._graphs.values())


def test_graph_counts_launches_per_replay(monkeypatch, flat128):
    """A capture puts the wrappers' counts back and every replay adds
    what the capture counted."""
    from crowdllama_tpu_torch.ops.cuda.paged import (
        flash_paged_decode_attention as B,
    )

    _, t, _ = _runners(flat128, "paged")
    st = t.init_state()

    def counting_capture(fn):
        replay, outs, pool = fake_capture(fn)
        B.launches += 7  # what a capture of 7 launches records
        return replay, outs, pool

    def body(inputs):
        return (torch.zeros(2, 2, dtype=torch.int32),
                torch.zeros(2, 2, dtype=torch.bool))

    monkeypatch.setattr(B, "launches", 0)
    graph = MegastepGraph(body, st, {"budgets": torch.zeros(2)},
                          capture=counting_capture)
    assert B.launches == 0
    graph.replay(st)
    graph.replay(st)
    assert B.launches == 14


def test_plan_refuses_megastep_on_distinct_devices():
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.plan import (
        check_megastep,
        resolve_serving_plan,
    )

    with pytest.raises(ValueError, match="Queue 1 item 8"):
        resolve_serving_plan(Configuration(mesh_shape="2", megastep_k=4))
    with pytest.raises(ValueError, match="Queue 1 item 8"):
        check_megastep(4, ["cuda:0", "cuda:1"])
    check_megastep(4, ["cuda:0", "cuda:0"])
    check_megastep(0, ["cuda:0", "cuda:1"])
    assert resolve_serving_plan(Configuration(mesh_shape="2", megastep_k=4),
                                devices=["cpu", "cpu"]).mesh_shape == "2"


# ---------------------------------------------------------- engine streams

class _Recorder:
    """Tokenizer proxy: each stream decoder appends its ids to a list
    chosen by the task (``ids_var``)."""

    def __init__(self, tok, sink):
        self._tok, self._sink = tok, sink

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), self._sink()

        class _Dec:
            def feed(self, token_id):
                ids.append(int(token_id))
                return dec.feed(token_id)

        return _Dec()


async def _traffic(engine):
    """Greedy and seeded prompts one at a time, then a mixed batch: a
    short greedy stream and, once it decodes, a long prompt that
    prefills in chunks."""
    import contextvars

    var = contextvars.ContextVar("ids")
    engine.tokenizer = _Recorder(engine.tokenizer, lambda: var.get())
    out = {}

    async def run(name, prompt, kw, n=12):
        ids: list[int] = []
        var.set(ids)
        async for _ in engine.generate(prompt, max_tokens=n, **kw):
            pass
        out[name] = ids

    await run("greedy", "the quick brown fox", {})
    await run("seeded", "seeded", dict(temperature=0.8, seed=1234))
    await run("top", "top-k and top-p", dict(temperature=1.1, seed=2**40 + 3,
                                             top_k=20, top_p=0.9))
    short = asyncio.ensure_future(run("short", "decoding beside it", {},
                                      n=40))
    while not engine.scheduler.tokens_generated:
        await asyncio.sleep(0.001)
    await run("long", "a long prompt that is prefilled in chunks " * 3,
              dict(temperature=0.7, seed=99))
    await short
    return out


async def test_engine_streams_token_identical_to_jax_engine(tmp_path):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=256)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=256)))
    common = dict(max_context_length=256, kv_page_size=16,
                  step_token_budget=36, max_batch_slots=4, megastep_k=4,
                  decode_chunk=4)
    jeng = JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False, intervals=Intervals.default(),
                                   **common))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False,
        **common)
    await jeng.start()
    try:
        want = await _traffic(jeng)
    finally:
        await jeng.stop()
    await teng.start()
    try:
        got = await _traffic(teng)
        g = teng.obs_gauges()
    finally:
        await teng.stop()
    assert got == want
    assert len(got["long"]) == 12 and len(got["short"]) == 40
    assert g["duty_cycle|dispatch=megastep"] > 0
    assert g["duty_cycle|dispatch=ragged_mega"] > 0
