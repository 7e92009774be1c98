"""The port's model, paged runner and engine against the JAX package.

- The model: prefill logits/KV and one ``decode_layer_body`` on the same
  fp32 weights (JAX ``init_params`` + ``_flatten_params``, carried across
  by ``params_from_numpy``), for every dense ``tiny-test*`` family, within
  1e-4.
- The runner: teacher-forced logits of the port's paged runner (monolithic,
  prefix-hit and ragged admissions, then decode steps over the paged pool)
  against JAX ``T.prefill`` + ``T.decode_step`` on random fp32 weights,
  within 1e-4.  Random weights keep attention in play (the permutation
  checkpoint below zeroes it out).
- The engine: greedy streams token-identical to ``JaxEngine`` on the
  permutation checkpoint (``testing/modelgen.py``) for a short prompt, a
  prefix-cache hit and a prompt longer than the ragged chunk (page 16 and a
  small step token budget make the ragged path run at this size); seeded
  sampled streams token-identical to ``JaxEngine`` on both KV layouts
  (threefry keys, ``engine/prng.py``).
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402

ATOL = 1e-4
# Weights that init to exact ones/zeros (norms, biases) get a numpy
# perturbation so the switches they drive are actually compared.
_PERTURB = ("ln1", "ln2", "final_norm", "post_ln1", "post_ln2", "bq", "bk",
            "bv", "q_norm", "k_norm")


def _flat_params(model: str, max_ctx: int = 256, seed: int = 0):
    cfg = j_get_config(model, max_context_length=max_ctx)
    flat = _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))
    r = np.random.default_rng(seed)
    for name, arr in flat.items():
        if name.split("/")[-1] in _PERTURB:
            flat[name] = (arr + 0.1 * r.standard_normal(arr.shape)).astype(
                np.float32)
    return flat


def _jax_params(flat):
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


DENSE = ["tiny-test", "tiny-test-gemma", "tiny-test-qwen2", "tiny-test-qwen3",
         "tiny-test-mistral"]


@pytest.mark.parametrize("model", DENSE)
def test_prefill_logits_and_kv_match_jax(model):
    flat = _flat_params(model)
    jcfg = j_get_config(model, max_context_length=256)
    cfg = get_config(model, max_context_length=256)
    r = np.random.default_rng(1)
    b, t, plen = 2, 40, 37
    tokens = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.minimum(np.arange(t), plen - 1)[None].repeat(b, 0).astype(
        np.int32)
    valid = (np.arange(t) < plen)[None].repeat(b, 0)
    jl, jk, jv = JT.prefill(_jax_params(flat), jcfg, jnp.asarray(tokens),
                            jnp.asarray(pos), kv_valid=jnp.asarray(valid))
    tl, (tk,), (tv,) = T.prefill([params_from_numpy(flat)], cfg,
                                 torch.from_numpy(tokens).long(),
                                 torch.from_numpy(pos),
                                 kv_valid=torch.from_numpy(valid))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("model", DENSE)
def test_decode_layer_body_matches_jax(model):
    """Norms, projections, rope, residuals and MLP around a stand-in
    attention (q plus each query head's kv head of v)."""
    flat = _flat_params(model)
    jcfg = j_get_config(model, max_context_length=256)
    cfg = get_config(model, max_context_length=256)
    g = cfg.num_heads // cfg.num_kv_heads
    r = np.random.default_rng(2)
    x = r.standard_normal((3, cfg.hidden_size)).astype(np.float32)
    pos = np.array([0, 17, 200], np.int32)
    from crowdllama_tpu.ops.rope import rope_table as j_rope_table

    jcos, jsin = j_rope_table(256, cfg.resolved_head_dim(), cfg.rope_theta)
    jlp = jax.tree_util.tree_map(lambda a: a[1],
                                 _jax_params(flat)["layers"])
    want = JT.decode_layer_body(
        jlp, jcfg, jnp.asarray(x), jnp.asarray(pos), jcos, jsin,
        lambda q, k, v: q + jnp.repeat(v, g, axis=1))
    tlp = T.layer_params([params_from_numpy(flat)["layers"]], 1)
    got = T.decode_layer_body(
        tlp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
        [(torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin)))],
        lambda qs, ks, vs: [qs[0] + vs[0].repeat_interleave(g, dim=1)])
    _close(got, want)


_j_decode_step = jax.jit(JT.decode_step, static_argnums=(1,))


def _jax_logits(jparams, jcfg, ids, n_prompt, max_seq):
    """Logits after consuming ids[:n_prompt + i], for each i: T.prefill of
    the prompt, then T.decode_step per later token over a contiguous
    cache."""
    logits, ks, vs = JT.prefill(jparams, jcfg, jnp.asarray(ids[:n_prompt])[None],
                                jnp.arange(n_prompt)[None])
    out = [np.asarray(logits[0, -1])]
    shape = (ks.shape[0], 1, ks.shape[2], max_seq, ks.shape[4])
    kc = jnp.zeros(shape, jnp.float32).at[:, :, :, :n_prompt].set(ks)
    vc = jnp.zeros(shape, jnp.float32).at[:, :, :, :n_prompt].set(vs)
    for p in range(n_prompt, len(ids)):
        lg, kc, vc = _j_decode_step(jparams, jcfg, jnp.asarray([ids[p]]),
                                    jnp.asarray([p]), kc, vc,
                                    jnp.asarray([p + 1]))
        out.append(np.asarray(lg[0]))
    return np.stack(out)


def test_paged_runner_teacher_forced_logits_match_jax():
    """Slot 0 admitted by monolithic prefill, slot 2 by a prefix-cache hit
    on slot 0's first page, slot 1 by the unified ragged step (chunks of 32
    while slots 0 and 2 decode); then teacher-forced decode steps over the
    paged pool.  Every logits row matches the JAX reference sequence."""
    model, max_seq = "tiny-test", 256
    flat = _flat_params(model, max_seq, seed=3)
    jcfg = j_get_config(model, max_context_length=max_seq)
    cfg = get_config(model, max_context_length=max_seq)
    jparams = _jax_params(flat)
    r = np.random.default_rng(4)
    p0 = [int(t) for t in r.integers(0, 500, 21)]
    p2 = p0[:18] + [int(t) for t in r.integers(0, 500, 9)]
    p1 = [int(t) for t in r.integers(0, 500, 75)]
    run = PagedModelRunner(cfg, params=params_from_numpy(flat), max_slots=3,
                           max_seq=max_seq, page_size=16,
                           step_token_budget=35, device="cpu")
    assert run.ragged_chunk == 32
    hist: dict[int, list[int]] = {}
    with torch.inference_mode():
        st = run.init_state()
        for slot, p in ((0, p0), (2, p2)):
            first, ks, vs, plen = run.prefill(p, 0.0, 1.0, None, state=st)
            st = run.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                            prompt_tokens=p)
            hist[slot] = list(p) + [first]
        assert run.prefix_hits == 1
        job = run.ragged_begin(p1, 1, st)
        while not job.finished:
            toks, st = run.ragged_step(st, job, 1)
            for slot in (0, 2):
                hist[slot].append(int(toks[0, slot]))
        ref1 = _jax_logits(jparams, jcfg, p1, len(p1), max_seq)
        _close(job.last_logits[None], ref1[:1])
        first, st = run.ragged_finish(st, job, 0.0, 1.0, None)
        hist[1] = list(p1) + [first]
        forced = {s: [int(t) for t in r.integers(0, 500, 4)]
                  for s in range(3)}
        got = {s: [] for s in range(3)}
        for i in range(5):
            run.pre_decode_check(1)
            logits = run.decode_logits(st, run._table())
            for s in range(3):
                got[s].append(logits[s].numpy().copy())
            if i == 4:
                break
            for s in range(3):
                st.tokens[s] = forced[s][i]
                st.seq_lens[s] += 1
                run._host_seq[s] += 1
    prompts = {0: p0, 1: p1, 2: p2}
    for s in range(3):
        ids = hist[s] + forced[s]
        # The pending token sits at position len(hist) - 1: its logits are
        # the reference's after consuming len(hist) tokens.
        ref = _jax_logits(jparams, jcfg, ids, len(prompts[s]), max_seq)
        start = len(hist[s]) - len(prompts[s])
        _close(np.stack(got[s]), ref[start:start + 5])
        # Greedy tokens the runner emitted along the way are the argmax.
        emitted = hist[s][len(prompts[s]):]
        np.testing.assert_array_equal(
            ref[:len(emitted)].argmax(-1), emitted)


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
    return out


async def test_greedy_streams_token_identical_to_jax_engine(tmp_path):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=256)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=256)))
    prompts = ["the quick brown fox jumps over",   # 31 tokens: page 0 indexed
               "the quick brown fox leaps high",   # prefix hit on page 0
               "a long prompt rides the ragged chunks while others wait " * 2]
    common = dict(max_context_length=256, kv_page_size=16,
                  step_token_budget=36, max_batch_slots=4)
    jeng = JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False, intervals=Intervals.default(),
                                   **common))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", **common)
    await jeng.start()
    try:
        want = await _streams(jeng, prompts)
        jhits = jeng.scheduler.runner.prefix_hits
    finally:
        await jeng.stop()
    await teng.start()
    try:
        got = await _streams(teng, prompts)
        assert teng.runner.prefix_hits == jhits >= 1
        assert teng.scheduler.ragged_chunks >= 2
    finally:
        await teng.stop()
    assert got == want
    assert len(prompts[2]) + 1 > teng.runner.ragged_chunk


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
async def test_engine_sampled_seed_reproduces(tmp_path, layout):
    """Seeded sampled streams (temperature > 0, seed set) are token-
    identical between the port and ``JaxEngine`` on the same weights: a
    short prompt, and a long one admitted chunk by chunk (ragged on the
    paged layout, legacy chunks on the contiguous one) with top-k/top-p.
    A seeded stream also repeats when sent again."""
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=256)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=256)))
    reqs = [("seeded", dict(temperature=0.8, seed=1234)),
            ("a long seeded prompt that is admitted in chunks " * 2,
             dict(temperature=1.1, seed=2**40 + 3, top_k=20, top_p=0.9)),
            ("seeded", dict(temperature=0.8, seed=1234))]
    common = dict(max_context_length=256, kv_page_size=16,
                  step_token_budget=36, max_batch_slots=4, kv_layout=layout)

    async def run(engine):
        rec = _Recorder(engine.tokenizer)
        engine.tokenizer = rec
        outs = []
        for prompt, kw in reqs:
            rec.ids.clear()
            async for _c in engine.generate(prompt, max_tokens=12, **kw):
                pass
            outs.append(list(rec.ids))
        return outs

    jeng = JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False, intervals=Intervals.default(),
                                   **common))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False,
        **common)
    await jeng.start()
    try:
        jeng.scheduler.runner.prefill_chunk = 32
        want = await run(jeng)
    finally:
        await jeng.stop()
    await teng.start()
    try:
        teng.runner.prefill_chunk = 32
        got = await run(teng)
        chunks = teng.scheduler.ragged_chunks + teng.scheduler.prefill_chunks
        assert chunks >= 2
    finally:
        await teng.stop()
    assert got == want
    assert got[0] == got[2] and len(got[0]) == 12
    assert len(set(got[0])) > 2  # really sampled, not one repeated argmax


# ------------------------------------------------------ scheduler behaviour

def _tiny_engine(**kw):
    base = dict(model="tiny-test", max_context_length=256, kv_page_size=16,
                max_batch_slots=2, warmup=False)
    base.update(kw)
    return TorchEngine(device="cpu", dtype=torch.float32, **base)


def _pages_accounted(runner) -> bool:
    """Every page is free or prefix-cached once no slot holds any."""
    cached = set(runner._page_key)
    return (not runner._slot_pages and
            len(set(runner._free_pages) | cached) == runner.total_pages)


@pytest.mark.parametrize("stop,chunks,want", [
    (["END"], ["abc", "dE", "ND tail"], ("abcd", True)),
    (["xyz"], ["ab", "cd"], ("abcd", False)),
    ([], ["ab", "cd"], ("abcd", False)),
])
def test_stop_matcher_holds_back_and_cuts(stop, chunks, want):
    from crowdllama_tpu_torch.engine.engine import StopMatcher

    m = StopMatcher(stop)
    out, stopped = "", False
    for c in chunks:
        emit, stopped = m.feed(c)
        out += emit
        if stopped:
            break
    if not stopped:
        out += m.flush()
    assert (out, stopped) == want


async def test_overload_and_too_long_prompts_are_rejected():
    from crowdllama_tpu_torch.engine.scheduler import (
        GenRequest,
        OverloadedError,
        Scheduler,
    )

    eng = _tiny_engine()
    await eng.start()
    try:
        # A scheduler whose loop is not running keeps requests pending.
        sched = Scheduler(eng.runner, admission_pending_max=1)
        await sched.submit(GenRequest(prompt_ids=[1, 2, 3]))
        with pytest.raises(OverloadedError, match="^overloaded"):
            await sched.submit(GenRequest(prompt_ids=[1, 2, 3]))
        with pytest.raises(ValueError, match="exceeds max context"):
            await eng.scheduler.submit(GenRequest(prompt_ids=[1] * 256))
    finally:
        await eng.stop()


async def test_cancel_mid_stream_frees_slot_and_pages():
    from crowdllama_tpu_torch.engine.scheduler import DONE, GenRequest

    eng = _tiny_engine()
    await eng.start()
    try:
        req = GenRequest(prompt_ids=list(range(1, 40)), max_tokens=200)
        await eng.scheduler.submit(req)
        for _ in range(3):
            tok, _reason = await asyncio.wait_for(req.out.get(), 30)
            assert tok is not DONE
        eng.scheduler.cancel(req)
        for _ in range(500):
            if all(s is None for s in eng.scheduler.slots):
                break
            await asyncio.sleep(0.01)
        assert all(s is None for s in eng.scheduler.slots)
        await asyncio.sleep(0.05)  # let an in-flight chunk retire
        assert _pages_accounted(eng.runner)
    finally:
        await eng.stop()


async def test_pool_exhaustion_finishes_the_starved_slot_not_the_engine():
    """Two long requests racing for an overcommitted 16-page pool: each
    ends "stop" or "length", none errors, every page comes back, and the
    engine keeps serving."""
    eng = _tiny_engine(kv_pool_tokens=256)
    await eng.start()
    assert eng.runner.total_pages == 16
    try:
        async def run(n):
            final = None
            async for c in eng.generate("grow " * 4, max_tokens=n):
                final = c
            return final.done_reason

        r1, r2 = await asyncio.gather(run(200), run(200))
        assert {r1, r2} <= {"stop", "length"}
        assert _pages_accounted(eng.runner)
        assert await run(4) in ("stop", "length")
    finally:
        await eng.stop()
