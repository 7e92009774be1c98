"""The port's speculative decoding (``engine/spec.py``, the scheduler's
speculation plane, the plan) against the JAX package.

- ``propose_ngram_drafts``: drafts and ``from_prompt`` equal to JAX's on
  histories with a match inside the prompt, in the generated tail, none,
  and ``seq_lens`` at and past ``max_seq - 1``.
- ``verify_accept_emit`` (and ``update_hist``): counts, emits, pending
  tokens, the history and the key carries equal to JAX's
  ``_verify_accept_emit``, greedy and sampled slots (the sampled column
  draws from the same threefry sub-keys).
- Each runner (paged bf16, paged int8, contiguous, draft) against the JAX
  runner of its class: the packed ``[K, 2+J, B]`` blocks equal for K = 2
  and k in {1, 4} on the permutation weights (exact: O(1) margins) and on
  random fp32 weights, where the verify logits agree within ``TOL`` of
  JAX's (the JAX runner's verify forward over its own pools); the hosted
  verify with -1 sentinels equal to JAX's.
- The adaptive controller: the same k trajectory and probe arming for
  the same retired flights.
- ``TorchEngine`` against ``JaxEngine`` with speculation on: streams
  equal to each other and to plain greedy, with fixed and adaptive k
  (through the pause), the draft runner on a JAX-written native
  checkpoint; the ``spec_decode`` stats keys equal; tp=2 equal to tp=1.
- ``resolve_serving_plan`` on the spec axis: JAX's runner, or a refusal,
  in every cell.
"""

import asyncio
import contextvars
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine import spec as jspec  # noqa: E402
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.engine import prng  # noqa: E402
from crowdllama_tpu_torch.engine import spec  # noqa: E402
from crowdllama_tpu_torch.engine.sampling import split_slot_keys  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402

#: fp32 verify logits, port vs JAX (absolute, logits of order 1)
TOL = 1e-4
#: the same over int8 pools: the two packages' int8 KV may differ by one
#: LSB where fp32 rounding ties (``test_torch_int8.py`` holds the pools)
TOL_INT8 = 2e-3
MAX_SEQ = 256
PAGE = 16


def _jparams(flat):
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _perm_flat():
    from crowdllama_tpu.testing.modelgen import permutation_params

    return _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=MAX_SEQ)))


def _random_flat(seed=0, layers=None):
    cut = {} if layers is None else {"num_layers": layers}
    cfg = j_get_config("tiny-test", max_context_length=MAX_SEQ, **cut)
    return _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))


# ------------------------------------------------------------------ drafts

def _hist_case():
    rng = np.random.default_rng(3)
    b, s = 5, 40
    hist = rng.integers(0, 6, (b, s)).astype(np.int32)
    seq = np.array([12, 30, 0, 39, 45], np.int32)
    plens = np.array([6, 10, 0, 20, 25], np.int32)
    hist[2] = np.arange(s)  # no repeated bigram: no match
    # Slot 0: the pending bigram (7, 8) occurs once, inside the prompt.
    hist[0, :13] = [7, 8, 1, 2, 3, 4, 5, 1, 2, 3, 4, 7, 8]
    return hist, seq, plens


@pytest.mark.parametrize("k", [1, 3, 5])
def test_propose_ngram_drafts_matches_jax(k):
    hist, seq, plens = _hist_case()
    want_d, want_p = jspec.propose_ngram_drafts(
        jnp.asarray(hist), jnp.asarray(seq), k, hist.shape[1],
        jnp.asarray(plens))
    got_d, got_p = spec.propose_ngram_drafts(
        torch.from_numpy(hist), torch.from_numpy(seq), k, hist.shape[1],
        torch.from_numpy(plens))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    # The cases cover a prompt match, a generated match and no match.
    assert got_p.any() and not got_p.all()


def test_propose_ngram_drafts_prompt_echo_and_none():
    """A prompt that repeats a stretch drafts the stretch's continuation,
    attributed to the prompt; without prompt lengths nothing is."""
    row = np.zeros((32,), np.int32)
    row[:12] = [5, 6, 7, 8, 9, 10, 11, 12, 5, 6, 7, 8]
    row[12] = 9  # pending token
    hist = torch.from_numpy(row[None])
    seq = torch.tensor([12], dtype=torch.int32)
    d, p = spec.propose_ngram_drafts(hist, seq, 3, 32,
                                     torch.tensor([12], dtype=torch.int32))
    assert d.tolist() == [[10, 11, 12]] and p.tolist() == [True]
    _, p = spec.propose_ngram_drafts(hist, seq, 3, 32)
    assert p.tolist() == [False]


def _state_pair(b, j, seed, sampled):
    rng = np.random.default_rng(seed)
    v = 40
    logits = rng.standard_normal((b, j, v)).astype(np.float32)
    model_next = logits.argmax(-1)
    drafts = model_next[:, :-1].copy()
    drafts[1, 1:] = (drafts[1, 1:] + 1) % v   # accept 1
    drafts[2, 0] = (drafts[2, 0] + 1) % v     # accept 0
    seq = np.array([3, 10, 20, MAX_SEQ - 3, 0], np.int32)[:b]
    active = np.array([True, True, True, True, False])[:b]
    temp = np.zeros((b,), np.float32)
    if sampled:
        temp[0] = 0.8
    keys = np.stack([prng.fold_in(prng.PRNGKey(9), i) for i in range(b)])
    hist = rng.integers(0, v, (b, MAX_SEQ)).astype(np.int32)
    common = dict(seq_lens=seq, tokens=model_next[:, 0].astype(np.int32),
                  active=active, temperature=temp,
                  top_p=np.full((b,), 0.9, np.float32),
                  top_k=np.zeros((b,), np.int32), keys=keys, hist=hist)
    jst = types.SimpleNamespace(**{k: jnp.asarray(x)
                                   for k, x in common.items()})
    tst = types.SimpleNamespace(**{k: (x if k == "keys"
                                       else torch.from_numpy(x.copy()))
                                   for k, x in common.items()})
    return logits, drafts.astype(np.int32), jst, tst


@pytest.mark.parametrize("sampled", [False, True])
def test_verify_accept_emit_matches_jax(sampled):
    b, j = 5, 4
    logits, drafts, jst, tst = _state_pair(b, j, 11, sampled)
    counts, emit, pending, hist, carry = jspec._verify_accept_emit(
        jst, jnp.asarray(logits), jnp.asarray(drafts), j, MAX_SEQ)
    tcarry, sub = split_slot_keys(tst.keys)
    noise = (torch.from_numpy(prng.gumbel(sub, (40,))) if sampled
             else None)
    tc, te, tp, acc = spec.verify_accept_emit(
        tst, torch.from_numpy(logits), torch.from_numpy(drafts), MAX_SEQ,
        noise)
    spec.update_hist(tst.hist, tst.seq_lens, te, acc, MAX_SEQ)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(te.numpy(), np.asarray(emit))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pending))
    np.testing.assert_array_equal(tst.hist.numpy(), np.asarray(hist))
    np.testing.assert_array_equal(tcarry, np.asarray(carry))
    assert tc.tolist()[:4] == ([1, 2, 1, 3] if sampled else [4, 2, 1, 3])


# ----------------------------------------------------------------- runners

ECHO = [257] + list(range(40, 72)) + list(range(40, 44))
PROMPTS = [ECHO, [257] + list(range(100, 110)) + list(range(100, 103)),
           [int(t) for t in np.random.default_rng(5).integers(0, 250, 23)]]


def _runner_pair(kind, flat, k, draft_flat=None, max_slots=4):
    """(JAX runner, port runner) of ``kind`` on the same fp32 weights."""
    from crowdllama_tpu_torch.engine.spec import (
        DraftSpecPagedModelRunner,
        SpecModelRunner,
        SpecPagedModelRunner,
    )

    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    kw = dict(max_slots=max_slots, max_seq=MAX_SEQ, draft_len=k)
    jkw = dict(kw, params=_jparams(flat), dtype=jnp.float32, mesh_spec="1")
    tkw = dict(kw, params=params_from_numpy(flat), device="cpu",
               dtype=torch.float32)
    if kind == "contiguous":
        return (jspec.SpecModelRunner(jcfg, **jkw),
                SpecModelRunner(cfg, **tkw))
    pkw = dict(page_size=PAGE, kv_dtype="int8" if kind == "int8" else "bf16")
    if kind == "draft":
        dj = j_get_config("tiny-test", max_context_length=MAX_SEQ,
                          num_layers=1)
        dt = get_config("tiny-test", max_context_length=MAX_SEQ,
                        num_layers=1)
        return (jspec.DraftSpecPagedModelRunner(
                    jcfg, draft_cfg=dj, draft_params=_jparams(draft_flat),
                    **jkw, **pkw),
                DraftSpecPagedModelRunner(
                    cfg, draft_cfg=dt,
                    draft_params=params_from_numpy(draft_flat), **tkw, **pkw))
    return (jspec.SpecPagedModelRunner(jcfg, **jkw, **pkw),
            SpecPagedModelRunner(cfg, **tkw, **pkw))


def _fill(jrun, trun, prompts=PROMPTS, temps=None):
    jst, tst = jrun.init_state(), trun.init_state()
    for slot, p in enumerate(prompts):
        t = 0.0 if temps is None else temps[slot]
        key = prng.fold_in(prng.PRNGKey(4), slot)
        jtok, jks, jvs, plen = jrun.prefill(p, t, 1.0, jnp.asarray(key),
                                            state=jst)
        jst = jrun.insert(jst, slot, jks, jvs, plen, jtok, t, 1.0,
                          prompt_tokens=p, slot_key=jnp.asarray(key))
        ttok, tks, tvs, _ = trun.prefill(p, t, 1.0, key, state=tst)
        tst = trun.insert(tst, slot, tks, tvs, plen, ttok, t, 1.0,
                          prompt_tokens=p, slot_key=key)
        assert ttok == int(jtok)
    return jst, tst


def _draft_flat(kind, flat, perm):
    if kind != "draft":
        return None
    if perm:  # the permutation model cut to one layer agrees by design
        return {k: (v[:1] if k.startswith("layers/") else v)
                for k, v in flat.items()}
    return _random_flat(seed=1, layers=1)


@pytest.mark.parametrize("perm", [True, False], ids=["perm", "random"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["paged", "int8", "contiguous", "draft"])
def test_runner_packed_blocks_match_jax(kind, k, perm):
    """Two dispatches of K=2 verify steps: the packed blocks equal."""
    flat = _perm_flat() if perm else _random_flat()
    jrun, trun = _runner_pair(kind, flat, k, _draft_flat(kind, flat, perm))
    jst, tst = _fill(jrun, trun)
    for _ in range(2):
        jout, jst = jrun.decode_steps(jst, 2)
        tout, tst = trun.decode_steps(tst, 2)
        assert tout.shape == (2, 3 + k, 4)
        np.testing.assert_array_equal(tout, np.asarray(jout))
    if perm:
        # The permutation walk: the echo slot accepts whole windows.
        assert (tout[:, 0, 0] == k + 1).all()
        assert (tout[:, -1, 0] == (1 if kind != "draft" else 2)).all()
    if kind != "contiguous":
        np.testing.assert_array_equal(trun.page_table, jrun.page_table)
        np.testing.assert_array_equal(trun._host_seq, jrun._host_seq)


def _jax_verify_logits(jrun, jst, kind, drafts):
    """The JAX runner's verify forward over its own state (its spec.py
    body: the gathered page view or the contiguous cache as context)."""
    cfg = jrun.cfg
    j = 1 + drafts.shape[1]
    seq_tok = jnp.concatenate([jst.tokens[:, None], jnp.asarray(drafts)], 1)
    positions = jnp.minimum(jst.seq_lens[:, None] + jnp.arange(j),
                            jrun.max_seq - 1)
    if kind == "contiguous":
        ck, cv = jst.k_cache, jst.v_cache
        view = jrun.max_seq
    else:
        table = jnp.asarray(jrun.page_table)
        l, b = cfg.num_layers, jrun.max_slots
        hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
        view = jrun.max_pages_per_slot * jrun.page_size
        ck, cv = jst.pool_k[:, table], jst.pool_v[:, table]
        if kind == "int8":
            ck = ck.astype(jnp.float32) * jst.k_scale[:, table][
                ..., None].astype(jnp.float32)
            cv = cv.astype(jnp.float32) * jst.v_scale[:, table][
                ..., None].astype(jnp.float32)
        ck = ck.transpose(0, 1, 3, 2, 4, 5).reshape(l, b, hkv, view, dh)
        cv = cv.transpose(0, 1, 3, 2, 4, 5).reshape(l, b, hkv, view, dh)
    valid = jnp.arange(view)[None, :] < jst.seq_lens[:, None]
    logits, _, _ = JT.prefill(jrun.params, cfg, seq_tok, positions,
                              ctx_k=ck.astype(jnp.float32),
                              ctx_v=cv.astype(jnp.float32), ctx_valid=valid)
    return np.asarray(logits)


@pytest.mark.parametrize("kind", ["paged", "int8", "contiguous"])
def test_verify_logits_match_jax_on_random_weights(kind):
    """After a dispatch, the next verify forward's logits (every slot,
    every row) agree with the JAX runner's within TOL."""
    jrun, trun = _runner_pair(kind, _random_flat(), 3)
    jst, tst = _fill(jrun, trun)
    jout, jst = jrun.decode_steps(jst, 1)
    tout, tst = trun.decode_steps(tst, 1)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    drafts = np.array([[5, 6, 7]] * 4, np.int32)
    want = _jax_verify_logits(jrun, jst, kind, drafts)
    with torch.inference_mode():
        table = None if kind == "contiguous" else trun._table()
        got = trun.verify_forward(tst, table, torch.from_numpy(drafts))[0]
    np.testing.assert_allclose(got[:3].numpy(), want[:3], rtol=0,
                               atol=TOL_INT8 if kind == "int8" else TOL)


@pytest.mark.parametrize("kind", ["paged", "int8", "draft"])
def test_hosted_verify_with_sentinels_matches_jax(kind):
    """Remote drafts: a correct chunk, a wrong one, and -1 (no draft)."""
    flat = _perm_flat()
    jrun, trun = _runner_pair(kind, flat, 4, _draft_flat(kind, flat, True))
    jst, tst = _fill(jrun, trun)
    # The permutation's next tokens after each slot's pending token.
    from crowdllama_tpu_torch.testing.modelgen import permutation_next

    nxt = permutation_next(512)
    pend = tst.tokens.tolist()
    drafts = np.full((4, 3), -1, np.int32)
    drafts[0] = [nxt[pend[0]], nxt[nxt[pend[0]]], nxt[nxt[nxt[pend[0]]]]]
    drafts[1] = [nxt[pend[1]], 7, 7]
    for rnd in range(2):  # the second round's drafts are stale: rejected
        jout, jst = jrun.decode_steps_hosted(jst, drafts)
        tout, tst = trun.decode_steps_hosted(tst, drafts)
        np.testing.assert_array_equal(tout.cpu().numpy(), np.asarray(jout))
        assert tout[0, 0].tolist() == ([4, 2, 1, 0] if rnd == 0
                                       else [1, 1, 1, 0])
    np.testing.assert_array_equal(trun._host_seq, jrun._host_seq)
    with pytest.raises(ValueError, match="outside"):
        trun.decode_steps_hosted(tst, np.zeros((4, 5), np.int32))


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_paused_runner_dispatches_the_plain_program(kind):
    """k = 0: the plain 2-D tokens, equal to JAX's paused runner's; then a
    resume at k = 2 stays equal."""
    flat = _perm_flat()
    jrun, trun = _runner_pair(kind, flat, 3)
    jst, tst = _fill(jrun, trun)
    for k in (0, 2):
        jrun.set_draft_len(k)
        trun.set_draft_len(k)
        jout, jst = jrun.decode_steps(jst, 2)
        tout, tst = trun.decode_steps(tst, 2)
        assert tout.ndim == (2 if k == 0 else 3)
        np.testing.assert_array_equal(tout, np.asarray(jout))


def test_seeded_sampled_slot_keeps_jax_bits():
    """A sampled slot beside greedy ones: one token a step, drawn from the
    same keys as JAX's (random fp32 weights, so the draw matters)."""
    jrun, trun = _runner_pair("paged", _random_flat(), 2)
    jst, tst = _fill(jrun, trun, temps=[0.0, 0.9, 0.0])
    for _ in range(3):
        jout, jst = jrun.decode_steps(jst, 2)
        tout, tst = trun.decode_steps(tst, 2)
        np.testing.assert_array_equal(tout, np.asarray(jout))
    assert (tout[:, 0, 1] == 1).all()
    np.testing.assert_array_equal(tst.keys, np.asarray(jst.keys))


# ------------------------------------------------------------------ engines

ECHO_TEXT = "()*+,-./0123456789:;<=>?@ABCDEFGHIJ" + "()*+"
STREAMS = {"echo": ECHO_TEXT, "plain": "hello world",
           "long": "a long prompt admitted in ragged chunks " * 2}
COMMON = dict(max_context_length=MAX_SEQ, kv_page_size=PAGE,
              step_token_budget=36, max_batch_slots=4)
TOKENS = 40


@pytest.fixture(scope="module")
def perm_ckpt(tmp_path_factory):
    from crowdllama_tpu.testing.modelgen import permutation_checkpoint

    return permutation_checkpoint("tiny-test",
                                  tmp_path_factory.mktemp("perm") / "ckpt",
                                  max_context=MAX_SEQ)


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


async def _streams(engine, probe_interval=None, names=tuple(STREAMS)):
    """``names`` of the streams at once (the long one once the others
    started): name -> (text, token ids)."""
    if probe_interval is not None:
        engine.scheduler.spec_probe_interval = probe_interval
    out = {}

    async def run(name):
        ids: list[int] = []
        _IDS.set(ids)
        text = ""
        async for chunk in engine.generate(STREAMS[name], max_tokens=TOKENS):
            text += chunk.text
        out[name] = (text, ids)

    engine.tokenizer = _Ids(engine.tokenizer)
    tasks = [asyncio.create_task(run(n)) for n in names if n != "long"]
    await asyncio.sleep(0)
    if "long" in names:
        tasks.append(asyncio.create_task(run("long")))
    await asyncio.gather(*tasks)
    return out


def _jax_engine(ckpt, **kw):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine

    return JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False,
                                   intervals=Intervals.default(),
                                   **COMMON, **kw))


def _torch_engine(ckpt, **kw):
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import load_native_params

    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    kw = {"warmup": False, **COMMON, **kw}
    if "devices" not in kw:
        kw["device"] = "cpu"
    return TorchEngine(params=load_native_params(cfg, ckpt,
                                                 dtype=torch.float32),
                       dtype=torch.float32, model="tiny-test", **kw)


def _serve(engine, probe_interval=None, names=tuple(STREAMS)):
    async def go():
        await engine.start()
        try:
            got = await _streams(engine, probe_interval, names)
            stats = engine.describe().get("spec_decode")
            return got, stats, engine.scheduler
        finally:
            await engine.stop()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def plain_streams(perm_ckpt):
    return _serve(_torch_engine(perm_ckpt))[0]


NGRAM, ADAPTIVE = dict(spec_decode="ngram", spec_draft=3), dict(
    spec_decode="ngram", spec_draft=2, spec_draft_max=4)
SPEC_CASES = {
    "paged": NGRAM,
    "int8": dict(NGRAM, kv_dtype="int8"),
    "contiguous": dict(NGRAM, kv_layout="contiguous"),
    "draft": dict(spec_decode="draft", spec_draft=3),
    "paged_adaptive": ADAPTIVE,
    "int8_adaptive": dict(ADAPTIVE, kv_dtype="int8"),
    "contiguous_adaptive": dict(ADAPTIVE, kv_layout="contiguous"),
    "tp2_adaptive": dict(ADAPTIVE, mesh_shape="2"),
    "draft_adaptive": dict(spec_decode="draft", spec_draft=2,
                           spec_draft_max=4, spec_draft_model="tiny-test"),
}
# The n-gram adaptive cases serve the streams whose history never
# matches, so the controller pauses (k = 0) and probes.
NO_ECHO = ("plain", "long")


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_engine_streams_match_jax_and_plain_greedy(case, perm_ckpt,
                                                   plain_streams):
    """Streams on the permutation checkpoint: text and token ids equal to
    plain greedy and to ``JaxEngine``'s with the same spec configuration
    (tp=2 on the CPU for the port, JAX's default mesh there), the
    ``spec_decode`` stats keys equal.  The draft runs from
    ``spec_draft_path`` (the JAX-written checkpoint, its own draft) except
    in ``draft_adaptive``, whose random registry draft misses.  Every
    adaptive case pauses (k = 0: plain dispatches) and probes."""
    kw = dict(SPEC_CASES[case])
    if kw["spec_decode"] == "draft" and "spec_draft_model" not in kw:
        kw["spec_draft_path"] = perm_ckpt
    adaptive = "spec_draft_max" in kw
    interval = 2 if adaptive else None
    names = NO_ECHO if adaptive and kw["spec_decode"] == "ngram" else STREAMS
    tkw = dict(kw, devices=["cpu", "cpu"]) if "mesh_shape" in kw else kw
    got, tstats, tsched = _serve(_torch_engine(perm_ckpt, **tkw), interval,
                                 names)
    jgot, jstats, jsched = _serve(_jax_engine(perm_ckpt, **kw), interval,
                                  names)
    want = {n: plain_streams[n] for n in names}
    assert got == want and jgot == want
    assert set(tstats) == set(jstats)
    assert tsched.spec_steps > 0
    if case in ("paged", "int8", "contiguous"):
        assert tsched.spec_accept_echo > 0
    if case == "draft":
        assert tsched.spec_accept_gen > 0
    if adaptive:
        assert set(tstats["adaptive"]) == set(jstats["adaptive"])
        assert tsched.spec_retunes > 0 and jsched.spec_retunes > 0
        assert tsched.spec_probes > 0 and jsched.spec_probes > 0
        assert tsched.class_steps["plain"] > 0


def test_engine_spec_on_tp2_equals_tp1(perm_ckpt, plain_streams):
    """ngram speculation over a tp=2 mesh on the CPU: the same streams."""
    got, _, sched = _serve(_torch_engine(
        perm_ckpt, spec_decode="ngram", spec_draft=3, mesh_shape="2",
        devices=["cpu", "cpu"]))
    assert got == plain_streams and sched.runner.tp == 2
    assert sched.spec_accept_echo > 0


# ------------------------------------------------------- adaptive controller

class _FakeRunner:
    max_slots, max_seq = 2, 100000
    supports_adaptive_draft = True
    device = torch.device("cpu")

    def __init__(self, k):
        self.draft_len = k

    def set_draft_len(self, k):
        self.draft_len = max(0, int(k))

    def init_state(self):
        return None

    def release(self, state, slot):
        return state


def _flight_blocks(k, accepts, src=2):
    """A packed [1, 3+k, 2] block whose two slots accept ``accepts``."""
    blk = np.zeros((1, 3 + k, 2), np.int32)
    for i, a in enumerate(accepts):
        blk[0, 0, i] = a + 1
        blk[0, 1:2 + a, i] = 7
        blk[0, -1, i] = src if a else 0
    return blk


def test_spec_retune_and_probes_follow_jax():
    """The same retired flights (acceptance falling to zero, plain steps
    while paused, a probe that accepts everything, then growth) drive
    both schedulers' draft length, retunes and probes alike."""
    from concurrent.futures import ThreadPoolExecutor

    from crowdllama_tpu.engine import scheduler as js
    from crowdllama_tpu_torch.engine import scheduler as ts

    def trajectory(mod, to_dev):
        async def go():
            runner = _FakeRunner(4)
            sched = mod.Scheduler(runner, spec_draft_max=6)
            sched._exec = ThreadPoolExecutor(1)
            sched.spec_probe_interval = 6
            for i in range(2):
                sched.slots[i] = mod._SlotInfo(
                    req=mod.GenRequest(prompt_ids=[1], max_tokens=10 ** 6))
            seen = []
            plan = ([(4, (0, 1))] * 3 + [(2, (0, 0))] * 2
                    + [(1, (0, 0))] * 2 + [(0, None)] * 8
                    + [(1, (1, 1))] * 3 + [(2, (2, 2))] * 3)
            for k, acc in plan:
                k = runner.draft_len
                blk = (np.full((1, 2), 7, np.int32) if k == 0
                       else _flight_blocks(k, acc or (k, k)))
                sched._inflight = mod._InFlightChunk(
                    tokens_dev=to_dev(blk), snapshot=list(sched.slots),
                    dispatched_at=time.monotonic())
                await sched._retire_inflight(*mod_args(mod))
                seen.append((runner.draft_len, sched.spec_retunes,
                             sched.spec_probes, sched._chunk_size()))
            sched._exec.shutdown()
            return seen, sched.spec_accept_gen, sched.spec_steps

        return asyncio.run(go())

    def mod_args(mod):
        return (asyncio.get_running_loop(),) if mod is js else ()

    want = trajectory(js, jnp.asarray)
    got = trajectory(ts, torch.from_numpy)
    assert got == want
    ks = [s[0] for s in got[0]]
    assert 0 in ks and ks[-1] > 1 and got[0][-1][2] >= 1


# -------------------------------------------------------------------- plan

MESHES = {"single": "", "tp": "2", "dp": "2x1x1x1x1", "pp": "1x2x1x1x1",
          "sp": "1x1x2x1x1"}


def _outcome(config_cls, resolve, **axes):
    try:
        cfg = config_cls.from_environment(**axes)
        plan = resolve(cfg)
    except NotImplementedError as e:
        return ("not ported", str(e))
    except ValueError as e:
        return ("error", str(e))
    return ("ok", plan.runner, plan.kv_layout)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("spec_mode", ["", "ngram", "draft"])
def test_plan_spec_axis_matches_jax(mesh, layout, kv_dtype, spec_mode):
    """JAX's runner or refusal in every cell; where the JAX plan moves a
    dp/sp/pp mesh to another layout the port refuses the mesh (Queue 1
    item 8) instead."""
    from crowdllama_tpu.config import Configuration as JConfiguration
    from crowdllama_tpu.engine.plan import resolve_serving_plan as jresolve
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.plan import resolve_serving_plan

    axes = dict(kv_layout=layout, kv_dtype=kv_dtype, spec_decode=spec_mode,
                spec_draft_model="tiny-test" if spec_mode == "draft" else "",
                mesh_shape=MESHES[mesh])
    want = _outcome(JConfiguration, lambda c: jresolve(c, 8), **axes)
    got = _outcome(Configuration, resolve_serving_plan, **axes)
    if mesh == "single" or (mesh == "tp" and layout == "paged"):
        assert got[0] == want[0]
        if got[0] == "ok":
            assert got == want
    elif want[0] == "error":
        assert got[0] in ("error", "not ported")
    else:
        assert got[0] == "not ported" and "item 8" in got[1]


def test_paused_flights_replay_the_warmup_graph(perm_ckpt, plain_streams,
                                                monkeypatch):
    """megastep_k with the adaptive controller: speculative flights run
    eagerly, paused (k = 0) full chunks replay the megastep graphs captured
    at warm-up (``fake_capture`` standing in for the card), no capture
    happens while serving, and the streams equal plain greedy."""
    from test_torch_megastep import fake_capture

    from crowdllama_tpu_torch.engine.graphs import GraphCache
    from crowdllama_tpu_torch.engine.runner import ModelRunner

    def cache(self):
        if self._graphs is None:
            self._graphs = GraphCache(capture=fake_capture)
        return self._graphs

    monkeypatch.setattr(ModelRunner, "_graph_cache", cache)
    engine = _torch_engine(perm_ckpt, spec_decode="ngram", spec_draft=2,
                           spec_draft_max=4, megastep_k=4, decode_chunk=4,
                           warmup=True)

    async def go():
        await engine.start()
        captured = engine.runner._graphs.captures
        try:
            got = await _streams(engine, probe_interval=2)
        finally:
            await engine.stop()
        return got, captured

    got, captured = asyncio.run(go())
    sched = engine.scheduler
    assert got == plain_streams
    assert captured >= 1 and engine.runner._graphs.captures == captured
    assert sched.class_steps.get("megastep", 0) > 0
    assert sched.class_steps.get("spec", 0) > 0
    assert all(g.replays > 0 for g in engine.runner._graphs._graphs.values()
               if g.inputs.get("noise") is None)
