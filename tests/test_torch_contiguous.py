"""The port's contiguous-KV path against the JAX package.

- Kernel D's plain version (``ops/cuda/flash.py``, what the wrapper runs
  on CPU tensors) against the JAX Pallas ``flash_decode_attention`` in
  interpret mode and against ``decode_attention_ref``: fp32 within 1e-5,
  bf16 within 2e-2 (one bf16 rounding of outputs ~1).  A zero-length slot
  gets zeros from the kernels and V's mean from the references, so it is
  compared with the references only.
- The contiguous runner: teacher-forced logits after monolithic and
  chunked admissions, against JAX ``T.prefill`` + ``T.decode_step`` on the
  same random fp32 weights, within 1e-4; ``embed_prompts`` against the JAX
  runner's, within 1e-5.
- The engine: greedy streams token-identical to ``JaxEngine`` on the
  permutation checkpoint, with long prompts admitted through legacy chunked
  prefill on the contiguous layout and on the paged layout with
  ``ragged_prefill=False`` (a prefix hit seeds the paged job's context).
- The serving plan: unported axes raise, int8 KV resolves on both layouts,
  the layout and the KV dtype are validated.
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
from crowdllama_tpu.ops.pallas.flash import (  # noqa: E402
    flash_decode_attention as j_flash_decode,
)
from crowdllama_tpu_torch.config import Configuration  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.plan import resolve_serving_plan  # noqa: E402
from crowdllama_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.ops.cuda.flash import flash_decode_attention  # noqa: E402

ATOL = 1e-4
MAX_SEQ = 256


# ------------------------------------------------------------------ kernel D

@pytest.mark.parametrize("softcap,window,bf16", [
    (0.0, 0, False), (30.0, 0, False), (0.0, 9, False), (0.0, 0, True),
    (25.0, 13, True)])
def test_decode_plain_matches_jax(softcap, window, bf16):
    """Mixed lengths, a one-token slot and a zero-length slot."""
    os.environ["CROWDLLAMA_PALLAS_INTERPRET"] = "1"
    try:
        r = np.random.default_rng(6)
        b, h, hkv, s, dh = 4, 4, 2, 64, 16
        q = r.standard_normal((b, h, dh)).astype(np.float32)
        kc = r.standard_normal((b, hkv, s, dh)).astype(np.float32)
        vc = r.standard_normal((b, hkv, s, dh)).astype(np.float32)
        lens = np.array([64, 1, 0, 37], np.int32)
        tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                    else (torch.float32, jnp.float32))
        kw = dict(softcap=softcap, sliding_window=window)
        got = flash_decode_attention(
            torch.from_numpy(q).to(tdt), torch.from_numpy(kc).to(tdt),
            torch.from_numpy(vc).to(tdt), torch.from_numpy(lens), 0.25, **kw)
        jargs = (jnp.asarray(q, jdt), jnp.asarray(kc, jdt),
                 jnp.asarray(vc, jdt), jnp.asarray(lens), 0.25)
        ref = np.asarray(JA.decode_attention_ref(*jargs, **kw), np.float32)
        pallas = np.asarray(j_flash_decode(*jargs, **kw), np.float32)
    finally:
        os.environ.pop("CROWDLLAMA_PALLAS_INTERPRET", None)
    tol = 2e-2 if bf16 else 1e-5
    g = got.float().numpy()
    np.testing.assert_allclose(g, ref, atol=tol, rtol=0)
    live = [0, 1, 3]
    np.testing.assert_allclose(g[live], pallas[live], atol=tol, rtol=0)
    assert not pallas[2].any()  # the TPU (and CUDA) kernel writes zeros


# -------------------------------------------------------------------- runner

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


_j_decode_step = jax.jit(JT.decode_step, static_argnums=(1,))


def _jax_logits(jparams, jcfg, ids, n_prompt):
    """Logits after consuming ids[:n_prompt + i], for each i."""
    logits, ks, vs = JT.prefill(jparams, jcfg,
                                jnp.asarray(ids[:n_prompt])[None],
                                jnp.arange(n_prompt)[None])
    out = [np.asarray(logits[0, -1])]
    shape = (ks.shape[0], 1, ks.shape[2], MAX_SEQ, ks.shape[4])
    kc = jnp.zeros(shape, jnp.float32).at[:, :, :, :n_prompt].set(ks)
    vc = jnp.zeros(shape, jnp.float32).at[:, :, :, :n_prompt].set(vs)
    for p in range(n_prompt, len(ids)):
        lg, kc, vc = _j_decode_step(jparams, jcfg, jnp.asarray([ids[p]]),
                                    jnp.asarray([p]), kc, vc,
                                    jnp.asarray([p + 1]))
        out.append(np.asarray(lg[0]))
    return np.stack(out)


def test_contiguous_runner_teacher_forced_logits_match_jax():
    """Slots 0 and 2 admitted by monolithic prefill, slot 1 by legacy
    chunked prefill (chunks of 32); then teacher-forced decode steps over
    the contiguous cache.  Every logits row matches the JAX reference."""
    flat = _flat()
    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    jparams = _jparams(flat)
    r = np.random.default_rng(4)
    prompts = {0: [int(t) for t in r.integers(0, 500, 21)],
               1: [int(t) for t in r.integers(0, 500, 75)],
               2: [int(t) for t in r.integers(0, 500, 9)]}
    run = ModelRunner(cfg, params=params_from_numpy(flat), max_slots=3,
                      max_seq=MAX_SEQ, device="cpu")
    run.prefill_chunk = 32
    hist: dict[int, list[int]] = {}
    with torch.inference_mode():
        st = run.init_state()
        for slot, p in prompts.items():
            if slot == 1:
                job = run.prefill_begin(p)
                steps = 1
                while not run.prefill_step(job):
                    steps += 1
                assert steps == 3
                first, ks, vs, plen = run.prefill_finish(job, 0.0, 1.0)
            else:
                first, ks, vs, plen = run.prefill(p, 0.0, 1.0)
            st = run.insert(st, slot, ks, vs, plen, first, 0.0, 1.0,
                            prompt_tokens=p)
            hist[slot] = list(p) + [first]
        forced = {s: [int(t) for t in r.integers(0, 500, 4)] for s in range(3)}
        got = {s: [] for s in range(3)}
        for i in range(5):
            logits = run.decode_logits(st)
            for s in range(3):
                got[s].append(logits[s].numpy().copy())
            if i == 4:
                break
            for s in range(3):
                st.tokens[s] = forced[s][i]
                st.seq_lens[s] += 1
    for s in range(3):
        ref = _jax_logits(jparams, jcfg, hist[s] + forced[s], len(prompts[s]))
        np.testing.assert_allclose(np.stack(got[s]), ref[1:6], atol=ATOL,
                                   rtol=0)
        assert int(ref[0].argmax()) == hist[s][-1]  # greedy first token


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_embed_prompts_match_jax_runner(layout):
    from crowdllama_tpu.engine.paged import (
        PagedModelRunner as JaxPagedModelRunner,
    )
    from crowdllama_tpu.engine.runner import ModelRunner as JaxModelRunner

    flat = _flat(seed=5)
    jcfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    r = np.random.default_rng(8)
    prompts = [[int(t) for t in r.integers(0, 500, n)]
               for n in (3, 40, 17, 33, 5)]
    kw = dict(max_slots=2, max_seq=MAX_SEQ)
    if layout == "paged":
        jrun = JaxPagedModelRunner(jcfg, params=_jparams(flat),
                                   dtype=jnp.float32, page_size=16, **kw)
        trun = PagedModelRunner(cfg, params=params_from_numpy(flat),
                                device="cpu", page_size=16, **kw)
    else:
        jrun = JaxModelRunner(jcfg, params=_jparams(flat), dtype=jnp.float32,
                              **kw)
        trun = ModelRunner(cfg, params=params_from_numpy(flat), device="cpu",
                           **kw)
    want = jrun.embed_prompts(prompts)
    got = trun.embed_prompts(prompts)
    assert got.shape == (5, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -------------------------------------------------------------------- engine

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


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
async def test_chunked_admission_streams_match_jax_engine(tmp_path, layout):
    """Greedy streams on the permutation checkpoint: a short prompt, a long
    prompt admitted in 32-token chunks, and a long prompt sharing the
    first 48 tokens of the previous one (on the paged layout those three
    cached pages seed the chunked job and only the tail is prefilled)."""
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
    long_a = "chunked admission of a long prompt, one chunk per loop! " * 2
    long_b = long_a[:47] + " and then a tail that only the second one has"
    prompts = ["short one", long_a, long_b]
    common = dict(max_context_length=MAX_SEQ, kv_page_size=16,
                  max_batch_slots=4, kv_layout=layout, ragged_prefill=False)
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
        want = await _streams(jeng, prompts)
        jhits = getattr(jeng.scheduler.runner, "prefix_hits", 0)
    finally:
        await jeng.stop()
    await teng.start()
    try:
        teng.runner.prefill_chunk = 32
        got = await _streams(teng, prompts)
        assert teng.scheduler.prefill_chunks >= 4
        assert teng.scheduler.ragged_chunks == 0
        if layout == "paged":
            assert teng.runner.prefix_hits == jhits >= 1
    finally:
        await teng.stop()
    assert got == want


# ---------------------------------------------------------------------- plan

@pytest.mark.parametrize("axis,value", [
    ("kv_dtype", "int8"), ("quantize", "int8"), ("mesh_shape", "1x1x2x1x1"),
    ("mesh_shape", "1x2")])
def test_unported_axes_raise_naming_the_roadmap_item(axis, value):
    """Unported axes raise naming their ROADMAP item.  int8 KV is ported:
    it resolves on both layouts, normalized and carried in the plan, and
    an unknown KV dtype is refused.  Quantized weights are ported (ROADMAP
    Queue 1 item 10): int8 and int4 resolve on both layouts, normalized
    and carried in the plan as JAX's plan carries them, and an unknown
    mode is refused as JAX refuses it.  Every in-mesh axis is ported
    (ROADMAP Queue 1 item 8.1): a tp mesh serves on both layouts, and an
    sp mesh serves on the contiguous layout, a paged request falling back
    to it with JAX's note."""
    if axis == "quantize":
        from crowdllama_tpu.config import Configuration as JConfiguration
        from crowdllama_tpu.engine.plan import (
            resolve_serving_plan as j_resolve_serving_plan,
        )

        for layout in ("paged", "contiguous"):
            for mode in (value, "int4"):
                plan = resolve_serving_plan(Configuration.from_environment(
                    kv_layout=layout, quantize=f" {mode.upper()} "))
                want = j_resolve_serving_plan(JConfiguration.from_environment(
                    kv_layout=layout, quantize=f" {mode.upper()} "), 1)
                assert (plan.kv_layout, plan.quantize) == (
                    want.kv_layout, want.quantize) == (layout, mode)
        for config in (Configuration, JConfiguration):
            with pytest.raises(ValueError, match="unknown quantize mode"):
                config.from_environment(quantize="fp8")
        return
    if axis == "kv_dtype":
        for layout in ("paged", "contiguous"):
            plan = resolve_serving_plan(Configuration(
                kv_layout=layout, kv_dtype=f" {value.upper()} "))
            assert (plan.kv_layout, plan.kv_dtype) == (layout, "int8")
        with pytest.raises(ValueError, match="unknown kv dtype"):
            Configuration(kv_dtype="fp8")
        return
    if axis == "mesh_shape":
        from crowdllama_tpu.config import Configuration as JConfiguration
        from crowdllama_tpu.engine.plan import (
            resolve_serving_plan as j_resolve_serving_plan,
        )

        sp = value != "1x2"
        for layout in ("paged", "contiguous"):
            plan = resolve_serving_plan(Configuration(mesh_shape=value,
                                                      kv_layout=layout))
            want = j_resolve_serving_plan(JConfiguration(
                mesh_shape=value, kv_layout=layout), 8)
            assert (plan.runner, plan.kv_layout, plan.notes) == (
                want.runner, want.kv_layout, want.notes)
            assert plan.mesh_shape == value
            assert plan.kv_layout == ("contiguous" if sp else layout)
            assert plan.fallback == (sp and layout == "paged")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        resolve_serving_plan(Configuration(**{axis: value}))


def test_plan_names_the_runner_and_checks_the_layout():
    assert resolve_serving_plan(Configuration()).runner == "PagedModelRunner"
    plan = resolve_serving_plan(Configuration(kv_layout=" Contiguous "))
    assert (plan.runner, plan.kv_layout) == ("ModelRunner", "contiguous")
    with pytest.raises(ValueError, match="unknown kv layout"):
        Configuration(kv_layout="ring")
