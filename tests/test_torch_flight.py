"""The port scheduler's flight plane and self-watchdog against the JAX
scheduler's.

- Telemetry parity: the same traffic (a short greedy prompt, then a long
  prompt admitted in ragged chunks, sent one at a time) on a
  ``JaxEngine`` and a ``TorchEngine`` on the permutation checkpoint, with
  megastep (K = 4) and without.  Every family that moves on the JAX
  worker moves on the torch worker, under the same dispatch labels: the
  duty cycle per dispatch class, ``step_token_budget_used``,
  ``crowdllama_host_gap_seconds`` per class, ``crowdllama_prefill_chunk_
  seconds`` and the padding counters (useful and waste tokens).
- The speculation plane: the same traffic plus an echo prompt on n-gram
  speculative engines of both packages: the ``spec`` class's duty cycle
  and host gaps and the ``spec_*`` gauges move alike, and the
  ``spec_pipeline_*`` gauges exist on both.
- The self-watchdog, the JAX units (``tests/test_gray_failure.py``) on
  the port's ``Scheduler`` with a stub runner and a fake clock: the
  threshold arithmetic per dispatch class; the typed failure of every
  request with one self-drain; off by default, and submissions refused
  once wedged.  ``TorchEngine.generate`` raises ``WedgedError``.
"""

import asyncio
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.engine.scheduler import (  # noqa: E402
    DONE,
    GenRequest,
    Scheduler,
    WedgedError,
)
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402

CLASSES = ("plain", "megastep", "ragged", "spec", "other")


def _families(engine, telemetry, before=None) -> dict:
    """The flight-plane families of one worker: gauges from
    ``obs_gauges`` and counts from the package's ``ENGINE_TELEMETRY``
    (as deltas from ``before``)."""
    g = engine.obs_gauges()
    pad = telemetry.padding_snapshot()
    out = {f"duty_cycle|{c}": g[f"duty_cycle|dispatch={c}"]
           for c in ("plain", "megastep", "ragged", "ragged_mega", "spec")}
    out["step_token_budget_used"] = g["step_token_budget_used"]
    for c in CLASSES:
        out[f"host_gap_seconds_count|{c}"] = \
            telemetry.host_gap_seconds.labels(c).count
    out["prefill_chunk_seconds_count"] = telemetry.prefill_chunk_seconds.count
    out["padding_waste_tokens_total"] = pad["waste"]
    out["useful_tokens_total"] = pad["useful"]
    # The speculation plane's gauges (spec_steps etc. on a spec runner
    # only; the pipeline's on every worker).
    out.update({k: v for k, v in g.items() if k.startswith("spec_")})
    if before is not None:
        for k in out:
            if "count" in k or k.endswith("_total"):
                out[k] -= before[k]
    return out


async def _traffic(engine, echo: bool = False) -> list:
    outs = []
    prompts = ["the quick brown fox",
               "a long prompt that is prefilled in chunks " * 3]
    if echo:  # the permutation walk replays the prompt's opening stretch
        prompts.append("()*+,-./0123456789:;<=>?@ABCDEFGHIJ" + "()*+")
    for prompt in prompts:
        text = ""
        async for chunk in engine.generate(prompt, max_tokens=12):
            text += chunk.text
        outs.append(text)
    return outs


@pytest.mark.parametrize("megastep_k", [0, 4])
async def test_flight_plane_families_move_as_on_a_jax_worker(tmp_path,
                                                             megastep_k):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.obs.metrics import ENGINE_TELEMETRY as JTEL
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.obs.metrics import ENGINE_TELEMETRY as TTEL

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=256)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=256)))
    common = dict(max_context_length=256, kv_page_size=16,
                  step_token_budget=36, max_batch_slots=4,
                  megastep_k=megastep_k, decode_chunk=4)
    jeng = JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False, intervals=Intervals.default(),
                                   **common))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False,
        **common)
    moved = {}
    for name, eng, tel in (("jax", jeng, JTEL), ("torch", teng, TTEL)):
        await eng.start()
        try:
            before = _families(eng, tel)
            texts = await _traffic(eng)
            moved[name] = _families(eng, tel, before)
        finally:
            await eng.stop()
        moved[name + "_texts"] = texts
    assert moved["torch_texts"] == moved["jax_texts"]
    nonzero = {k: {f for f, v in moved[k].items() if v}
               for k in ("jax", "torch")}
    assert nonzero["torch"] == nonzero["jax"]
    classes = ({"megastep", "ragged_mega"} if megastep_k
               else {"plain", "ragged"})
    assert {f.split("|")[1] for f in nonzero["torch"]
            if f.startswith("duty_cycle|")} == classes
    assert {"step_token_budget_used", "prefill_chunk_seconds_count",
            "padding_waste_tokens_total",
            "useful_tokens_total"} <= nonzero["torch"]


async def test_spec_class_and_families_move_as_on_a_jax_worker(tmp_path):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.obs.metrics import ENGINE_TELEMETRY as JTEL
    from crowdllama_tpu.testing.modelgen import permutation_checkpoint
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import load_native_params
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.obs.metrics import ENGINE_TELEMETRY as TTEL

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=256)
    common = dict(max_context_length=256, kv_page_size=16,
                  step_token_budget=36, max_batch_slots=4, decode_chunk=4,
                  spec_decode="ngram", spec_draft=3)
    jeng = JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False, intervals=Intervals.default(),
                                   **common))
    teng = TorchEngine(device="cpu", params=load_native_params(
        get_config("tiny-test", max_context_length=256), ckpt),
        model="tiny-test", warmup=False, **common)
    moved = {}
    for name, eng, tel in (("jax", jeng, JTEL), ("torch", teng, TTEL)):
        await eng.start()
        try:
            before = _families(eng, tel)
            texts = await _traffic(eng, echo=True)
            moved[name] = _families(eng, tel, before)
        finally:
            await eng.stop()
        moved[name + "_texts"] = texts
    assert moved["torch_texts"] == moved["jax_texts"]
    nonzero = {k: {f for f, v in moved[k].items() if v}
               for k in ("jax", "torch")}
    assert nonzero["torch"] == nonzero["jax"]
    assert set(moved["torch"]) == set(moved["jax"])
    assert {"duty_cycle|spec", "host_gap_seconds_count|spec", "spec_steps",
            "spec_emitted", "spec_accept_echo", "spec_draft_len",
            "spec_pipeline_depth"} <= nonzero["torch"]


# ------------------------------------------------- dispatch self-watchdog

class _StubRunner:
    max_slots = 2
    max_seq = 128


def _flight(dispatched_at: float, megastep: bool = False):
    """The host-side fields of a flight that ``_flight_class`` reads (the
    watchdog never touches the device)."""
    return types.SimpleNamespace(
        tokens_dev=None, ragged_steps=0,
        done_dev=object() if megastep else None,
        dispatched_at=dispatched_at)


async def test_self_watchdog_threshold_arithmetic_on_a_fake_clock():
    now = [0.0]
    sched = Scheduler(_StubRunner(), wedge_multiplier=4.0,
                      clock=lambda: now[0])
    sched2 = Scheduler(_StubRunner(), wedge_multiplier=3.0,
                       clock=lambda: now[0])
    try:
        assert sched.check_wedged() is False
        # A class with no retired flight is never judged.
        sched._inflight = _flight(dispatched_at=0.0)
        now[0] = 1e6
        assert sched.check_wedged() is False
        # 4 x 0.5 s is under the floor: the floor (5 s) is the threshold.
        sched._flight_ewma["plain"] = 0.5
        assert sched.check_wedged(now=4.9) is False
        assert sched.check_wedged(now=5.1) is True
        assert sched.wedged is True and sched.wedged_events == 1
        # A megastep flight is judged against its class: 3 x 10 s.
        sched2._flight_ewma["megastep"] = 10.0
        sched2._flight_ewma["plain"] = 0.1
        sched2._inflight = _flight(dispatched_at=0.0, megastep=True)
        assert sched2.check_wedged(now=29.0) is False
        assert sched2.check_wedged(now=31.0) is True
    finally:
        await sched.stop()
        await sched2.stop()


async def test_self_watchdog_fails_requests_typed_and_drains_once():
    now = [0.0]
    sched = Scheduler(_StubRunner(), wedge_multiplier=2.0,
                      clock=lambda: now[0])
    fired = []
    sched.drain_requested_cb = lambda: fired.append(1)
    try:
        r1 = GenRequest(prompt_ids=[1, 2])
        r2 = GenRequest(prompt_ids=[3])
        await sched.submit(r1)
        await sched.submit(r2)
        sched._flight_ewma["plain"] = 1.0
        sched._inflight = _flight(dispatched_at=0.0)
        assert sched.check_wedged(now=6.0) is True
        for r in (r1, r2):
            tok, reason = r.out.get_nowait()
            assert tok is DONE
            assert reason.startswith("error: wedged")
            assert "2x class EWMA" in reason
            assert r.out.qsize() == 0
            assert r.finish("stop") is False and r.out.qsize() == 0
        assert fired == [1]
        assert sched.check_wedged(now=100.0) is True
        assert fired == [1] and sched.wedged_events == 1
        assert await sched.migrate() == 0
        g = sched.telemetry_gauges()
        assert g["wedged"] == 1.0 and g["wedged_events_total"] == 1.0
        assert issubclass(WedgedError, RuntimeError)
    finally:
        await sched.stop()


async def test_self_watchdog_off_by_default_and_submit_refused_after():
    sched = Scheduler(_StubRunner())
    try:
        sched._flight_ewma["plain"] = 0.001
        sched._inflight = _flight(dispatched_at=0.0)
        assert sched.check_wedged(now=1e6) is False
    finally:
        await sched.stop()
    now = [0.0]
    sched2 = Scheduler(_StubRunner(), wedge_multiplier=2.0,
                       clock=lambda: now[0])
    try:
        sched2._flight_ewma["plain"] = 1.0
        sched2._inflight = _flight(dispatched_at=0.0)
        assert sched2.check_wedged(now=10.0) is True
        with pytest.raises(RuntimeError, match="draining"):
            await sched2.submit(GenRequest(prompt_ids=[1]))
    finally:
        await sched2.stop()


async def test_generate_raises_wedged_error():
    """A request failed by the watchdog surfaces as ``WedgedError`` from
    ``generate``; the engine self-drains (its own ``migrate`` without a
    peer, which moves nothing once wedged)."""
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    eng = TorchEngine(device="cpu", dtype=torch.float32, model="tiny-test",
                      max_context_length=256, kv_page_size=16,
                      max_batch_slots=2, warmup=False, wedge_multiplier=3.0)
    await eng.start()
    try:
        sched = eng.scheduler
        assert sched._watchdog_task is not None

        async def consume():
            async for _ in eng.generate("hello there", max_tokens=200):
                pass

        task = asyncio.ensure_future(consume())
        while not sched.tokens_generated:
            await asyncio.sleep(0.001)
        sched._declare_wedged("plain", 10.0, 5.0)
        with pytest.raises(WedgedError, match="^wedged: plain flight"):
            await asyncio.wait_for(task, 30)
        assert await asyncio.wait_for(eng._chaos_drain, 30) == 0
        assert eng.obs_gauges()["wedged"] == 1.0
    finally:
        await eng.stop()
