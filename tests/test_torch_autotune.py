"""The port's autopilot (``engine/autotune.py``, ``obs/slo.py
WindowBurn``) against the JAX package's.

- **Tuner parity.** JAX's ``AutoTuner`` and the port's, each over its own
  copy of one fake scheduler and runner, fed the same windows: their
  ``describe()``, ``gauges()``, dial-write logs and ``BACKOFF_LOG``
  events are equal after every window, over capability sets (every dial,
  each one missing, an off-grid start, none) and hypothesis-drawn
  ``(duty, emitted, dt)`` runs with burn episodes.
- ``WindowBurn`` on hypothesis-drawn latencies; the grid math (current
  point always on its grid, the ragged chunk recomputed as the paged
  runner derives it, the draft cap clamping the live draft).
- **Gossip points.** ``encode_point`` bytes are equal; a ``tune/`` point
  written by a port ``GossipNode`` warm-starts a JAX tuner and the
  reverse, off-grid values clamped onto the reader's grid.
- **Config.** The seven ``autotune*`` fields, their environment
  variables, flags and errors equal JAX's.
- **The gateway.** A back-off is an edge-triggered ``autotune_backoff``
  flight reason, and the captured trace carries the dial move.
- **The scheduler.** On ``tiny-test`` (fp32 random weights carried
  across), the port ``Scheduler`` with the port tuner, a
  ``scheduler.ragged_chunk`` delay and its megastep graphs through the
  CPU stand-in capture: its streams equal the port's untuned control and
  JAX's ``Scheduler``, with >= 3 moves, >= 1 revert and >= 1 back-off, and
  no megastep K is captured twice (a revert replays its graph).  The
  engine builds the tuner from its config and reports it.
- **The tp gate.** On a runner whose tp ranks sit on two devices the
  megastep grid is ``(0,)``, where the serving plan refuses megastep.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu import config as jconfig  # noqa: E402
from crowdllama_tpu.cli import main as jcli  # noqa: E402
from crowdllama_tpu.engine import autotune as ja  # noqa: E402
from crowdllama_tpu.obs import slo as jslo  # noqa: E402
from crowdllama_tpu.swarm import gossip as jg  # noqa: E402
from crowdllama_tpu_torch import config as tconfig  # noqa: E402
from crowdllama_tpu_torch.cli import main as tcli  # noqa: E402
from crowdllama_tpu_torch.engine import autotune as ta  # noqa: E402
from crowdllama_tpu_torch.obs import slo as tslo  # noqa: E402
from crowdllama_tpu_torch.swarm import gossip as tg  # noqa: E402

MAX_SEQ = 256


# --------------------------------------------------------------- fakes


class _Logged:
    """Records every write of the attributes a tuner may move."""

    _MOVED = ("megastep_k", "_megastep", "spec_draft_max",
              "spec_pipeline_depth", "step_token_budget", "prefill_chunk",
              "ragged_chunk")

    def __setattr__(self, name, value):
        log = self.__dict__.get("log")
        if log is not None and name in self._MOVED:
            log.append((type(self).__name__, name, value))
        object.__setattr__(self, name, value)


class FakeRunner(_Logged):
    def __init__(self, log, supports_megastep=True, supports_ragged=True,
                 page_size=32, max_slots=4, step_token_budget=96,
                 prefill_chunk=64, remote_draft=False):
        self.supports_megastep = supports_megastep
        self.supports_ragged = supports_ragged
        self.supports_remote_draft = remote_draft
        self.page_size = page_size
        self.max_slots = max_slots
        self.step_token_budget = step_token_budget
        self.prefill_chunk = prefill_chunk
        c = min(prefill_chunk, max(step_token_budget - max_slots,
                                   page_size))
        self.ragged_chunk = max(page_size, (c // page_size) * page_size)
        self.draft_len = 3
        self.log = log

    def set_draft_len(self, k):
        self.draft_len = k
        self.log.append(("FakeRunner", "set_draft_len", k))


class FakeScheduler(_Logged):
    def __init__(self, runner, megastep_k=4, spec_draft_max=4,
                 spec_adaptive=True, pipeline_depth=None):
        self.runner = runner
        self.megastep_k = megastep_k
        self._megastep = megastep_k > 0
        self.spec_draft_max = spec_draft_max
        self._spec_adaptive = spec_adaptive
        if pipeline_depth is not None:
            self.spec_pipeline_depth = pipeline_depth
        self.log = runner.log


# name -> (runner kwargs, scheduler kwargs)
CAPABILITIES = {
    "every_dial": (dict(remote_draft=True), dict(pipeline_depth=8)),
    "no_megastep": (dict(supports_megastep=False), dict(megastep_k=0)),
    "no_spec": ({}, dict(spec_adaptive=False)),
    "no_ragged": (dict(step_token_budget=0), {}),
    "no_chunk": (dict(step_token_budget=0, prefill_chunk=0), {}),
    "off_grid": (dict(step_token_budget=90), dict(megastep_k=3)),
    "nothing": (dict(supports_megastep=False, step_token_budget=0,
                     prefill_chunk=0),
                dict(megastep_k=0, spec_adaptive=False)),
}


def _pair(cap, **tuner_kw):
    """(JAX tuner, port tuner) over twin fakes of capability set ``cap``;
    each tuner's fakes log to ``tuner.sched.log``."""
    rkw, skw = CAPABILITIES[cap]
    out = []
    for mod in (ja, ta):
        sched = FakeScheduler(FakeRunner([], **rkw), **skw)
        out.append(mod.AutoTuner(sched, model_id="m", **tuner_kw))
    return out


def _state(t, mod) -> dict:
    return {"describe": t.describe(), "gauges": t.gauges(),
            "log": list(t.sched.log), "grids": dict(t._grids),
            "backoff": mod.BACKOFF_LOG.snapshot()}


def _since(backoff: tuple, total0: int) -> tuple:
    """A process-wide back-off log's snapshot relative to ``total0``: the
    back-offs recorded since, and the last one if it is one of them (an
    earlier test in the same process may have left its own)."""
    total, last = backoff
    return total - total0, last if total > total0 else None


def _drive_equal(jt, tt, windows) -> None:
    j0, t0 = ja.BACKOFF_LOG.snapshot()[0], ta.BACKOFF_LOG.snapshot()[0]
    for i, w in enumerate(windows):
        jt.on_window("plain", *w)
        tt.on_window("plain", *w)
        js, ts = _state(jt, ja), _state(tt, ta)
        js["backoff"] = _since(js["backoff"], j0)
        ts["backoff"] = _since(ts["backoff"], t0)
        assert js == ts, f"window {i} {w}"


# A run of windows: segments of healthy (ms-scale) or burning (far over
# the 10 ms/token objective) per-token latency.
_window = st.tuples(st.floats(0.0, 1.0), st.integers(1, 16),
                    st.floats(0.0005, 0.008))
_segment = st.tuples(st.booleans(), st.lists(_window, min_size=1,
                                             max_size=12))


def _windows(segments) -> list:
    out = []
    for burning, ws in segments:
        for duty, emitted, per_token in ws:
            if burning:
                per_token *= 100.0
            out.append((duty, emitted, per_token * emitted))
    return out


# ------------------------------------------------------------- the tuner


@pytest.mark.parametrize("cap", sorted(CAPABILITIES))
@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segments=st.lists(_segment, min_size=1, max_size=8),
       interval=st.integers(1, 3),
       min_gain=st.sampled_from([0.0, 0.02, 1e6]),
       decode_ms=st.sampled_from([0.0, 10.0]))
def test_tuner_moves_as_the_jax_tuner(cap, segments, interval, min_gain,
                                      decode_ms):
    jt, tt = _pair(cap, interval=interval, min_gain=min_gain,
                   decode_ms=decode_ms, burn_short=2, burn_long=4)
    assert jt._order == tt._order
    _drive_equal(jt, tt, _windows(segments))


@pytest.mark.parametrize("cap", sorted(CAPABILITIES))
def test_scripted_runs_move_revert_and_back_off_alike(cap):
    """A fixed run through keeps, reverts, a back-off and its cooldown,
    and the same run with the gossip warm start pending."""
    windows = ([(0.5, 1, 0.001)] * 4 + [(1.0, 4, 0.004)] * 6
               + [(1.0, 1, 0.1)] * 5 + [(0.8, 2, 0.002)] * 12)
    jt, tt = _pair(cap, interval=2, decode_ms=10.0, burn_short=2,
                   burn_long=4)
    _drive_equal(jt, tt, windows)
    assert tt.backoffs == 1
    if any(len(tt._grids[d][0]) > 1 for d in tt._order):
        assert tt.moves >= 2 and tt.reverts >= 1, tt.describe()
    jg_, tg_ = _Points(), _Points()
    jt, tt = _pair(cap, interval=2, gossip=jg_)
    tt.set_gossip(tg_)
    _drive_equal(jt, tt, windows)
    assert jg_.points == tg_.points


def test_window_burn_needs_an_objective_and_a_full_short_window():
    for mod in (jslo, tslo):
        wb = mod.WindowBurn(objective_ms=0.0, short=2, long=4)
        for _ in range(8):
            wb.observe(1e9)
        assert wb.burn() == 0.0 and not wb.in_fast_burn()
        wb = mod.WindowBurn(objective_ms=10.0, short=2, long=4)
        assert wb.observe(5.0) is False and not wb.in_fast_burn()
        assert wb.observe(50.0) is True and not wb.in_fast_burn()
        for _ in range(4):
            wb.observe(50.0)
        assert wb.in_fast_burn() and wb.burn() >= 14.0
        assert wb.breaches_total == 5


@settings(max_examples=60, deadline=None)
@given(ms=st.lists(st.floats(0.0, 100.0), max_size=60),
       objective=st.sampled_from([0.0, 5.0, 20.0]),
       short=st.integers(1, 6), long=st.integers(1, 12),
       budget=st.sampled_from([0.01, 0.05, 0.5]))
def test_window_burn_equals_the_jax_window_burn(ms, objective, short, long,
                                                budget):
    j = jslo.WindowBurn(objective, short, long, budget)
    t = tslo.WindowBurn(objective, short, long, budget)
    for x in ms:
        assert j.observe(x) == t.observe(x)
        assert (j.burn(), j.in_fast_burn(), j.breaches_total) == (
            t.burn(), t.in_fast_burn(), t.breaches_total)


def test_grids_hold_the_current_point_and_recompute_the_chunk():
    r = FakeRunner([], step_token_budget=90)
    t = ta.AutoTuner(FakeScheduler(r, megastep_k=3), model_id="m")
    for dial, cur in (("megastep_k", 3), ("step_token_budget", 90)):
        vals, idx = t._grids[dial]
        assert vals[idx] == cur and list(vals) == sorted(vals)
    t._apply("step_token_budget", 132)
    c = min(r.prefill_chunk, max(132 - r.max_slots, r.page_size))
    assert r.ragged_chunk == max(r.page_size, c // r.page_size * r.page_size)
    t._apply("prefill_chunk", 32)
    assert r.ragged_chunk == 32
    r.draft_len = 4
    t._apply("draft_k", 2)
    assert t.sched.spec_draft_max == 2 and r.draft_len == 2


def test_constants_and_families_are_the_jax_packages():
    for name in ("DIALS", "METRIC_FAMILIES", "DEFAULT_BOUNDS", "MIN_GAIN",
                 "AUTO_OBJECTIVE_MULT", "COOLDOWN_PHASES"):
        assert getattr(ta, name) == getattr(ja, name), name
    from crowdllama_tpu_torch.obs.metrics import engine_gauge_lines

    t = ta.AutoTuner(FakeScheduler(FakeRunner([])), model_id="m",
                     interval=1)
    t.on_window("plain", 1.0, 1, 0.001)
    text = "\n".join(engine_gauge_lines(t.gauges()))
    for fam in ta.METRIC_FAMILIES:
        assert f"# TYPE {fam} " in text, fam
    for dial in ta.DIALS:
        assert f'crowdllama_autotune_dial{{dial="{dial}"}}' in text


# -------------------------------------------------------------- the tp gate


def test_megastep_grid_is_zero_where_the_plan_refuses_megastep():
    from crowdllama_tpu_torch.engine.plan import check_megastep

    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="distinct devices"):
        check_megastep(4, two)
    r = FakeRunner([])
    r.devices = two
    t = ta.AutoTuner(FakeScheduler(r, megastep_k=0), model_id="m",
                     interval=1)
    assert t._grids["megastep_k"] == ((0,), 0)
    for _ in range(40):
        t.on_window("plain", 1.0, 1, 0.001)
    assert t.sched.megastep_k == 0 and t.moves > 0
    # Two ranks on one device (a card holding both shards) keep the grid.
    r = FakeRunner([])
    r.devices = [torch.device("cuda", 0)] * 2
    t = ta.AutoTuner(FakeScheduler(r), model_id="m")
    assert t._grids["megastep_k"][0] == (0, 1, 2, 4, 8, 16)


# ---------------------------------------------------------------- gossip


class _Points:
    def __init__(self):
        self.points = {}

    def record_operating_point(self, model_id, point):
        self.points[model_id] = ta.encode_point(point)

    def lookup_operating_point(self, model_id, max_age_s=0.0):
        return ta.decode_point(self.points.get(model_id, ""))


@settings(max_examples=60, deadline=None)
@given(point=st.dictionaries(st.sampled_from(list(ta.DIALS) + ["bogus"]),
                             st.integers(-5, 10_000)))
def test_points_encode_to_the_same_bytes(point):
    assert ta.encode_point(point) == ja.encode_point(point)
    enc = ta.encode_point(point)
    assert ta.decode_point(enc) == ja.decode_point(enc)
    for junk in ("not json", '["a"]', '{"megastep_k": "x"}', ""):
        assert ta.decode_point(junk) == ja.decode_point(junk)


@pytest.mark.parametrize("src,dst", [(tg, ja), (jg, ta)],
                         ids=["port_node_warms_jax", "jax_node_warms_port"])
def test_a_gossiped_point_warm_starts_the_other_packages_tuner(src, dst):
    node = src.GossipNode(SimpleNamespace(peer_id="w1"), peers=())
    node.record_operating_point("llama", {"megastep_k": 7,  # off grid: 8
                                          "step_token_budget": 10_000,
                                          "prefill_chunk": 64})
    v0 = node.state.get(src.TUNE_PREFIX + "llama").version
    node.record_operating_point("llama", {"megastep_k": 7,
                                          "step_token_budget": 10_000,
                                          "prefill_chunk": 64})
    assert node.state.get(src.TUNE_PREFIX + "llama").version == v0
    other = tg if src is jg else jg
    reader = other.GossipNode(SimpleNamespace(peer_id="w2"), peers=())
    for e in node.state.snapshot():  # the anti-entropy frame's entries
        reader.state.apply(other.Entry.from_dict(e.to_dict()))
    assert reader.lookup_operating_point("llama") == {
        "megastep_k": 7, "step_token_budget": 10_000, "prefill_chunk": 64}
    assert reader.lookup_operating_point("llama", max_age_s=1e-9) == {}
    sched = FakeScheduler(FakeRunner([]))
    t = dst.AutoTuner(sched, model_id="llama", gossip=reader, interval=4)
    t.on_window("plain", 1.0, 1, 0.001)
    assert t.warm_starts == 1
    assert sched.megastep_k == 8
    assert sched.runner.step_token_budget == t._grids["step_token_budget"][
        0][-1]
    assert t._last_good == t._snapshot()


# ---------------------------------------------------------------- config

FIELDS = {
    "autotune": ("CROWDLLAMA_TPU_AUTOTUNE", "true", None, ("--autotune",)),
    "autotune_interval": ("CROWDLLAMA_TPU_AUTOTUNE_INTERVAL", "5", 0,
                          ("--autotune-interval", "5")),
    "autotune_megastep_max": ("CROWDLLAMA_TPU_AUTOTUNE_MEGASTEP_MAX", "8",
                              -1, ("--autotune-megastep-max", "8")),
    "autotune_draft_max": ("CROWDLLAMA_TPU_AUTOTUNE_DRAFT_MAX", "3", 0,
                           ("--autotune-draft-max", "3")),
    "autotune_budget_max": ("CROWDLLAMA_TPU_AUTOTUNE_BUDGET_MAX", "512", 0,
                            ("--autotune-budget-max", "512")),
    "autotune_prefill_max": ("CROWDLLAMA_TPU_AUTOTUNE_PREFILL_MAX", "256",
                             63, ("--autotune-prefill-max", "256")),
    "autotune_depth_max": ("CROWDLLAMA_TPU_AUTOTUNE_DEPTH_MAX", "4", 0, ()),
}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_autotune_config_equals_the_jax_config(field, monkeypatch):
    var, value, bad, flag = FIELDS[field]
    t, j = tconfig.Configuration(), jconfig.Configuration()
    assert getattr(t, field) == getattr(j, field)
    monkeypatch.setenv(var, value)
    t = tconfig.Configuration.from_environment()
    j = jconfig.Configuration.from_environment()
    assert getattr(t, field) == getattr(j, field) != getattr(
        tconfig.Configuration(), field)
    monkeypatch.delenv(var)
    if bad is not None:
        with pytest.raises(ValueError) as te:
            tconfig.Configuration.from_environment(**{field: bad})
        with pytest.raises(ValueError) as je:
            jconfig.Configuration.from_environment(**{field: bad})
        assert str(te.value) == str(je.value)
    argv = ["start", "--worker-mode", *flag]
    t = tconfig.Configuration.from_flags(tcli.build_parser().parse_args(argv))
    j = jconfig.Configuration.from_flags(jcli.build_parser().parse_args(argv))
    assert getattr(t, field) == getattr(j, field)


# --------------------------------------------------------------- gateway


async def test_gateway_captures_a_backoff_with_its_dial_move():
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.obs.collector import FlightRecorder
    from crowdllama_tpu_torch.obs.slo import SloEngine

    gw = Gateway.__new__(Gateway)
    gw._flight_min_count = 30
    gw.slo = SloEngine()
    gw.obs = SimpleNamespace(trace=SimpleNamespace(get=lambda tid: None))
    gw._autotune_backoffs_seen = ta.BACKOFF_LOG.snapshot()[0]
    hist = SimpleNamespace(count=0, quantile=lambda q: 1e9)
    assert gw._flight_reasons("t0", hist, 0.01, 200) == []
    ta.BACKOFF_LOG.record({"model": "m", "dial": "megastep_k", "frm": 2,
                           "to": 4, "restored": {"megastep_k": 2},
                           "burn": 15.0})
    assert gw._flight_reasons("t1", hist, 0.01, 200) == ["autotune_backoff"]
    assert gw._flight_reasons("t2", hist, 0.01, 200) == []  # edge consumed

    async def collect(tid):
        return {"trace_id": tid, "spans": []}

    gw.flight = FlightRecorder(capacity=4)
    gw.collector = SimpleNamespace(collect=collect)
    gw._flight_inflight = 0
    gw._flight_max_inflight = 4
    gw._flight_tasks = set()
    gw._flight_capture("t1", ["autotune_backoff"])
    for _ in range(10):
        await asyncio.sleep(0)
    entry = gw.flight.get("t1")
    assert entry["reasons"] == ["autotune_backoff"]
    move = entry["trace"]["autotune_backoff"]
    assert (move["dial"], move["frm"], move["to"]) == ("megastep_k", 2, 4)


# ------------------------------------------------------------- scheduler


@pytest.fixture(scope="module")
def flat():
    from crowdllama_tpu.engine.weights import _flatten_params
    from crowdllama_tpu.models import transformer as JT
    from crowdllama_tpu.models.config import get_config as jget

    cfg = jget("tiny-test", max_context_length=MAX_SEQ)
    return _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(0),
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


def _reqs(mod, long=False):
    out = [mod.GenRequest(prompt_ids=[3, 1, 4, 1, 5], max_tokens=20, seed=7),
           mod.GenRequest(prompt_ids=[2, 7, 1, 8], max_tokens=16, seed=5)]
    if long:  # chunk-prefills through the ragged path: the fault site
        out.append(mod.GenRequest(prompt_ids=list(range(11, 211)),
                                  max_tokens=8, seed=9))
    return out


async def _drain(mod, sched, reqs):
    for r in reqs:
        await sched.submit(r)
    outs = []
    for r in reqs:
        toks = []
        while True:
            tok, reason = await asyncio.wait_for(r.out.get(), 120)
            if tok is mod.DONE:
                outs.append((toks, reason))
                break
            toks.append(tok)
    return outs


def _runner(pkg, flat, **kw):
    common = dict(max_slots=4, max_seq=MAX_SEQ, page_size=32,
                  step_token_budget=96, prefix_cache=False, **kw)
    if pkg == "jax":
        from crowdllama_tpu.engine.paged import PagedModelRunner
        from crowdllama_tpu.models.config import get_config as jget

        return PagedModelRunner(jget("tiny-test", max_context_length=MAX_SEQ),
                                params=_jparams(flat), dtype=jnp.float32,
                                mesh_spec="1", **common)
    from crowdllama_tpu_torch.engine.graphs import GraphCache
    from crowdllama_tpu_torch.engine.paged import PagedModelRunner
    from crowdllama_tpu_torch.engine.weights import params_from_numpy
    from crowdllama_tpu_torch.models.config import get_config
    from test_torch_megastep import fake_capture

    r = PagedModelRunner(get_config("tiny-test", max_context_length=MAX_SEQ),
                         params=params_from_numpy(flat), device="cpu",
                         **common)
    r._graphs = GraphCache(capture=fake_capture)
    return r


async def _serve(pkg, flat, tuned):
    """The JAX autotune test's workload: two streams, then the same two
    beside a 200-token prompt chunk-prefilled under a 350 ms delay at
    every ragged dispatch, then the two again.  Returns (streams, tuner,
    runner, megastep Ks dispatched)."""
    if pkg == "jax":
        from crowdllama_tpu.engine import scheduler as mod
        from crowdllama_tpu.testing import faults
    else:
        from crowdllama_tpu_torch.engine import scheduler as mod
        from crowdllama_tpu_torch.testing import faults
    runner = _runner(pkg, flat)
    runner.prefill_chunk = 64
    runner.ragged_chunk = 64
    ks = []
    if pkg == "torch":
        mega = runner.decode_megastep

        def counted(state, k, **kw):
            ks.append(k)
            return mega(state, k, **kw)

        runner.decode_megastep = counted
    sched = mod.Scheduler(runner, decode_chunk=4, ragged=True, megastep_k=2)
    tuner = None
    if tuned:
        # Burn windows of one: the delayed stretch is the fast-burn edge;
        # min_gain 1e6 reverts every trial.
        tuner = ta.AutoTuner(sched, model_id="tiny-test", interval=1,
                             bounds={"megastep_k": 4,
                                     "step_token_budget": 160,
                                     "prefill_chunk": 64},
                             decode_ms=30.0, burn_short=1, burn_long=1,
                             min_gain=1e6)
        sched.attach_autotuner(tuner)
    plan = faults.FaultPlan(seed=3, rules=[faults.FaultRule(
        site="scheduler.ragged_chunk", action="delay", delay_s=0.35,
        times=0)])
    sched.start()
    try:
        outs = await _drain(mod, sched, _reqs(mod))
        with faults.installed(plan):
            outs += await _drain(mod, sched, _reqs(mod, long=True))
        outs += await _drain(mod, sched, _reqs(mod))
    finally:
        await sched.stop()
    assert plan.log, "the ragged fault site never fired"
    return outs, tuner, runner, ks


async def test_tuned_scheduler_streams_equal_untuned_and_jax(flat):
    base, _, _, _ = await _serve("torch", flat, tuned=False)
    ref, _, _, _ = await _serve("jax", flat, tuned=False)
    b0 = ta.BACKOFF_LOG.snapshot()[0]
    tuned, tuner, runner, ks = await _serve("torch", flat, tuned=True)
    assert base == ref, "the port's untuned streams differ from JAX's"
    assert tuned == base, "the tuned streams differ from the untuned"
    d = tuner.describe()
    assert d["moves"] >= 3 and d["reverts"] >= 1 and d["backoffs"] >= 1, d
    total, last = ta.BACKOFF_LOG.snapshot()
    assert total >= b0 + 1 and last["model"] == "tiny-test"
    # A revert to a K with a graph replays it: one capture per K flown.
    graphs = runner._graphs
    assert graphs.captures == len(set(ks)) == len(graphs._graphs) >= 2, (
        graphs.captures, ks)
    g = tuner.gauges()
    assert g["autotune_moves_total"] == float(tuner.moves)
    assert g["autotune_dial|dial=megastep_k"] == float(
        tuner.sched.megastep_k)


async def test_engine_builds_the_tuner_from_its_config(flat):
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import params_from_numpy

    points = _Points()
    points.points["tiny-test"] = ta.encode_point({"prefill_chunk": 128})
    eng = TorchEngine(device="cpu", dtype=torch.float32, model="tiny-test",
                      params=params_from_numpy(flat),
                      max_context_length=MAX_SEQ, kv_page_size=32,
                      warmup=False, autotune=True, autotune_interval=1,
                      autotune_prefill_max=256, slo_decode_ms=50.0)
    eng.set_gossip(points)
    assert eng.obs_gauges()["autotune_moves_total"] == 0.0
    await eng.start()
    try:
        assert eng.scheduler._autotune is eng.autotuner
        assert eng.autotuner.burn.objective_ms == 50.0
        text = ""
        async for c in eng.generate("hello there", max_tokens=12):
            text += c.text
        d = eng.describe()["autotune"]
        assert d["warm_starts"] == 1 and d["moves"] >= 1, d
        g = eng.obs_gauges()
        assert g["autotune_moves_total"] == float(d["moves"])
        assert g["autotune_dial|dial=prefill_chunk"] == float(
            eng.runner.prefill_chunk)
    finally:
        await eng.stop()


def test_multi_engine_hands_gossip_to_every_child():
    from crowdllama_tpu_torch.engine.multi import MultiEngine

    m = MultiEngine(tconfig.Configuration(model="a,b"), device="cpu")
    node = object()
    m.set_gossip(node)
    assert all(e._gossip is node for e in m._engines.values())


# -------------------------------------------------------------- CLI worker


@pytest.mark.parametrize("autotune", [True, False])
async def test_a_tuning_worker_with_gateway_peers_joins_gossip(
        autotune, monkeypatch, tmp_path):
    """``start --worker-mode --autotune --gateway-peers``: the worker
    starts a GossipNode on the gateways and hands it to its engine;
    without ``--autotune`` it joins no gossip plane."""
    import crowdllama_tpu_torch.ipc.server as tipc
    import crowdllama_tpu_torch.peer.peer as tpeer

    got, started = {}, []

    class Stop(Exception):
        pass

    class Engine:
        models = ["m"]

        async def start(self):
            pass

        async def stop(self):
            pass

        def set_gossip(self, gossip):
            got["gossip"] = gossip

    class Peer:
        peer_id = "p"

        def __init__(self, *a, **kw):
            pass

        async def start(self):
            pass

        async def stop(self):
            pass

    class Node:
        def __init__(self, peer, peers=(), interval=2.0, **kw):
            self.peers, self.interval = list(peers), interval

        async def start(self):
            started.append(self)

        async def stop(self, save=False):
            pass

    class IPC:  # the last part run_node starts: stops the node here
        def __init__(self, *a, **kw):
            pass

        async def start(self):
            raise Stop

        async def stop(self):
            pass

    monkeypatch.setattr(tcli, "make_engine", lambda cfg: Engine())
    monkeypatch.setattr(tpeer, "Peer", Peer)
    monkeypatch.setattr(tg, "GossipNode", Node)
    monkeypatch.setattr(tipc, "IPCServer", IPC)
    cfg = tconfig.Configuration.from_environment(
        key_path=str(tmp_path / "k"), autotune=autotune,
        gateway_peers=["127.0.0.1:7001"], gossip_interval=0.5,
        ipc_socket=str(tmp_path / "s"))
    with pytest.raises(Stop):
        await tcli.run_node(cfg, worker_mode=True)
    if not autotune:
        assert got == {} and started == []
        return
    node = got["gossip"]
    assert started == [node] and node.peers == ["127.0.0.1:7001"]
    assert node.interval == 0.5
