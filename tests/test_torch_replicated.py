"""Leader-replicated serving across processes (the port's
``parallel/replicated.py``) against the JAX package's.

Two-process clusters on the CPU: process 0 runs a real engine
(``TorchEngine`` / ``JaxEngine``: warmup, scheduler, continuous batching)
whose runner broadcasts every device-touching call, process 1 replays
the frame stream (``run_follower``) until the engine's stop sends STOP.
Both packages load one checkpoint from ``tmp_path``: the permutation
weights of ``testing/modelgen.py`` with ``wo`` and ``w_down`` made live
(random at 0.3 / sqrt(fan_in * hidden), from a numpy seed), so the
attention and MLP sums, tp's cross-process reductions among them, reach
the logits.

- Streams: on contiguous "4x2" (dp across the processes, 4 CPU ranks a
  process), paged "1x2" (tp across them, one rank a process; prefix
  cache and embeddings too) and paged "1x2" with ngram and draft
  speculation, the port's greedy streams are token-identical to JAX's
  two-process cluster and to the port's one-process engine on the same
  mesh.  JAX's cluster runs once per mesh, in a module fixture.
- Faults, as JAX's ``tests/test_replicated.py``: a deterministic
  dispatch fault on both processes leaves the cluster serving; a
  follower-local failure terminates the follower; a ValueError is
  mirrored and replay continues; a mirrored failure recovers on INIT;
  PREFILL_ABORT drops the follower's job.  A follower that dies fails
  the leader's next collective at once instead of hanging it.
- Frames: for one recorded op sequence the port's frames (op, i32, f32,
  key words, prompt) equal JAX's ``_bcast`` payloads.
- The CLI: a follower started through ``start --worker-mode
  --dist-coordinator ...`` replays and exits 0 on STOP; consumer mode,
  ``--shard-count`` above 1 and a model list exit 2 with JAX's message.

Every subprocess has JAX's 240 s timeout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240

# name -> (Configuration fields, virtual devices a process, mesh ranks)
SCENARIOS = {
    "contig": (dict(max_batch_slots=4, max_context_length=128,
                    mesh_shape="4x2", decode_chunk=4, kv_layout="paged"),
               4),
    "paged": (dict(max_batch_slots=4, max_context_length=256,
                   mesh_shape="1x2", decode_chunk=4, kv_layout="paged",
                   kv_page_size=32), 1),
    "ngram": (dict(max_batch_slots=2, max_context_length=128,
                   mesh_shape="1x2", decode_chunk=2, kv_layout="paged",
                   kv_page_size=32, spec_decode="ngram"), 1),
    "draft": (dict(max_batch_slots=2, max_context_length=128,
                   mesh_shape="1x2", decode_chunk=2, kv_layout="paged",
                   kv_page_size=32, spec_decode="draft",
                   spec_draft_model="tiny-test"), 1),
}

# The leader's traffic: two concurrent greedy streams, then the first
# again (it must repeat), then a one-token request with another waiting
# behind it; the paged mesh adds a shared-prefix pair (the
# second must hit the prefix cache) and a batch of embeddings; the spec
# meshes a repetitive prompt the n-gram verifier accepts.
_TRAFFIC = textwrap.dedent("""
    import asyncio, contextvars, json

    _sink = contextvars.ContextVar("sink")

    class _Recorder:
        def __init__(self, tok):
            self._tok = tok

        def __getattr__(self, name):
            return getattr(self._tok, name)

        def stream_decoder(self):
            dec, ids = self._tok.stream_decoder(), _sink.get()

            class _Dec:
                def feed(self, token_id):
                    ids.append(int(token_id))
                    return dec.feed(token_id)

            return _Dec()

    async def traffic(eng, scenario):
        eng.tokenizer = _Recorder(eng.tokenizer)

        async def one(prompt, n):
            ids = []
            _sink.set(ids)
            chunks = [c async for c in eng.generate(
                prompt, max_tokens=n, temperature=0.0)]
            assert chunks[-1].done and chunks[-1].completion_tokens == n, \\
                chunks[-1]
            return ids

        out = {}
        if scenario in ("ngram", "draft"):
            out["abab"] = await one("ababababab", 8)
            again = await one("ababababab", 8)
            assert again == out["abab"], (again, out["abab"])
            return out
        out["a"], out["b"] = await asyncio.gather(one("alpha beta", 12),
                                                  one("gamma", 12))
        again = await one("alpha beta", 12)
        assert again == out["a"], (again, out["a"])
        # A request that ends at its first token while another waits: the
        # second takes the freed slot in the same admission pass, and the
        # first's release must not free it under the second.
        out["single"], out["after_single"] = await asyncio.gather(
            one("delta", 1), one("epsilon zeta", 10))
        if scenario == "paged":
            shared = "s" * 70
            out["first"] = await one(shared + " first tail", 6)
            runner = getattr(eng, "_runner", None) or eng.runner
            hits0 = runner.prefix_hits
            out["second"] = await one(shared + " second tail", 6)
            assert runner.prefix_hits > hits0, (hits0, runner.prefix_hits)
            vecs, _ = await eng.embed(["hello pod", "second text"])
            out["embed"] = [round(float(v), 2) for v in vecs[0][:4]]
        return out
""")

_CHILD = textwrap.dedent("""
    import os, sys, json
    coord, pid, package, scenario, ckpt, out = sys.argv[1:7]
    fields = json.loads(os.environ["SCENARIO_FIELDS"])
    ndev = int(os.environ["SCENARIO_DEVICES"])
    if package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={ndev}")
        import jax
        jax.config.update("jax_platforms", "cpu")
        from crowdllama_tpu.config import Configuration
        from crowdllama_tpu.parallel import multihost
        extra = {}
    else:
        import torch
        torch.set_num_threads(1)
        from crowdllama_tpu_torch.config import Configuration
        from crowdllama_tpu_torch.parallel import multihost
        extra = {"device": "cpu"}
    cfg = Configuration(dist_coordinator=coord, dist_num_processes=2,
                        dist_process_id=int(pid), model="tiny-test",
                        model_path=ckpt, **fields, **extra)
    assert multihost.initialize_from_config(cfg) is True
    assert multihost.process_count() == 2
    assert multihost.is_leader() == (pid == "0")
    exec(os.environ.get("CHILD_PATCH", ""))
    if multihost.is_leader():
        import asyncio
        exec(os.environ["TRAFFIC"])
        if package == "jax":
            from crowdllama_tpu.engine.engine import JaxEngine as Engine
        else:
            from crowdllama_tpu_torch.engine.engine import TorchEngine as Engine

        async def main():
            eng = Engine(cfg)
            await eng.start()
            try:
                res = await traffic(eng, scenario)
                if package == "torch":
                    res["mesh"] = eng.describe()["mesh"]
            finally:
                await eng.stop()
            with open(out, "w") as f:
                json.dump(res, f)
            print("LEADER_OK", flush=True)

        asyncio.run(main())
    else:
        if package == "jax":
            from crowdllama_tpu.parallel.replicated import run_follower
        else:
            from crowdllama_tpu_torch.parallel.replicated import run_follower
        run_follower(cfg)
        print("FOLLOWER_OK", flush=True)
""")


def _free_addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _cluster(tmp_path, package, scenario, ckpt, scripts=None, env=None):
    """Run a two-process cluster; returns (leader result or None, outputs,
    return codes).  ``scripts`` replaces a process's command line."""
    fields, ndev = SCENARIOS[scenario]
    coord = _free_addr()
    script = tmp_path / f"child_{package}_{scenario}.py"
    script.write_text(_CHILD)
    out = tmp_path / f"out_{package}_{scenario}.json"
    penv = {**os.environ, "PYTHONPATH": str(REPO),
            "SCENARIO_FIELDS": json.dumps(fields),
            "SCENARIO_DEVICES": str(ndev), "TRAFFIC": _TRAFFIC,
            **(env or {})}
    penv.pop("JAX_PLATFORMS", None)
    cmds = [[sys.executable, str(script), coord, str(i), package, scenario,
             ckpt, str(out)] for i in range(2)]
    for i, cmd in (scripts or {}).items():
        cmds[i] = cmd(coord)
    procs = [subprocess.Popen(cmd, cwd=REPO, env=penv,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=TIMEOUT)
            outs.append(o)
    finally:
        for p in procs:
            p.kill()
    res = json.loads(out.read_text()) if out.exists() else None
    return res, outs, [p.returncode for p in procs]


def _ok(outs, rcs):
    assert rcs[0] == 0, f"leader:\n{outs[0][-4000:]}"
    assert "LEADER_OK" in outs[0], outs[0][-2000:]
    assert rcs[1] == 0, f"follower:\n{outs[1][-4000:]}"
    assert "FOLLOWER_OK" in outs[1] or "stop after" in outs[1], \
        outs[1][-2000:]


def live_checkpoint(path) -> str:
    """Write the live permutation checkpoint both packages load into
    ``path``; returns it as a string."""
    import jax.numpy as jnp

    from crowdllama_tpu.engine.weights import _flatten_params, save_params
    from crowdllama_tpu.models.config import get_config as j_get_config
    from crowdllama_tpu.testing.modelgen import permutation_params

    jcfg = j_get_config("tiny-test", max_context_length=256)
    flat = {k: np.asarray(v, np.float32) for k, v in
            _flatten_params(permutation_params(jcfg)).items()}
    rng = np.random.default_rng(3)
    for name in ("layers/wo", "layers/w_down"):
        w = flat[name]
        flat[name] = (rng.standard_normal(w.shape) * (
            0.3 / np.sqrt(w.shape[-2] * jcfg.hidden_size))).astype(
                np.float32)
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, jnp.float32)
    return str(save_params(jcfg, tree, path,
                           {"note": "live permutation weights"}))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return live_checkpoint(tmp_path_factory.mktemp("live") / "ckpt")


@pytest.fixture(scope="module")
def jax_streams(ckpt, tmp_path_factory):
    """JAX's two-process cluster, once per mesh (lazily)."""
    cache: dict = {}

    def get(scenario):
        if scenario not in cache:
            tmp = tmp_path_factory.mktemp(f"jax_{scenario}")
            res, outs, rcs = _cluster(tmp, "jax", scenario, ckpt)
            _ok(outs, rcs)
            cache[scenario] = res
        return cache[scenario]

    return get


async def _one_process(ckpt, scenario):
    """The port's one-process engine on the same mesh (every rank a CPU
    rank of this process), under the same traffic."""
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    fields, _ = SCENARIOS[scenario]
    n = int(np.prod([int(a) for a in fields["mesh_shape"].split("x")]))
    ns: dict = {}
    exec(_TRAFFIC, ns)
    eng = TorchEngine(Configuration(model="tiny-test", model_path=ckpt,
                                    device="cpu", **fields),
                      devices=["cpu"] * n)
    await eng.start()
    try:
        return await ns["traffic"](eng, scenario)
    finally:
        await eng.stop()


@pytest.mark.parametrize("scenario", ["contig", "paged", "ngram", "draft"])
async def test_two_process_streams_match_jax_and_one_process(
        tmp_path, ckpt, jax_streams, scenario):
    res, outs, rcs = _cluster(tmp_path, "torch", scenario, ckpt)
    _ok(outs, rcs)
    mesh = res.pop("mesh")
    assert mesh["processes"] == 2 and mesh["frames"] == "gloo"
    # tp across the processes reduces over gloo (CPU ranks); dp alone
    # needs no device collective.
    assert mesh["device_collectives"] == (None if scenario == "contig"
                                          else "gloo")
    want = jax_streams(scenario)
    one = await _one_process(ckpt, scenario)
    embed = res.pop("embed", None)
    assert res == {k: v for k, v in want.items() if k != "embed"}
    assert res == {k: v for k, v in one.items() if k != "embed"}
    if embed is not None:
        np.testing.assert_allclose(embed, want["embed"], atol=0.02)
        assert embed == one["embed"]
    assert "awaiting leader recovery" not in outs[1]


_FAULT_PATCH = textwrap.dedent("""
    # A deterministic dispatch fault on BOTH processes: the first decode
    # chunk of exactly 5 steps raises.  The leader's recovery fails the
    # in-flight request, broadcasts INIT and keeps serving; the follower
    # survives the same error in lockstep.
    from crowdllama_tpu_torch.engine.runner import ModelRunner
    _orig = ModelRunner.decode_steps_device
    _fired = [False]
    def _faulty(self, state, num_steps=1):
        if num_steps == 5 and not _fired[0]:
            _fired[0] = True
            raise RuntimeError("injected dispatch fault")
        return _orig(self, state, num_steps)
    ModelRunner.decode_steps_device = _faulty
    cfg.decode_chunk = 5
    cfg.warmup = False
    if multihost.is_leader():
        import asyncio
        from crowdllama_tpu_torch.engine.engine import TorchEngine

        async def main():
            eng = TorchEngine(cfg)
            await eng.start()
            try:
                async def one(prompt):
                    return [c async for c in eng.generate(
                        prompt, max_tokens=8, temperature=0.0)]
                try:
                    await one("doomed request")
                    raise SystemExit("expected the injected fault")
                except RuntimeError as e:
                    assert "engine failure" in str(e), e
                second = await one("recovered request")
                assert second[-1].done and not (
                    second[-1].done_reason.startswith("error")), second[-1]
                assert second[-1].completion_tokens == 8
                print("LEADER_RECOVERED_OK", flush=True)
            finally:
                await eng.stop()

        asyncio.run(main())
        print("LEADER_OK", flush=True)
        sys.exit(0)
""")


def test_follower_survives_deterministic_dispatch_fault(tmp_path, ckpt):
    """A dispatch error that hits every process alike leaves the cluster
    serving: the leader's recovery (fail the requests, INIT) and the
    follower's handler stay frame-synchronized."""
    _res, outs, rcs = _cluster(tmp_path, "torch", "contig", ckpt,
                               env={"CHILD_PATCH": _FAULT_PATCH})
    _ok(outs, rcs)
    assert "LEADER_RECOVERED_OK" in outs[0], outs[0][-2000:]
    assert "awaiting leader recovery" in outs[1], outs[1][-2000:]


_DEATH_PATCH = textwrap.dedent("""
    # The follower dies at its first 3-step decode; the leader's next
    # collective must fail at once, not wait.
    cfg.decode_chunk = 3
    cfg.warmup = False
    if not multihost.is_leader():
        from crowdllama_tpu_torch.engine.paged import PagedModelRunner
        _orig = PagedModelRunner.decode_steps_device
        def _die(self, state, num_steps=1):
            if num_steps == 3:
                os._exit(17)
            return _orig(self, state, num_steps)
        PagedModelRunner.decode_steps_device = _die
    else:
        import asyncio, time
        from crowdllama_tpu_torch.engine.engine import TorchEngine

        async def main():
            eng = TorchEngine(cfg)
            await eng.start()
            t0 = time.monotonic()
            try:
                await asyncio.wait_for(
                    eng.generate("doomed", max_tokens=8).__anext__(), 120)
                async for _ in eng.generate("doomed", max_tokens=8):
                    pass
                raise SystemExit("the dead follower went unnoticed")
            except RuntimeError as e:
                print(f"LEADER_FAILED {time.monotonic() - t0:.1f}s {e}",
                      flush=True)
            try:
                await eng.stop()
            except RuntimeError:
                pass

        asyncio.run(main())
        print("LEADER_OK", flush=True)
        os._exit(0)
""")


def test_dead_follower_fails_the_leader_fast(tmp_path, ckpt):
    _res, outs, rcs = _cluster(tmp_path, "torch", "paged", ckpt,
                               env={"CHILD_PATCH": _DEATH_PATCH})
    assert rcs == [0, 17], (rcs, outs[0][-3000:], outs[1][-3000:])
    line = next(ln for ln in outs[0].splitlines()
                if ln.startswith("LEADER_FAILED"))
    assert float(line.split()[1][:-1]) < 60, line


def test_cli_follower_replays_and_exits_on_stop(tmp_path, ckpt):
    """Process 1 is the CLI (``start --worker-mode --dist-coordinator``):
    it runs ``run_follower`` and returns 0 on the leader's STOP."""
    fields, _ = SCENARIOS["paged"]
    env = {"CROWDLLAMA_TPU_MAX_BATCH_SLOTS": str(fields["max_batch_slots"]),
           "CROWDLLAMA_TPU_MAX_CONTEXT_LENGTH": str(
               fields["max_context_length"]),
           "CROWDLLAMA_TPU_DECODE_CHUNK": str(fields["decode_chunk"])}

    def cli(coord):
        return [sys.executable, "-m", "crowdllama_tpu_torch.cli.main",
                "start", "--worker-mode", "--device", "cpu",
                "--model", "tiny-test", "--model-path", ckpt,
                "--mesh", "1x2", "--kv-layout", "paged",
                "--kv-page-size", "32", "--dist-coordinator", coord,
                "--dist-num-processes", "2", "--dist-process-id", "1"]

    res, outs, rcs = _cluster(tmp_path, "torch", "paged", ckpt,
                              scripts={1: cli}, env=env)
    _ok(outs, rcs)
    assert "follower 1: stop after" in outs[1], outs[1][-2000:]
    assert res["a"] and res["second"]


@pytest.mark.parametrize("argv", [
    [],
    ["--worker-mode", "--shard-count", "2"],
    ["--worker-mode", "--model", "tiny-test,tiny-test-moe"],
], ids=["consumer", "shard-count", "model-list"])
def test_cli_refuses_shapes_multi_process_cannot_serve(argv, capsys,
                                                      app_logger_restored):
    from crowdllama_tpu.cli.main import main as j_main
    from crowdllama_tpu_torch.cli.main import main

    common = ["start", "--dist-coordinator", "127.0.0.1:1",
              "--dist-num-processes", "2", "--dist-process-id", "0"]
    assert main(common + argv + ["--device", "cpu"]) == 2
    ours = capsys.readouterr().err
    assert j_main(common + argv) == 2
    theirs = capsys.readouterr().err
    assert "--dist-coordinator serves exactly one" in ours
    assert ours.strip().splitlines()[-1] == theirs.strip().splitlines()[-1]


@pytest.fixture
def app_logger_restored():
    """``start`` builds the "crowdllama" app logger (its own handler, no
    propagation), in both packages; put it back for later tests."""
    import logging

    log = logging.getLogger("crowdllama")
    saved = (log.level, log.propagate, list(log.handlers))
    yield
    log.setLevel(saved[0])
    log.propagate = saved[1]
    log.handlers[:] = saved[2]


# ------------------------------------------------- the scripted follower

def _frame(op, ints=()):
    from crowdllama_tpu_torch.parallel import replicated as R

    f = {"op": np.int32(op), "i32": np.zeros((R._NI,), np.int32),
         "f32": np.zeros((R._NF,), np.float32),
         "key": np.zeros((R._NK,), np.uint32)}
    f["i32"][: len(ints)] = list(ints)
    return f


def _scripted_follower(monkeypatch, frames):
    """run_follower against a scripted frame stream (no process group):
    ``broadcast_from_leader`` pops the next scripted frame."""
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.parallel import multihost, replicated

    script = list(frames)

    def fake_broadcast(_template):
        assert script, "follower consumed frames past the script"
        return script.pop(0)

    monkeypatch.setattr(multihost, "broadcast_from_leader", fake_broadcast)
    cfg = Configuration(model="tiny-test", max_batch_slots=2,
                        max_context_length=128, kv_layout="contiguous",
                        mesh_shape="1", device="cpu")
    return replicated.run_follower(cfg, devices=["cpu"],
                                   dtype=torch.float32)


def _inject_one_decode_fault(monkeypatch, exc):
    from crowdllama_tpu_torch.engine.runner import ModelRunner

    real = ModelRunner.decode_steps_device
    fired = {"n": 0}

    def flaky(self, state, num_steps=1):
        fired["n"] += 1
        if fired["n"] == 1:
            raise exc
        return real(self, state, num_steps)

    monkeypatch.setattr(ModelRunner, "decode_steps_device", flaky)


def test_follower_local_failure_fails_loudly(monkeypatch):
    """A failure the leader did not mirror (no INIT follows) means this
    process's shards parted from the leader's: the follower terminates
    instead of replaying further frames."""
    from crowdllama_tpu_torch.parallel import replicated as R

    _inject_one_decode_fault(monkeypatch,
                             RuntimeError("injected follower-local fault"))
    with pytest.raises(RuntimeError, match="diverged"):
        _scripted_follower(monkeypatch, [
            _frame(R._OP_INIT, (0,)),
            _frame(R._OP_DECODE, (1,)),   # fails on the follower only
            _frame(R._OP_DECODE, (1,)),   # the leader went on: divergence
        ])


def test_follower_continues_after_request_level_valueerror(monkeypatch):
    """A ValueError is the request-level error the leader catches without
    an INIT: the follower treats it as mirrored and keeps replaying."""
    from crowdllama_tpu_torch.parallel import replicated as R

    _inject_one_decode_fault(monkeypatch,
                             ValueError("injected request-level error"))
    _scripted_follower(monkeypatch, [
        _frame(R._OP_INIT, (0,)),
        _frame(R._OP_DECODE, (1,)),   # ValueError: mirrored, survivable
        _frame(R._OP_DECODE, (1,)),   # the leader went on, so do we
        _frame(R._OP_STOP),
    ])


def test_follower_recovers_when_leader_mirrors_failure(monkeypatch):
    """When the frame after a local failure IS the leader's recovery
    INIT, the follower rebuilds state and keeps replaying."""
    from crowdllama_tpu_torch.parallel import replicated as R

    _inject_one_decode_fault(monkeypatch, RuntimeError("injected fault"))
    _scripted_follower(monkeypatch, [
        _frame(R._OP_INIT, (0,)),
        _frame(R._OP_DECODE, (1,)),   # fails (injected)
        _frame(R._OP_INIT, (0,)),     # the leader's recovery
        _frame(R._OP_DECODE, (1,)),   # poison cleared: runs
        _frame(R._OP_STOP),
    ])


def test_prefill_abort_frame_drops_follower_job(monkeypatch):
    """PREFILL_ABORT broadcasts from the leader proxy and clears the
    follower's chunked-prefill job."""
    from crowdllama_tpu_torch.parallel import multihost
    from crowdllama_tpu_torch.parallel import replicated as R

    sent = []
    monkeypatch.setattr(multihost, "broadcast_from_leader", sent.append)
    R.ReplicatedRunner(inner=object()).prefill_abort(job=object())
    assert len(sent) == 1 and int(sent[0]["op"]) == R._OP_PREFILL_ABORT
    job_sentinel = object()
    state, pending, job = R._apply(
        runner=None, state="st", pending=None, job=job_sentinel,
        op=R._OP_PREFILL_ABORT, frame=sent[0],
        i32=sent[0]["i32"], f32=sent[0]["f32"])
    assert job is None and state == "st"


# ------------------------------------------------------------------ frames

class _StubInner:
    """A runner stand-in: every surface returns something plausible."""

    max_slots = 4
    slot_rows = slice(0, 4)

    def init_state(self, *a, **k):
        return "state"

    def prefill(self, *a, **k):
        return 7, ["k"], ["v"], 3

    def prefill_begin(self, *a, **k):
        return "job"

    def prefill_step(self, *a, **k):
        return True

    def prefill_finish(self, *a, **k):
        return 7, ["k"], ["v"], 3

    def insert(self, state, *a, **k):
        return state

    def release(self, state, slot):
        return state

    def decode_steps_device(self, state, num_steps=1):
        return np.zeros((num_steps, self.max_slots), np.int32), state

    def pre_decode_check(self, steps):
        return []

    def warmup_ctx_prefill(self, state):
        return None

    def embed_prompts(self, prompts):
        return np.zeros((len(prompts), 4), np.float32)


def _drive(R, key, key2):
    r = R.ReplicatedRunner(_StubInner())
    st = r.init_state(0)
    r.prefill([1, 2, 3], 0.7, 0.9, key, state=st, top_k=5,
              repeat_penalty=1.1)
    st = r.insert(st, 1, ["k"], ["v"], 3, 42, 0.7, 0.9,
                  prompt_tokens=[1, 2, 3], slot_key=key2, top_k=5,
                  repeat_penalty=1.1)
    r.pre_decode_check(4)
    r.decode_steps_device(st, 4)
    job = r.prefill_begin(list(range(40, 75)), state=st)
    r.prefill_step(job)
    r.prefill_finish(job, 0.0, 1.0, key, top_k=0, repeat_penalty=1.0)
    st = r.insert(st, 2, ["k"], ["v"], 35, 9, 0.0, 1.0,
                  prompt_tokens=list(range(40, 75)), slot_key=None)
    r.prefill_abort(job)
    r.warmup_ctx_prefill(st)
    r.embed_prompts([[1, 2], [3]])
    r.release(st, 1)
    r.shutdown()


def test_frames_equal_jax_bcast_payloads(monkeypatch):
    import jax

    from crowdllama_tpu.parallel import multihost as j_multihost
    from crowdllama_tpu.parallel import replicated as j_R
    from crowdllama_tpu_torch.engine import prng
    from crowdllama_tpu_torch.parallel import multihost
    from crowdllama_tpu_torch.parallel import replicated as R

    ours, theirs = [], []
    monkeypatch.setattr(multihost, "broadcast_from_leader",
                        lambda v: ours.append(v) or v)
    monkeypatch.setattr(j_multihost, "broadcast_from_leader",
                        lambda v: theirs.append(v) or v)
    _drive(R, prng.PRNGKey(7), prng.fold_in(prng.PRNGKey(9), 1))
    _drive(j_R, jax.random.PRNGKey(7),
           jax.random.fold_in(jax.random.PRNGKey(9), 1))
    assert len(ours) == len(theirs) > 15
    for a, b in zip(ours, theirs):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_stateless_prefill_replays_without_state(monkeypatch):
    """A leader prefill made without a state (the engine's warmup) says
    so in its frame, and the follower runs it without one too, so it
    makes no prefix lookup the leader skipped; with a state the frame is
    JAX's (slot 6 stays 0) and the follower passes its own."""
    from crowdllama_tpu_torch.parallel import multihost
    from crowdllama_tpu_torch.parallel import replicated as R

    sent = []
    monkeypatch.setattr(multihost, "broadcast_from_leader",
                        lambda v: sent.append(v) or v)
    r = R.ReplicatedRunner(_StubInner())
    r.prefill([1, 2, 3], 0.0, 1.0, None, state=None)
    r.prefill([1, 2, 3], 0.0, 1.0, None, state="st")
    r.prefill_begin([4, 5], state=None)
    r.prefill_begin([4, 5], state="st")
    heads = [f for f in sent if isinstance(f, dict)]
    assert [int(f["i32"][R._NO_STATE_SLOT]) for f in heads] == [1, 0, 1, 0]

    seen = []

    class _Rec(_StubInner):
        def prefill(self, *a, state=None, **k):
            seen.append(state)
            return super().prefill(*a, **k)

        def prefill_begin(self, prompt, state=None):
            seen.append(state)
            return "job"

    prompts = iter(f for f in sent if not isinstance(f, dict))
    for f in heads:
        frame = {**f, "prompt": next(prompts)}
        R._apply(_Rec(), "live", None, None, int(f["op"]), frame,
                 f["i32"], f["f32"])
    assert seen == [None, "live", None, "live"]


def test_unframed_calls_refuse_loudly():
    """Calls JAX would run on the leader alone (parting the processes)
    refuse, and the gates the scheduler reads are False."""
    from crowdllama_tpu_torch.parallel import replicated as R

    r = R.ReplicatedRunner(_StubInner())
    for name in ("export_pages", "import_pages", "decode_steps_hosted"):
        with pytest.raises(NotImplementedError, match="item 18"):
            getattr(r, name)(None, None)
    with pytest.raises(NotImplementedError, match="item 18"):
        r.set_draft_len(1)
    assert not (r.supports_remote_draft or r.supports_adaptive_draft
                or r.supports_ragged or r.supports_megastep)
    assert r.defer_release
