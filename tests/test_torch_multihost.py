"""Multi-process mesh support (the port's ``parallel/multihost.py``)
against the JAX package's.

- Lockstep: a 2-process x 4-CPU-rank cluster forms one "4x2" mesh (dp
  across the processes); the leader's prompt is broadcast, both
  processes prefill, insert and decode 6 steps, and the gathered tokens
  are the same in both processes, equal JAX's 2-process x 4-virtual-
  device cluster on the same checkpoint and the port's one-process
  runner on the same mesh.
- tp across processes: on "1x2" over two processes of one CPU rank, the
  fp32 prefill logits equal the one-process tp=2 runner's bit for bit
  (the cross-process sum is the one addition the one-process loop
  makes), and so do the decode tokens.
- The toolkit without a group: ``initialize_from_config`` is off without
  a coordinator and refuses to guess the process count or id;
  ``process_count`` is 1, ``broadcast_from_leader`` and
  ``process_allgather`` pass through.
- The mesh layout: process ``p`` holds ranks ``[p*L, (p+1)*L)``; "4x2"
  over 2 x 4 splits along dp, "1x2" over 2 x 1 puts one tp rank in
  each process; the runner refuses an sp, pp or ep group across
  processes naming item 8.2b.
- The device-collective rule: NCCL only where every process holds its
  own CUDA devices, gloo where processes share one or sit on the CPU.
- Each process's decode rows, as the readback places them, are where
  that process's runner runs them; a per-rank list that lost its
  cross-process comm is refused at the reduction.
- ``logutil.new_app_logger`` formats a record as JAX's does.
"""

import json
import logging
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

_CHILD = textwrap.dedent("""
    import os, sys, json
    coord, pid, package, mode, ckpt, out = sys.argv[1:7]
    ndev = 4 if mode == "lockstep" else 1
    mesh = "4x2" if mode == "lockstep" else "1x2"
    if package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={ndev}")
        import jax
        jax.config.update("jax_platforms", "cpu")
        from crowdllama_tpu.config import Configuration
        from crowdllama_tpu.parallel import multihost
    else:
        import torch
        torch.set_num_threads(1)
        from crowdllama_tpu_torch.config import Configuration
        from crowdllama_tpu_torch.parallel import multihost
    import numpy as np

    cfg = Configuration(dist_coordinator=coord, dist_num_processes=2,
                        dist_process_id=int(pid))
    assert multihost.initialize_from_config(cfg) is True
    if package == "torch":
        assert multihost.initialize_from_config(cfg) is True  # tolerated
    assert multihost.process_count() == 2
    assert multihost.is_leader() == (pid == "0")
    # The admission decision (the prompt) is made on process 0 and
    # broadcast; every process then runs the same calls on the mesh.
    mine = np.asarray([list(range(7, 19)) if pid == "0" else [0] * 12],
                      np.int32)
    prompt = [int(t) for t in
              np.asarray(multihost.broadcast_from_leader(mine))[0]]
    if package == "jax":
        from jax.experimental import multihost_utils
        from crowdllama_tpu.engine.runner import ModelRunner
        from crowdllama_tpu.engine.weights import load_or_init_params
        from crowdllama_tpu.models.config import get_config
        mcfg = get_config("tiny-test", max_context_length=64)
        runner = ModelRunner(mcfg, params=load_or_init_params(mcfg, ckpt),
                             max_slots=4, max_seq=64, mesh_spec=mesh)
        state = runner.init_state()
        key = jax.random.PRNGKey(0)
        first, ks, vs, plen = runner.prefill(prompt, 0.0, 1.0, key,
                                             state=state)
        state = runner.insert(state, 0, ks, vs, plen, first, 0.0, 1.0)
        toks, state = runner.decode_steps_device(state, 6)
        toks = np.asarray(multihost_utils.process_allgather(toks,
                                                            tiled=True))
        res = {"tokens": toks[:, 0].tolist(), "first": int(first)}
    else:
        from crowdllama_tpu_torch.engine.weights import load_or_init_params
        from crowdllama_tpu_torch.models import transformer as T
        from crowdllama_tpu_torch.models.config import get_config
        from crowdllama_tpu_torch.parallel.replicated import gather_tokens
        mcfg = get_config("tiny-test", max_context_length=64)
        if mode == "lockstep":
            from crowdllama_tpu_torch.engine.runner import ModelRunner as R
            dtype = torch.bfloat16
        else:
            from crowdllama_tpu_torch.engine.paged import PagedModelRunner as R
            dtype = torch.float32
        params = load_or_init_params(mcfg, ckpt, dtype=dtype)
        kw = {} if mode == "lockstep" else {"page_size": 16}
        runner = R(mcfg, params=params, max_slots=4, max_seq=64,
                   mesh_shape=mesh, devices=["cpu"] * ndev, dtype=dtype, **kw)
        state = runner.init_state()
        first, ks, vs, plen = runner.prefill(prompt, 0.0, 1.0, None,
                                             state=state)
        state = runner.insert(state, 0, ks, vs, plen, first, 0.0, 1.0)
        toks, state = runner.decode_steps_device(state, 6)
        toks = gather_tokens(runner, toks)
        res = {"tokens": toks[:, 0].tolist(), "first": int(first),
               "local_dp": runner.local_dp, "local_tp": runner.local_tp,
               "slot_rows": [runner.slot_rows.start, runner.slot_rows.stop],
               "comm": None if runner.tp_comm is None
               else runner.tp_comm.backend}
        if mode == "tp":
            n = len(prompt)
            pos = torch.arange(n)[None]
            logits, _, _ = T.prefill(runner.params, mcfg,
                                     torch.tensor([prompt]), pos)
            np.save(out + ".logits.npy", logits.numpy())
            res["stats"] = multihost.stats()
    multihost.barrier("done")
    with open(out, "w") as f:
        json.dump(res, f)
    print("MH_OK", flush=True)
""")


def _free_addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _cluster(tmp_path, package, mode, ckpt):
    coord = _free_addr()
    script = tmp_path / f"child_{package}_{mode}.py"
    script.write_text(_CHILD)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("JAX_PLATFORMS", None)
    outs = [tmp_path / f"out_{package}_{mode}_{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(i), package, mode, ckpt,
         str(outs[i])], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=TIMEOUT)
            logs.append(o)
    finally:
        for p in procs:
            p.kill()
    for i, (p, o) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
        assert "MH_OK" in o, o[-2000:]
    return [json.loads(o.read_text()) for o in outs], outs


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The live permutation checkpoint (``wo`` and ``w_down`` random at
    0.3 / sqrt(fan_in * hidden)) both packages load."""
    from test_torch_replicated import live_checkpoint

    return live_checkpoint(tmp_path_factory.mktemp("live") / "ckpt")


def _one_process(ckpt, mesh, n, runner_cls, dtype, **kw):
    from crowdllama_tpu_torch.engine.weights import load_or_init_params
    from crowdllama_tpu_torch.models.config import get_config

    mcfg = get_config("tiny-test", max_context_length=64)
    r = runner_cls(mcfg, params=load_or_init_params(mcfg, ckpt, dtype=dtype),
                   max_slots=4, max_seq=64, mesh_shape=mesh,
                   devices=["cpu"] * n, dtype=dtype, **kw)
    prompt = list(range(7, 19))
    st = r.init_state()
    first, ks, vs, plen = r.prefill(prompt, 0.0, 1.0, None, state=st)
    st = r.insert(st, 0, ks, vs, plen, first, 0.0, 1.0)
    toks, _ = r.decode_steps(st, 6)
    return r, mcfg, prompt, {"tokens": toks[:, 0].tolist(),
                             "first": int(first)}


def test_two_process_global_mesh_lockstep(tmp_path, ckpt):
    from crowdllama_tpu_torch.engine.runner import ModelRunner

    (p0, p1), _ = _cluster(tmp_path, "torch", "lockstep", ckpt)
    # dp splits over the processes: process 0 holds dp 0-1 x tp 0-1.
    assert (p0["local_dp"], p1["local_dp"]) == ([0, 1], [2, 3])
    assert p0["local_tp"] == p1["local_tp"] == [0, 1]
    assert (p0["slot_rows"], p1["slot_rows"]) == ([0, 2], [2, 4])
    assert p0["comm"] is None  # dp needs no device collective
    assert p0["tokens"] == p1["tokens"] and p0["first"] == p1["first"]
    (j0, j1), _ = _cluster(tmp_path, "jax", "lockstep", ckpt)
    assert j0 == j1
    assert {k: p0[k] for k in j0} == j0
    _r, _c, _p, one = _one_process(ckpt, "4x2", 8, ModelRunner,
                                   torch.bfloat16)
    assert {k: p0[k] for k in one} == one


def test_tp_across_processes_is_bit_identical_to_one_process(tmp_path,
                                                             ckpt):
    from crowdllama_tpu_torch.engine.paged import PagedModelRunner
    from crowdllama_tpu_torch.models import transformer as T

    (p0, p1), outs = _cluster(tmp_path, "torch", "tp", ckpt)
    assert (p0["local_tp"], p1["local_tp"]) == ([0], [1])
    assert p0["comm"] == p1["comm"] == "gloo"
    assert p0["stats"]["device_calls"] > 0
    assert p0["stats"]["host_copies"] == 0
    r, mcfg, prompt, one = _one_process(ckpt, "1x2", 2, PagedModelRunner,
                                        torch.float32, page_size=16)
    assert {k: p0[k] for k in one} == one == {k: p1[k] for k in one}
    want, _, _ = T.prefill(r.params, mcfg, torch.tensor([prompt]),
                           torch.arange(len(prompt))[None])
    for o in outs:
        got = np.load(str(o) + ".logits.npy")
        np.testing.assert_array_equal(got, want.numpy())


# -------------------------------------------------------- without a group

def test_toolkit_without_a_process_group(monkeypatch):
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.parallel import multihost

    assert multihost.initialize_from_config(Configuration()) is False
    assert multihost.process_count() == 1 and multihost.is_leader()
    x = {"op": np.int32(3), "i32": np.arange(8, dtype=np.int32)}
    assert multihost.broadcast_from_leader(x) is x
    np.testing.assert_array_equal(
        multihost.process_allgather(np.arange(6).reshape(2, 3)),
        np.arange(6).reshape(2, 3))
    multihost.barrier()
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        multihost.initialize_from_config(Configuration(
            dist_coordinator="127.0.0.1:1", dist_process_id=0))
    with pytest.raises(ValueError, match="RANK"):
        multihost.initialize_from_config(Configuration(
            dist_coordinator="127.0.0.1:1", dist_num_processes=2))


def test_config_fields_env_and_flags_match_jax(monkeypatch):
    import argparse
    import dataclasses

    from crowdllama_tpu.config import Configuration as JConfiguration
    from crowdllama_tpu_torch.config import Configuration

    ours = {f.name for f in dataclasses.fields(Configuration)}
    theirs = {f.name for f in dataclasses.fields(JConfiguration)}
    assert ours - theirs == {"device"} and not theirs - ours
    monkeypatch.setenv("CROWDLLAMA_TPU_DIST_COORDINATOR", "h:1")
    monkeypatch.setenv("CROWDLLAMA_TPU_DIST_NUM_PROCESSES", "4")
    monkeypatch.setenv("CROWDLLAMA_TPU_DIST_PROCESS_ID", "2")
    for cls in (Configuration, JConfiguration):
        c = cls.from_environment()
        assert (c.dist_coordinator, c.dist_num_processes,
                c.dist_process_id) == ("h:1", 4, 2)
    p = argparse.ArgumentParser()
    Configuration.add_flags(p)
    args = p.parse_args(["--dist-coordinator", "x:2",
                         "--dist-num-processes", "3",
                         "--dist-process-id", "1"])
    c = Configuration.from_flags(args)
    assert (c.dist_coordinator, c.dist_num_processes,
            c.dist_process_id) == ("x:2", 3, 1)


@pytest.mark.parametrize("spec,n,local", [
    ("4x2", 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    ("1x2", 2, [[0], [1]]),
    ("2x2", 4, [[0], [1], [2], [3]]),
])
def test_mesh_places_each_process_on_its_row_major_ranks(spec, n, local):
    from crowdllama_tpu_torch.parallel.mesh import build_mesh

    size = len(local[0])
    for p in range(n):
        m = build_mesh(spec, ["cpu"] * size, (n, p))
        assert list(m.local_ranks) == local[p] and m.local_size == size
        assert all(m.process_of(r) == p for r in local[p])
        assert m.rank_device(local[p][0]) == torch.device("cpu")
        other = local[(p + 1) % n][0]
        with pytest.raises(ValueError, match="lives in process"):
            m.rank_device(other)
    with pytest.raises(ValueError, match="does not split"):
        build_mesh("3", ["cpu"] * 3, (2, 0))


@pytest.mark.parametrize("spec,local", [
    ("1x2x1x1x2", 2),   # a pp group across the processes
    ("1x1x2x1x1", 1),   # sp
    ("1x2x1", 1),       # ep
    ("3x2", 3),         # a tp group split unevenly (ranks 2, 3)
])
def test_runner_refuses_groups_across_processes(monkeypatch, spec, local):
    from crowdllama_tpu_torch.engine.runner import ModelRunner
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    model = "tiny-test-moe" if spec == "1x2x1" else "tiny-test"
    cfg = get_config(model, max_context_length=64)
    with pytest.raises(ValueError, match="item 8.2b"):
        ModelRunner(cfg, max_slots=2, max_seq=64, mesh_shape=spec,
                    devices=["cpu"] * local, dtype=torch.float32)


@pytest.mark.parametrize("spec,local", [("4x2", 4), ("2x1", 1),
                                        ("4x1", 2)])
def test_process_slot_rows_follow_each_process_placement(monkeypatch, spec,
                                                         local):
    """The decode readback places process ``p``'s rows where process
    ``p``'s own runner runs them (dp across the processes)."""
    from crowdllama_tpu_torch.engine.runner import ModelRunner
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.parallel import multihost

    cfg = get_config("tiny-test", max_context_length=64)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    runners = []
    for p in range(2):
        monkeypatch.setattr(multihost, "process_index", lambda p=p: p)
        runners.append(ModelRunner(cfg, max_slots=8, max_seq=64,
                                   mesh_shape=spec, devices=["cpu"] * local,
                                   dtype=torch.float32))
    rows = [r.slot_rows for r in runners]
    assert rows[0].stop == rows[1].start and rows[1].stop == 8
    for r in runners:
        assert [r.process_slot_rows(p) for p in range(2)] == rows


def test_plain_tp_list_refused_while_a_group_spans_processes():
    """A per-rank list that lost its cross-process comm fails loudly at
    the reduction instead of returning a partial sum; a list stated whole
    (a draft beside the split model) still reduces."""
    from crowdllama_tpu_torch.models import transformer as T
    from crowdllama_tpu_torch.models.config import get_config
    from crowdllama_tpu_torch.parallel.sharding import TPGroup

    cfg = get_config("tiny-test", max_context_length=64)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    tokens = torch.tensor([[1, 2, 3]])
    want = T._embed([params], cfg, tokens)
    split = TPGroup([params], comm=object())
    with pytest.raises(RuntimeError, match="cross-process sum"):
        T._embed([params], cfg, tokens)
    with pytest.raises(RuntimeError, match="cross-process sum"):
        T._unembed([params], cfg, want)
    torch.testing.assert_close(T._embed(TPGroup([params]), cfg, tokens),
                               want)
    del split
    torch.testing.assert_close(T._embed([params], cfg, tokens), want)


def test_device_backend_rule(monkeypatch):
    from crowdllama_tpu_torch.parallel import multihost

    def run(devs_by_process, mine=0):
        multihost._BACKEND.clear()
        ids = {"cpu": -1, "cuda:0": 11, "cuda:1": 22}
        monkeypatch.setattr(multihost, "_device_id",
                            lambda d: ids[str(d)] if d.index is not None
                            or d.type == "cpu" else ids[f"{d.type}:0"])
        monkeypatch.setattr(
            multihost, "process_allgather",
            lambda x, tiled=True: np.stack(
                [np.array([[ids[d] for d in devs]], np.int64)
                 for devs in devs_by_process]))
        return multihost.device_backend(devs_by_process[mine])

    assert run([["cuda:0"], ["cuda:1"]]) == "nccl"
    assert run([["cuda:0"], ["cuda:0"]]) == "gloo"     # one shared card
    assert run([["cpu"], ["cpu"]]) == "gloo"
    multihost._BACKEND.clear()


def test_process_devices_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.factory import process_devices
    from crowdllama_tpu_torch.parallel import multihost

    assert process_devices(Configuration(mesh_shape="1x2")) is None
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    assert process_devices(Configuration(mesh_shape="4x2"),
                           "cpu") == ["cpu"] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            process_devices(Configuration(mesh_shape="1x2"))


def test_app_logger_formats_records_as_jax(capsys):
    from crowdllama_tpu.logutil import new_app_logger as j_new
    from crowdllama_tpu_torch.logutil import new_app_logger

    rec = logging.LogRecord("crowdllama.x", logging.WARNING, __file__, 1,
                            "hello %s", ("pod",), None)
    rec.created = 0.0
    lines = []
    for make, app in ((new_app_logger, "t-ours"), (j_new, "t-theirs")):
        log = make(app, verbose=False)
        assert log.level == logging.INFO and not log.propagate
        assert make(app, verbose=True).level == logging.DEBUG
        (handler,) = log.handlers
        lines.append(handler.formatter.format(rec).replace(app, "APP"))
        log.handlers.clear()
    assert lines[0] == lines[1]
    assert "[APP] crowdllama.x: hello pod" in lines[0]
