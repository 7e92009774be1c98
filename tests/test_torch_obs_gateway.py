"""The gateway's obs plane and the consumer's CLI, against the JAX
package's; and a torch-only swarm in a process of its own.

- ``obs/slo.py`` (``BurnRateTracker``, ``SloEngine``) against the JAX
  module on the same observations and fake clocks, after
  ``tests/test_observatory.py``'s scenarios; ``render_top``,
  ``merge_snapshots``, ``stitch`` and ``render_waterfall`` against the
  JAX functions on the same inputs.
- One topology (``asyncio.wait_for`` bounds it): a JAX DHT bootstrap
  node, a port worker (``FakeEngine``) with its ``ObsServer``, a JAX
  consumer with its ``Gateway`` and the port's consumer with its
  ``Gateway``.  A streamed chat through each gateway, then each one's
  stitched ``/debug/trace/{id}``: the same node labels and spans.  A JAX
  worker (``FakeEngine``, with the JAX ``ObsServer``) joins: the two
  gateways' ``/metrics`` carry the same families (``crowdllama_native_*``
  included), and their ``/metrics/cluster`` the same
  families and ``worker`` labels.  The two ``ObsServer``s answer
  ``/metrics``, ``/debug/trace`` and ``POST /drain`` alike.  The port
  CLI's ``network-status``, ``top``, ``trace`` and ``run`` against the
  port gateway print what the JAX CLI's print against the JAX gateway.
- A torch-only swarm in a subprocess: the port's DHT node, a worker on a
  CPU ``TorchEngine``, a consumer and its gateway; one ``/api/chat``
  from ``http.client``.  Afterwards no ``crowdllama_tpu``, ``jax`` or
  ``aiohttp`` module is loaded there.
- ``start --worker-mode --worker-metrics-port`` in a subprocess serves
  the worker's ``ObsServer`` and exits 0 on SIGTERM.
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import pytest

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu.cli import main as jcli  # noqa: E402
from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.engine.engine import FakeEngine as JFake  # noqa: E402
from crowdllama_tpu.gateway.gateway import Gateway as JGateway  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.obs import cluster as jcluster  # noqa: E402
from crowdllama_tpu.obs import collector as jcollector  # noqa: E402
from crowdllama_tpu.obs import slo as jslo  # noqa: E402
from crowdllama_tpu.obs.http import ObsServer as JObsServer  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.cli import main as tcli  # noqa: E402
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.engine.engine import FakeEngine  # noqa: E402
from crowdllama_tpu_torch.gateway.gateway import Gateway  # noqa: E402
from crowdllama_tpu_torch.obs import cluster as tcluster  # noqa: E402
from crowdllama_tpu_torch.obs import collector as tcollector  # noqa: E402
from crowdllama_tpu_torch.obs import slo as tslo  # noqa: E402
from crowdllama_tpu_torch.obs.http import ObsServer  # noqa: E402
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 90.0
NATIVE = {"crowdllama_native_enabled", "crowdllama_native_fallbacks_total"}
CHAT = {"model": "tiny-test", "stream": True,
        "messages": [{"role": "user", "content": "trace me please"}]}


# ------------------------------------------------------- SLO parity


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _good(obs, clk):
    for _ in range(50):
        yield obs(0.05)
        clk.t += 1.0


def _bad_fraction(obs, clk):
    for i in range(20):
        yield obs(0.5 if i < 2 else 0.05)
        clk.t += 1.0


def _windows_roll(obs, clk):
    for _ in range(10):
        yield obs(1.0)
        clk.t += 1.0
    clk.t += 301.0
    yield "step"
    clk.t += 3600.0
    yield obs(0.05)


def _fast_then_recover(obs, clk):
    for _ in range(10):
        yield obs(1.0)
        clk.t += 1.0
    yield "step"
    clk.t += 301.0
    for _ in range(200):
        yield obs(0.05)
        clk.t += 1.0


def _two_episodes(obs, clk):
    for _ in range(10):
        yield obs(1.0)
        clk.t += 1.0
    yield "step"
    clk.t += 4000.0
    yield obs(0.05)
    for _ in range(10):
        yield obs(1.0)
        clk.t += 1.0


SCENARIOS = {"good": _good, "bad_fraction": _bad_fraction,
             "windows_roll": _windows_roll,
             "fast_then_recover": _fast_then_recover,
             "two_episodes": _two_episodes}


def _trace_tracker(mod, scenario):
    clk = _Clock()
    t = mod.BurnRateTracker("ttft", objective_ms=100.0, budget=0.05,
                            clock=clk)
    return [(v, t.burn_rates(), t.in_fast_burn(), t.good_total,
             t.bad_total, len(t._cells))
            for v in SCENARIOS[scenario](t.observe, clk)]


def _trace_engine(mod, scenario, objectives):
    clk = _Clock()
    eng = mod.SloEngine(**objectives, clock=clk)

    def obs(seconds):
        return (eng.observe_ttft(seconds), eng.observe_decode(seconds))

    return [(v, eng.enabled, eng.fast_burn(), eng.fast_burn_episodes_total,
             eng.expose())
            for v in SCENARIOS[scenario](obs, clk)]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_burn_rate_tracker_equals_the_jax_one(scenario):
    got = _trace_tracker(tslo, scenario)
    assert got and got == _trace_tracker(jslo, scenario)


@pytest.mark.parametrize("objectives", [
    {"ttft_ms": 100.0}, {"decode_ms": 300.0},
    {"ttft_ms": 100.0, "decode_ms": 50.0}, {}],
    ids=["ttft", "decode", "both", "disabled"])
@pytest.mark.parametrize("scenario", ["two_episodes", "bad_fraction"])
def test_slo_engine_equals_the_jax_one(scenario, objectives):
    got = _trace_engine(tslo, scenario, objectives)
    assert got == _trace_engine(jslo, scenario, objectives)


# ------------------------------------- render_top, merge, stitch parity

TOP_TEXT = "\n".join([
    "# TYPE crowdllama_cluster_workers_total gauge",
    "crowdllama_cluster_workers_total 2",
    "crowdllama_cluster_workers_scraped 2",
    "crowdllama_cluster_tokens_per_second 123.5",
    "crowdllama_cluster_batch_occupancy 0.5",
    "crowdllama_cluster_kv_cache_utilization 0.25",
    "crowdllama_cluster_inflight 3",
    'crowdllama_worker_load{peer="aaaa"} 0.4',
    'crowdllama_worker_healthy{peer="aaaa"} 1',
    'crowdllama_worker_throughput_tokens_per_sec{peer="aaaa"} 100',
    'crowdllama_worker_healthy{peer="bbbb"} 0',
    'crowdllama_engine_batch_occupancy{worker="aaaa"} 0.75',
    'crowdllama_engine_pending_depth{worker="aaaa"} 2',
    'crowdllama_engine_duty_cycle{worker="aaaa",dispatch="megastep"} 0.93',
    'crowdllama_engine_duty_cycle{worker="aaaa",dispatch="plain"} 0.1',
])
TOP_DIALS = "\n".join([
    'crowdllama_worker_healthy{peer="cccc"} 1',
    'crowdllama_autotune_dial{worker="cccc",dial="megastep_k"} 8',
    'crowdllama_autotune_dial{worker="cccc",dial="draft_k"} 2',
    'crowdllama_autotune_moves_total{worker="cccc"} 5',
    'crowdllama_engine_kv_cache_utilization{worker="cccc"} 0.5',
    'crowdllama_engine_active_slots{worker="cccc"} 3',
    "garbage line", 'crowdllama_x{worker="cccc"} notanumber',
])


@pytest.mark.parametrize("text", [TOP_TEXT, "", TOP_DIALS],
                         ids=["joined", "empty", "dials"])
def test_render_top_equals_the_jax_one(text):
    assert tcli.render_top(text) == jcli.render_top(text)


SNAPSHOTS = [
    ("aaaa", "worker:aaaa", "\n".join([
        "# TYPE crowdllama_engine_active_slots gauge",
        "crowdllama_engine_active_slots 2",
        "# TYPE crowdllama_ttft_seconds histogram",
        'crowdllama_ttft_seconds_bucket{le="0.1"} 3 # {trace_id="t"} 0.05',
        "crowdllama_ttft_seconds_sum 0.2", "crowdllama_ttft_seconds_count 3",
        "untyped_sample 1"])),
    ("bbbb", "worker:bbbb", "\n".join([
        "# TYPE crowdllama_engine_active_slots counter",
        "crowdllama_engine_active_slots 5"])),
]


def test_merge_snapshots_equals_the_jax_one():
    got = tcluster.merge_snapshots(SNAPSHOTS)
    assert got and got == jcluster.merge_snapshots(SNAPSHOTS)


ROOT_FRAG = {"trace_id": "t1", "started_at": 100.0, "total_us": 5000.0,
             "done": True, "meta": {"model": "m"},
             "spans": [{"name": "route", "start_us": 0.0, "dur_us": 10.0,
                        "parent": "gateway"},
                       {"name": "io_wait", "start_us": 10.0,
                        "dur_us": 4000.0, "parent": "nowhere"}]}
FRAGS = [{"node": "worker:aaaa", "started_at": 100.001, "total_us": 3000.0,
          "spans": [{"name": "prefill", "start_us": 5.0, "dur_us": 900.0,
                     "parent": "gateway", "meta": {"steps": 1}},
                    {"name": "decode_step", "start_us": 905.0,
                     "dur_us": 2000.0, "parent": "prefill"}]},
         {"node": "worker:bbbb", "started_at": 99.0, "total_us": 9000.0,
          "spans": []}]


@pytest.mark.parametrize("root", [ROOT_FRAG, None], ids=["root", "no_root"])
def test_stitch_and_waterfall_equal_the_jax_ones(root):
    got = tcollector.stitch("t1", root, FRAGS)
    want = jcollector.stitch("t1", root, FRAGS)
    assert got == want
    assert tcollector.render_waterfall(got) == \
        jcollector.render_waterfall(want)


def test_flight_recorder_equals_the_jax_one():
    rings = []
    for mod in (tcollector, jcollector):
        fr = mod.FlightRecorder(capacity=2)
        for i in range(4):
            fr.capture(f"t{i}", ["b", "a", "a"], {"i": i})
        fr.capture("t3", ["z"], {"again": True})
        fr.capture("", ["x"], {})
        snap = fr.snapshot()
        for e in snap["traces"]:
            e.pop("captured_at")
        rings.append(snap)
    assert rings[0] == rings[1]


# ----------------------------------------------------------- topology


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def _worker_labels(text: str) -> set[str]:
    return {ln.split('worker="', 1)[1].split('"', 1)[0]
            for ln in text.splitlines() if 'worker="' in ln}


async def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def _get(s, url: str):
    async with s.get(url) as r:
        return r.status, await r.text()


async def _chat_trace(s, base: str, gw) -> tuple[str, list]:
    """A streamed chat and the trace id the gateway minted for it."""
    before = {t["trace_id"] for t in gw.obs.trace.snapshot()["traces"]}
    async with s.post(f"{base}/api/chat", json=CHAT) as r:
        assert r.status == 200
        lines = [json.loads(x) for x in (await r.text()).splitlines()]
    (tid,) = [t["trace_id"] for t in gw.obs.trace.snapshot()["traces"]
              if t["trace_id"] not in before]
    return tid, lines


async def _cli(fn, *args) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = await fn(*args)
    return rc, buf.getvalue()


async def _topology() -> dict:
    iv = JIntervals.default()
    boot, _ = await new_host_and_dht(JKey.generate(), listen_host="127.0.0.1")
    addr = f"127.0.0.1:{boot.listen_port}"
    node = dict(listen_host="127.0.0.1", bootstrap_peers=[addr])
    tworker = TPeer(TKey.generate(), TConf(device="cpu", **node),
                    FakeEngine(models=["tiny-test"]))
    tobs = ObsServer(tworker)
    jcons = JPeer(JKey.generate(), JConf(intervals=iv, **node),
                  engine=JFake(models=[]), worker_mode=False)
    tcons = TPeer(TKey.generate(), TConf(**node), FakeEngine(models=[]),
                  worker_mode=False)
    jgw = JGateway(jcons, port=0, host="127.0.0.1")
    tgw = Gateway(tcons, port=0, host="127.0.0.1")
    jworker = JPeer(JKey.generate(), JConf(intervals=iv, **node),
                    engine=JFake(models=["tiny-test"]), worker_mode=True)
    jobs = JObsServer(jworker)
    started = []
    out: dict = {}
    try:
        for part in (tworker, tobs, jcons, tcons, jgw, tgw):
            await part.start()
            started.append(part)
        gws = {"jax": (jgw, f"http://127.0.0.1:{jgw._runner.addresses[0][1]}"),
               "port": (tgw, f"http://127.0.0.1:{tgw.port}")}
        for cons in (jcons, tcons):
            await _wait(lambda: tworker.peer_id in {
                p.peer_id for p in cons.peer_manager.get_healthy_peers()},
                "the port worker")
        async with aiohttp.ClientSession() as s:
            # Stitched traces while the port worker is the only worker.
            out["stitched"], out["chat"] = {}, {}
            for k, (gw, base) in gws.items():
                tid, out["chat"][k] = await _chat_trace(s, base, gw)
                status, text = await _get(s, f"{base}/debug/trace/{tid}")
                out["stitched"][k] = (status, json.loads(text))
            out["missing_trace"] = {
                k: (await _get(s, f"{base}/debug/trace/nope"))[0]
                for k, (gw, base) in gws.items()}
            for part in (jworker, jobs):
                await part.start()
                started.append(part)
            for cons in (jcons, tcons):
                await _wait(lambda: jworker.peer_id in {
                    p.peer_id for p in cons.peer_manager.get_healthy_peers()},
                    "the JAX worker")
                await cons.peer_manager.perform_health_checks()
            out["metrics"], out["cluster"] = {}, {}
            for k, (gw, base) in gws.items():
                out["metrics"][k] = await _get(s, f"{base}/metrics")
                out["cluster"][k] = await _get(s, f"{base}/metrics/cluster")
                out["flight"] = await _get(s, f"{base}/debug/flightrecorder")
                out.setdefault("profile", {})[k] = (await _get(
                    s, f"{base}/debug/profile?seconds=0.1"))[0]
            # The CLIs, each against its own package's gateway.
            out["cli"] = {}
            for k, mod in (("jax", jcli), ("port", tcli)):
                base = gws[k][1]
                tid = out["stitched"][k][1]["trace_id"]
                out["cli"][k] = {
                    "status": await _cli(mod._network_status, base),
                    "top": await _cli(mod._top, types.SimpleNamespace(
                        gateway=base, watch=0.0)),
                    "trace": await _cli(mod._trace, types.SimpleNamespace(
                        gateway=base, trace_id=tid)),
                    "run": await _cli(mod._run_chat, types.SimpleNamespace(
                        gateway=base, model="tiny-test", prompt="hi there",
                        temperature=0.0, top_p=1.0, max_tokens=4)),
                    "unreachable": await _cli(mod._network_status,
                                              "http://127.0.0.1:9")}
            # The two workers' ObsServers.
            out["obs"] = {}
            for k, srv, peer in (("port", tobs, tworker),
                                 ("jax", jobs, jworker)):
                base = f"http://127.0.0.1:{srv.port}"
                rec = peer.obs.trace.snapshot()["traces"]
                tid = rec[-1]["trace_id"] if rec else ""
                o = {"metrics": await _get(s, f"{base}/metrics"),
                     "trace": await _get(
                         s, f"{base}/debug/trace?trace_id={tid}&limit=1"),
                     "trace_all": await _get(s, f"{base}/debug/trace"),
                     "tid": tid}
                for i in range(2):
                    async with s.post(f"{base}/drain") as r:
                        o[f"drain{i}"] = (r.status, await r.json())
                out["obs"][k] = o
        out["ids"] = {"port": tworker.peer_id, "jax": jworker.peer_id}
    finally:
        for part in reversed(started):
            await part.stop()
        await boot.close()
    return out


@pytest.fixture(scope="module")
def swarm(tmp_path_factory):
    return asyncio.run(asyncio.wait_for(_topology(), DEADLINE))


def test_metric_families_equal_the_jax_gateways_but_native(swarm):
    (ts, tt), (js, jt) = swarm["metrics"]["port"], swarm["metrics"]["jax"]
    assert ts == js == 200
    t, j = _families(tt), _families(jt)
    assert j - t == set()
    assert t - j == set()
    assert NATIVE <= t
    assert {"crowdllama_gateway_ttfb_seconds",
            "crowdllama_gateway_requests_total"} <= t


def test_cluster_scrape_holds_the_same_worker_labels(swarm):
    (ts, tt), (js, jt) = swarm["cluster"]["port"], swarm["cluster"]["jax"]
    assert ts == js == 200
    labels = {swarm["ids"]["port"][:16], swarm["ids"]["jax"][:16]}
    assert _worker_labels(tt) == _worker_labels(jt) == labels
    assert _families(tt) == _families(jt)
    assert "crowdllama_cluster_workers_scraped 2" in tt


def test_stitched_trace_holds_the_same_nodes(swarm):
    (ts, t), (js, j) = (swarm["stitched"]["port"],
                        swarm["stitched"]["jax"])
    assert ts == js == 200
    node = f"worker:{swarm['ids']['port'][:8]}"
    assert t["nodes"] == j["nodes"] == ["gateway", node]
    names = [{(sp["node"], sp["name"], sp["parent"]) for sp in x["spans"]}
             for x in (t, j)]
    assert names[0] == names[1]
    assert ("gateway", "route", "gateway") in names[0]
    assert (node, "prefill", node) in names[0]
    assert swarm["missing_trace"] == {"jax": 404, "port": 404}


def test_profile_is_gated_on_the_profile_dir(swarm):
    assert swarm["profile"] == {"jax": 501, "port": 501}


def test_cli_prints_what_the_jax_cli_prints(swarm):
    t, j = swarm["cli"]["port"], swarm["cli"]["jax"]
    for k in ("status", "top", "trace", "run", "unreachable"):
        assert t[k][0] == j[k][0], k
    # network-status: only the gateway's URL and its peer id differ.
    strip = [[ln for ln in x["status"][1].splitlines()
              if not ln.startswith(("gateway:", "peer id:"))]
             for x in (t, j)]
    assert strip[0] == strip[1] and "[healthy]" in strip[0][1]
    assert t["top"][1] == j["top"][1]
    assert t["run"][1] == j["run"][1] and t["run"][1].strip()
    # The waterfall: the same rows, whatever their times and order.
    rows = [sorted(ln.split("|")[0] for ln in x["trace"][1].splitlines()[1:])
            for x in (t, j)]
    assert rows[0] == rows[1] and len(rows[0]) > 4


def test_obs_servers_answer_alike(swarm):
    t, j = swarm["obs"]["port"], swarm["obs"]["jax"]
    assert t["metrics"][0] == j["metrics"][0] == 200
    assert _families(j["metrics"][1]) == _families(t["metrics"][1])
    assert NATIVE <= _families(t["metrics"][1])
    assert t["trace"][0] == j["trace"][0] == 200
    assert [x["trace_id"] for x in json.loads(t["trace"][1])["traces"]] \
        == [t["tid"]]
    assert set(json.loads(t["trace_all"][1])) == set(
        json.loads(j["trace_all"][1]))
    for i, already in ((0, False), (1, True)):
        assert t[f"drain{i}"] == j[f"drain{i}"] == (200, {
            "draining": True, "already_draining": already,
            "migrated_streams": 0})


# ------------------------------------------ a torch-only swarm, alone

SOLO = textwrap.dedent("""
    import asyncio, http.client, json, sys, time
    import torch
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.engine.engine import FakeEngine, TorchEngine
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.net.discovery import new_host_and_dht
    from crowdllama_tpu_torch.peer.peer import Peer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey as K

    def chat(port):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/api/chat", json.dumps({
            "model": "tiny-test", "stream": True,
            "messages": [{"role": "user", "content": "hello"}],
            "options": {"num_predict": 6}}),
            {"Content-Type": "application/json"})
        r = c.getresponse()
        body = r.read().decode()
        c.close()
        return r.status, r.getheader("Content-Type"), body

    async def main():
        boot, _ = await new_host_and_dht(K.generate(),
                                         listen_host="127.0.0.1")
        node = dict(listen_host="127.0.0.1",
                    bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
        eng = TorchEngine(device="cpu", dtype=torch.float32,
                          model="tiny-test", max_context_length=256,
                          kv_page_size=16, warmup=False)
        worker = Peer(K.generate(), Configuration(device="cpu", **node),
                      eng)
        cons = Peer(K.generate(), Configuration(**node),
                    FakeEngine(models=[]), worker_mode=False)
        gw = Gateway(cons, port=0, host="127.0.0.1")
        parts = [eng, worker, cons, gw]
        for p in parts:
            await p.start()
        try:
            t0 = time.monotonic()
            while worker.peer_id not in {
                    p.peer_id for p in cons.peer_manager.get_healthy_peers()}:
                if time.monotonic() - t0 > 30:
                    raise SystemExit("the worker was not discovered")
                await asyncio.sleep(0.05)
            status, ctype, body = await asyncio.to_thread(chat, gw.port)
        finally:
            for p in reversed(parts):
                await p.stop()
            await boot.close()
        lines = [json.loads(x) for x in body.splitlines()]
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "aiohttp",
                                               "crowdllama_tpu"))
        print(json.dumps({"status": status, "ctype": ctype, "lines": lines,
                          "worker": worker.peer_id, "loaded": loaded}))

    asyncio.run(asyncio.wait_for(main(), 90))
""")


def test_torch_only_swarm_in_a_subprocess(tmp_path):
    env = dict(os.environ, CROWDLLAMA_TPU_TEST_MODE="1",
               PYTHONPATH=str(ROOT), HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", SOLO], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert (got["status"], got["ctype"]) == (200, "application/x-ndjson")
    last = got["lines"][-1]
    assert last["done"] and last["eval_count"] == 6
    assert last["worker_id"] == got["worker"]


def test_cli_worker_serves_its_obs_server(tmp_path):
    """``start --worker-mode --worker-metrics-port P`` serves the
    worker's ``ObsServer``: /metrics with its families, POST /drain, and
    a SIGTERM exit 0."""
    import http.client
    import signal
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, CROWDLLAMA_TPU_TEST_MODE="1",
               PYTHONPATH=str(ROOT), HOME=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "crowdllama_tpu_torch.cli.main", "start",
         "--worker-mode", "--engine", "fake", "--model", "tiny-test",
         "--key-path", str(tmp_path), "--worker-metrics-port", str(port)],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)

    def call(method, path):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            c.request(method, path)
            r = c.getresponse()
            return r.status, r.read().decode()
        finally:
            c.close()

    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, text = call("GET", "/metrics")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        drain = call("POST", "/drain")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert status == 200
    assert {"crowdllama_ttft_seconds", "crowdllama_native_enabled",
            "crowdllama_host_streams_total"} <= _families(text)
    assert drain == (200, json.dumps({"draining": True,
                                      "already_draining": False,
                                      "migrated_streams": 0}))
    assert rc == 0, proc.stderr.read()[-2000:]
