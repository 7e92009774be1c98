"""The port's autoscaler (``crowdllama_tpu_torch/swarm/autoscale.py``)
against the JAX package's: ``AutoscaleController`` gives the same
decisions on the same numpy-seeded sample streams and configurations,
``pick_drain_candidate`` the same victims, ``simulate`` the same records
on the same load profiles (``main`` writes the same JSON), and
``parse_gauges`` reads the port gateway's and the port worker's
``/metrics`` as the JAX parser reads them.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from crowdllama_tpu import swarm as jswarm
from crowdllama_tpu_torch import swarm as tswarm
from crowdllama_tpu_torch.config import Configuration, Intervals
from crowdllama_tpu_torch.engine.engine import FakeEngine
from crowdllama_tpu_torch.gateway.gateway import Gateway
from crowdllama_tpu_torch.net import http
from crowdllama_tpu_torch.net.discovery import new_host_and_dht
from crowdllama_tpu_torch.obs.http import ObsServer
from crowdllama_tpu_torch.peer.peer import Peer
from crowdllama_tpu_torch.swarm import autoscale as tautoscale
from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey


def _configs(rng):
    """(port, JAX) configurations with the same random watermarks."""
    kw = dict(high_occupancy=float(rng.uniform(0.5, 0.95)),
              low_occupancy=float(rng.uniform(0.05, 0.45)),
              high_pending=float(rng.uniform(1, 8)),
              up_ticks=int(rng.integers(1, 4)),
              down_ticks=int(rng.integers(1, 6)),
              cooldown_ticks=int(rng.integers(0, 6)),
              min_workers=int(rng.integers(1, 3)),
              max_workers=int(rng.integers(3, 12)))
    return tswarm.AutoscaleConfig(**kw), jswarm.AutoscaleConfig(**kw)


@pytest.mark.parametrize("seed", range(8))
def test_controller_decisions_equal_the_jax_controllers(seed):
    rng = np.random.default_rng(seed)
    tcfg, jcfg = _configs(rng)
    tctl = tswarm.AutoscaleController(tcfg)
    jctl = jswarm.AutoscaleController(jcfg)
    actions = set()
    for tick in range(400):
        # Regimes of 25 ticks: mostly hot, mostly cold, or anything.
        regime = (tick // 25) % 3
        occ = (rng.uniform(0.7, 1) if regime == 0 else
               rng.uniform(0, 0.4) if regime == 1 else rng.uniform(0, 1))
        s = dict(workers=int(rng.integers(0, 14)),
                 pending_depth=(float(rng.choice([0.0, 0.5]))
                                if regime == 1 else
                                float(rng.choice([0.0, 0.5, 2.0, 9.0]))),
                 batch_occupancy=float(occ),
                 shed=(0.0 if regime == 1 else
                       float(rng.choice([0.0, 0.0, 0.0, 2.0]))))
        td = tctl.observe(tswarm.Sample(**s))
        jd = jctl.observe(jswarm.Sample(**s))
        assert (td.action, td.reason) == (jd.action, jd.reason)
        actions.add(td.action)
    assert actions >= {"hold", "drain", "undrain"}


@pytest.mark.parametrize("seed", range(4))
def test_drain_candidate_equals_the_jax_pick(seed):
    rng = np.random.default_rng(seed)
    gauges = {f"w{i:02d}": {"pending_depth": float(rng.integers(0, 3)),
                            "batch_occupancy": float(rng.choice([0, .5]))}
              for i in range(int(rng.integers(1, 9)))}
    assert tswarm.pick_drain_candidate(gauges) == \
        jswarm.pick_drain_candidate(gauges) != ""
    assert tswarm.pick_drain_candidate({}) == ""


@pytest.mark.parametrize("kw", [
    {},
    {"n_ticks": 60, "total_workers": 4, "start_active": 2},
    {"n_ticks": 90, "base_load": 4.0, "peak_load": 40.0,
     "per_worker_capacity": 3.0},
])
def test_simulation_equals_the_jax_simulation(kw):
    t, j = tswarm.simulate(**kw), jswarm.simulate(**kw)
    assert t.to_json() == j.to_json()
    assert t.summary["drains"] + t.summary["undrains"] >= 1


def test_main_writes_the_jax_artifact(tmp_path):
    from crowdllama_tpu.swarm import autoscale as jautoscale

    tautoscale.main(["--ticks", "50", "--out", str(tmp_path / "t.json")])
    jautoscale.main(["--ticks", "50", "--out", str(tmp_path / "j.json")])
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_parse_gauges_of_text_equals_the_jax_parser():
    text = "\n".join([
        "# TYPE crowdllama_engine_pending_depth gauge",
        "crowdllama_engine_pending_depth 3",
        "crowdllama_engine_batch_occupancy 0.625",
        "crowdllama_gateway_shed_total 7",
        'crowdllama_slo_burn_rate{objective="ttft",window="5m"} 2.5',
        'crowdllama_slo_burn_rate{objective="ttft",window="1h"} 0.5',
        "crowdllama_engine_pending_depth_other 99"])
    assert tswarm.parse_gauges(text) == jswarm.parse_gauges(text) == {
        "pending_depth": 3.0, "batch_occupancy": 0.625, "shed_total": 7.0,
        "slo_burn_rate": 2.5}
    assert tswarm.parse_gauges("") == jswarm.parse_gauges("")


def test_parse_gauges_reads_the_port_gateway_and_worker():
    """The port gateway (with SLO objectives, after an admission-cap shed)
    and a port worker's ObsServer: their /metrics parse to what the JAX
    parser reads from the same text."""
    async def go():
        boot, _ = await new_host_and_dht(Ed25519PrivateKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"

        def cfg():
            return Configuration(listen_host="127.0.0.1",
                                 bootstrap_peers=[addr], relay_mode="off",
                                 intervals=Intervals.default())

        worker = Peer(Ed25519PrivateKey.generate(), cfg(),
                      engine=FakeEngine(models=["tiny-test"], delay=0.3),
                      worker_mode=True)
        consumer = Peer(Ed25519PrivateKey.generate(), cfg(),
                        engine=FakeEngine(models=[]), worker_mode=False)
        gateway = Gateway(consumer, port=0, host="127.0.0.1",
                          admission_max_inflight=1, slo_ttft_ms=1.0)
        obs = ObsServer(worker, port=0)
        started = []
        try:
            for part in (worker, consumer, gateway, obs):
                await part.start()
                started.append(part)
            while consumer.peer_manager.find_best_worker("tiny-test") is None:
                await asyncio.sleep(0.1)
            body = {"model": "tiny-test", "stream": True,
                    "messages": [{"role": "user", "content": "hi"}]}

            async def chat():
                async with http.request(
                        "POST", f"http://127.0.0.1:{gateway.port}/api/chat",
                        json=body) as r:
                    await r.read()
                    return r.status

            statuses = await asyncio.gather(chat(), chat(), chat())
            out = {}
            for name, port in (("gateway", gateway.port),
                               ("worker", obs.port)):
                async with http.request(
                        "GET", f"http://127.0.0.1:{port}/metrics") as r:
                    out[name] = await r.text()
            return statuses, out
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()

    statuses, texts = asyncio.run(asyncio.wait_for(go(), 90))
    assert sorted(statuses).count(503) >= 1 and 200 in statuses
    gw = tswarm.parse_gauges(texts["gateway"])
    assert gw == jswarm.parse_gauges(texts["gateway"])
    assert gw["shed_total"] >= 1 and "slo_burn_rate" in gw
    wk = tswarm.parse_gauges(texts["worker"])
    assert wk == jswarm.parse_gauges(texts["worker"])
    assert set(wk) == {"pending_depth", "batch_occupancy", "shed_total"}
    assert "crowdllama_engine_pending_depth" in texts["worker"]


def test_config_fields_equal_the_jax_config():
    t = {f.name: f.default for f in dataclasses.fields(tswarm.AutoscaleConfig)}
    j = {f.name: f.default for f in dataclasses.fields(jswarm.AutoscaleConfig)}
    assert t == j
