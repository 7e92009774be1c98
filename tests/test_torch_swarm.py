"""A torch worker in a JAX swarm: the JAX DHT bootstrap node, the JAX
consumer ``Peer`` and its ``Gateway`` (aiohttp), a port worker (``Peer``
over ``TorchEngine`` on the CPU) and a JAX worker (``JaxEngine``), both
on ``params_from_numpy`` of one ``testing/modelgen.py`` permutation
checkpoint, as ``tests/test_torch_handle.py`` builds them.

One topology serves the module (``asyncio.wait_for`` bounds it, so a
hang fails these tests, not the suite's clock):

1. the port worker alone: ``/api/chat`` greedy and seeded (temperature
   0.8, seed 1234), each streamed and not, and ``/api/embed``;
   ``/api/health`` lists it healthy;
2. the JAX worker joins; a seeded stream of 24 tokens goes to the port
   worker (the higher throughput score) and a fault plan drains the port
   worker at its third chunk: the gateway fails the stream over to the
   JAX worker, and the text equals the undisturbed stream's;
3. the same requests as in 1, now served by the JAX worker.

The two workers' replies are equal field for field but ``worker_id``,
timestamps and durations (embedding values within 1e-5, as
``test_torch_handle.py`` holds the engines), and the port's Resource
JSON has the JAX package's key set.
"""

import asyncio
import json
import time

import pytest

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_handle import COMMON, _perm  # noqa: E402

from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.core.resource import Resource as JResource  # noqa: E402
from crowdllama_tpu.engine.engine import FakeEngine as JFake  # noqa: E402
from crowdllama_tpu.engine.engine import JaxEngine  # noqa: E402
from crowdllama_tpu.gateway.gateway import Gateway  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.weights import (  # noqa: E402
    params_from_numpy,
)
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.testing import faults  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

DEADLINE = 240.0
EMBED_ATOL = 1e-5
MSGS = [{"role": "user", "content": "the quick brown fox"}]
SEEDED = {"temperature": 0.8, "seed": 1234}
REQUESTS = {
    "greedy": ({"messages": MSGS, "options": {"num_predict": 10}}, False),
    "greedy_stream": ({"messages": MSGS, "options": {"num_predict": 10}},
                      True),
    "seeded": ({"messages": MSGS,
                "options": {"num_predict": 12, **SEEDED}}, False),
    "seeded_stream": ({"messages": MSGS,
                       "options": {"num_predict": 12, **SEEDED}}, True),
}
LONG = {"messages": [{"role": "user", "content": "tell a long story"}],
        "options": {"num_predict": 24, **SEEDED}}
EMBED = {"input": ["alpha", "a longer text to embed " * 3]}
SKIP = ("worker_id", "created_at", "total_duration")


async def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def _chat(s, base: str, body: dict, stream: bool) -> list[dict]:
    body = dict(body, model="tiny-test", stream=stream)
    async with s.post(f"{base}/api/chat", json=body) as r:
        assert r.status == 200, await r.text()
        return [json.loads(line) for line in (await r.text()).splitlines()]


async def _serve_all(s, base: str) -> dict:
    out = {name: await _chat(s, base, body, stream)
           for name, (body, stream) in REQUESTS.items()}
    async with s.post(f"{base}/api/embed",
                      json=dict(EMBED, model="tiny-test")) as r:
        assert r.status == 200, await r.text()
        out["embed"] = [await r.json()]
    return out


async def _topology(tmp_path) -> dict:
    ckpt, flat = _perm(tmp_path)
    iv = JIntervals.default()
    boot, _ = await new_host_and_dht(JKey.generate(), listen_host="127.0.0.1")
    addr = f"127.0.0.1:{boot.listen_port}"
    node = dict(listen_host="127.0.0.1", bootstrap_peers=[addr])
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False,
        **COMMON)
    jeng = JaxEngine(JConf(model="tiny-test", model_path=ckpt, warmup=False,
                           intervals=iv, **COMMON))
    tworker = TPeer(TKey.generate(), TConf(device="cpu", model="tiny-test",
                                           **node, **COMMON), teng)
    jworker = JPeer(JKey.generate(), JConf(intervals=iv, **node, **COMMON),
                    engine=jeng, worker_mode=True)
    consumer = JPeer(JKey.generate(), JConf(intervals=iv, **node),
                     engine=JFake(models=[]), worker_mode=False)
    gateway = Gateway(consumer, port=0, host="127.0.0.1")
    started = []
    out: dict = {}
    try:
        for part in (teng, tworker, consumer, gateway):
            await part.start()
            started.append(part)
        base = f"http://127.0.0.1:{gateway._runner.addresses[0][1]}"
        pm = consumer.peer_manager
        await _wait(lambda: tworker.peer_id in {
            p.peer_id for p in pm.get_healthy_peers()}, "the port worker")
        async with aiohttp.ClientSession() as s:
            out["torch"] = await _serve_all(s, base)
            undisturbed = await _chat(s, base, LONG, True)
            async with s.get(f"{base}/api/health") as r:
                out["health"] = await r.json()
            out["resource"] = json.loads(tworker.resource.to_json())
            out["seen_resource"] = pm.get_peer(tworker.peer_id).resource

            for part in (jeng, jworker):
                await part.start()
                started.append(part)
            await _wait(lambda: jworker.peer_id in {
                p.peer_id for p in pm.get_healthy_peers()}, "the JAX worker")
            # Fresh metadata: the port worker's throughput score is now
            # above the idle JAX worker's, so the next stream goes to it.
            await pm.perform_health_checks()
            plan = faults.FaultPlan(rules=[faults.FaultRule(
                site="engine.stream_chunk", action="drain", after=2,
                match={"worker": tworker.peer_id})])
            with faults.installed(plan):
                migrated = await _chat(s, base, LONG, True)
            out["failover"] = {"undisturbed": undisturbed,
                               "migrated": migrated, "log": plan.log,
                               "draining": tworker.resource.draining}
            out["jax"] = await _serve_all(s, base)
        out["ids"] = {"torch": tworker.peer_id, "jax": jworker.peer_id}
    finally:
        for part in reversed(started):
            await part.stop()
        await boot.close()
    return out


@pytest.fixture(scope="module")
def swarm(tmp_path_factory):
    return asyncio.run(asyncio.wait_for(
        _topology(tmp_path_factory.mktemp("swarm")), DEADLINE))


def _strip(lines: list[dict]) -> list[dict]:
    return [{k: v for k, v in line.items() if k not in SKIP}
            for line in lines]


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_chat_replies_equal_the_jax_workers(swarm, name):
    got, want = swarm["torch"][name], swarm["jax"][name]
    assert _strip(got) == _strip(want)
    assert got[-1]["done"] and got[-1]["eval_count"] > 0
    assert got[-1]["worker_id"] == swarm["ids"]["torch"]
    assert want[-1]["worker_id"] == swarm["ids"]["jax"]
    if name.endswith("_stream"):
        text = "".join(line["message"]["content"] for line in got)
        assert text == swarm["torch"][name[:-len("_stream")]][0][
            "message"]["content"]


def test_embed_replies_equal_the_jax_workers(swarm):
    (got,), (want,) = swarm["torch"]["embed"], swarm["jax"]["embed"]
    g, w = got["embeddings"], want["embeddings"]
    rest = [{k: v for k, v in d.items() if k != "embeddings"}
            for d in (got, want)]
    assert _strip(rest[:1]) == _strip(rest[1:])
    assert len(g) == len(w) == len(EMBED["input"])
    for a, b in zip(g, w):
        assert len(a) == len(b)
        assert max(abs(x - y) for x, y in zip(a, b)) <= EMBED_ATOL


def test_health_and_resource_keys(swarm):
    pid = swarm["ids"]["torch"]
    w = swarm["health"]["workers"][pid]
    assert w["is_healthy"] and w["supported_models"] == ["tiny-test"]
    assert w["accelerator"] == "cpu"
    assert set(swarm["resource"]) == set(json.loads(JResource().to_json()))
    seen = swarm["seen_resource"]
    assert (seen.peer_id, seen.worker_mode, seen.gpu_model,
            seen.max_context_length) == (pid, True, "", 256)


def test_drain_fails_over_to_the_jax_worker(swarm):
    fo = swarm["failover"]
    assert fo["log"] and fo["draining"]
    text = ["".join(line["message"]["content"] for line in fo[k])
            for k in ("undisturbed", "migrated")]
    assert text[0] and text[1] == text[0]
    assert fo["undisturbed"][-1]["worker_id"] == swarm["ids"]["torch"]
    assert fo["migrated"][-1]["worker_id"] == swarm["ids"]["jax"]
