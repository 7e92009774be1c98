"""The gateway-drafted speculative pipeline of the port against the JAX
package's: ``core/spec_pipeline.py``, ``gateway/draft.py``, the peer's
chunk reader, the scheduler's paced dispatch and the gateway's pump.

- ``PipelineDepthController``: the same depth, draft length, pause and
  estimates as JAX's after each of a seeded series of observations.
- ``DraftFeed``: the same credits and wake-ups.
- ``DraftSession`` on a ``GatewayDrafter`` of the same weights (random
  fp32, one layer): the same chunks (position and tokens) and state as
  JAX's through full accepts, a partial accept and a divergence.
- Swarms on loopback (a JAX DHT bootstrap node, two workers on the
  permutation checkpoint with the draft-model runner, a consumer and its
  gateway with ``spec_pipeline="gateway"`` drafting from the same
  checkpoint), in three pairings: a JAX gateway drafting for torch
  workers (on the draft runner, and n-gram on bf16 and int8 pools), a
  torch gateway for JAX workers, torch to torch.  Each: the
  drafted stream byte-identical to the plain stream (drafts offered and
  accepted, no stale nack), then the serving worker killed mid-verify
  (``spec.verify`` fault) and the stream, failed over, still identical;
  ``"worker"`` mode (pure ack credits) on the torch gateway too.
- A torch ``FakeEngine`` worker nacks every credit and the stream equals
  the plain one.
"""

import asyncio
import json
import random
import time

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.core import spec_pipeline as jsp  # noqa: E402
from crowdllama_tpu.engine.engine import FakeEngine as JFake  # noqa: E402
from crowdllama_tpu.engine.engine import JaxEngine  # noqa: E402
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.gateway import draft as jdraft  # noqa: E402
from crowdllama_tpu.gateway.gateway import Gateway as JGateway  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.testing import faults as jfaults  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.core import spec_pipeline as tsp  # noqa: E402
from crowdllama_tpu_torch.engine.engine import FakeEngine  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.weights import (  # noqa: E402
    load_native_params,
    params_from_numpy,
)
from crowdllama_tpu_torch.gateway import draft as tdraft  # noqa: E402
from crowdllama_tpu_torch.gateway.gateway import Gateway  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.testing import faults as tfaults  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

MODEL = "tiny-test"
CTX = 128


# ------------------------------------------------------ controller, feed

def _controller_trace(mod, seed: int) -> list:
    rng = random.Random(seed)
    c = mod.PipelineDepthController()
    out = []
    for i in range(300):
        op = rng.random()
        if op < 0.3:
            c.observe_rtt(rng.choice([0.0, 0.002, 0.01, 0.05]))
        elif op < 0.6:
            c.observe_step(rng.choice([0.0, 0.00005, 0.002, 0.004, 0.02]))
        else:
            # Acceptance collapses in the middle third, then recovers.
            off = rng.randint(0, 4)
            c.observe_accept(0 if 100 <= i < 200 else rng.randint(0, off),
                             off)
        out.append((c.depth(), c.draft_k(rng.randint(0, 5)), c.paused,
                    c.rtt_ewma, c.step_ewma, c.accept_ewma))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_controller_matches_jax(seed):
    got, want = _controller_trace(tsp, seed), _controller_trace(jsp, seed)
    assert got == want
    assert any(t[2] for t in got) and len({t[0] for t in got}) > 1


def test_draft_feed_matches_jax():
    def run(mod):
        feed, wakes = mod.DraftFeed(), []
        feed._waker = lambda: wakes.append(1)
        feed.push(1, 0, [7, 8])
        feed.push(2, 3, np.array([], np.int64))
        feed.push(3, 4, (9,))
        feed.close()
        return list(feed.chunks), feed.closed, feed.free_run, len(wakes)

    assert run(tsp) == run(jsp)


# --------------------------------------------------------- draft session

def _drafters():
    jcfg = j_get_config(MODEL, max_context_length=CTX, num_layers=1)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    flat = _flatten_params(jparams)
    cfg = get_config(MODEL, max_context_length=CTX, num_layers=1)
    return (jdraft.GatewayDrafter(jparams, jcfg, max_seq=CTX),
            tdraft.GatewayDrafter(params_from_numpy(flat), cfg, max_seq=CTX,
                                  device="cpu"))


def test_draft_session_chunks_match_jax():
    """One stream's rounds: two pipelined chunks, the first fully
    accepted, the second half accepted then a correction, a re-draft."""
    jd, td = _drafters()
    prompt = [257] + [int(t) for t in
                      np.random.default_rng(2).integers(0, 250, 19)]
    sessions = [jd.session(prompt, 40), td.session(prompt, 40)]
    trace = [[], []]
    for i, s in enumerate(sessions):
        p1, c1 = s.next_chunk(3)
        p2, c2 = s.next_chunk(3)
        s.observe(c1 + [s.spec[len(c1)]])       # full accept + its emit
        s.observe(c2[:1] + [(c2[1] + 1) % 250])  # partial: a correction
        p3, c3 = s.next_chunk(2)
        trace[i] = [(p1, c1), (p2, c2), (p3, c3), list(s.seq),
                    list(s.spec), s.sent, s.ingested]
    assert trace[1] == trace[0]
    assert trace[1][0][1] and trace[1][2][1]


# --------------------------------------------------------------- swarms

def _chat(n_tokens=24) -> dict:
    return {"model": MODEL, "stream": True,
            "options": {"num_predict": n_tokens},
            "messages": [{"role": "user",
                          "content": "tell me a story about the swarm"}]}


def _content(raw: str) -> str:
    lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
    assert lines[-1]["done"] is True and "error" not in lines[-1]
    return "".join(ln.get("message", {}).get("content", "") for ln in lines)


async def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


# The worker's runner: the draft model from the checkpoint, or n-gram
# speculation on bf16 or int8 pools (the paged runners verify hosted
# drafts).
RUNNERS = {"draft": dict(spec_decode="draft", spec_draft_model=MODEL),
           "ngram": dict(spec_decode="ngram"),
           "ngram_int8": dict(spec_decode="ngram", kv_dtype="int8")}


def _spec_kw(ckpt, runner="draft"):
    kw = dict(RUNNERS[runner], spec_draft=3, max_batch_slots=2,
              warmup=False)
    if runner == "draft":
        kw["spec_draft_path"] = ckpt
    return kw


def _jax_worker(node, ckpt):
    iv = JIntervals.default()
    eng = JaxEngine(JConf(model=MODEL, model_path=ckpt, intervals=iv,
                          max_context_length=CTX, **_spec_kw(ckpt)))
    return eng, JPeer(JKey.generate(), JConf(intervals=iv, **node),
                      engine=eng, worker_mode=True)


def _torch_worker(node, ckpt, runner="draft"):
    params = load_native_params(get_config(MODEL, max_context_length=CTX),
                                ckpt, dtype=torch.float32)
    eng = TorchEngine(device="cpu", params=params, dtype=torch.float32,
                      model=MODEL, max_context_length=CTX,
                      **_spec_kw(ckpt, runner))
    return eng, TPeer(TKey.generate(), TConf(device="cpu", model=MODEL,
                                             **node), eng)


def _gateway(kind, node, ckpt):
    if kind == "jax":
        cons = JPeer(JKey.generate(),
                     JConf(intervals=JIntervals.default(), **node),
                     engine=JFake(models=[]), worker_mode=False)
        gw = JGateway(cons, port=0, host="127.0.0.1",
                      spec_pipeline="gateway", spec_draft_path=ckpt)
    else:
        cons = TPeer(TKey.generate(), TConf(**node), FakeEngine(models=[]),
                     worker_mode=False)
        gw = Gateway(cons, port=0, host="127.0.0.1", spec_pipeline="gateway",
                     spec_draft_path=ckpt, device="cpu")
    return cons, gw


def _port(kind, gw) -> int:
    return gw._runner.addresses[0][1] if kind == "jax" else gw.port


async def _swarm(tmp_path, gw_kind, worker_kind, workers=2, fake=False,
                 runner="draft"):
    """Start the swarm; returns (url, gateway, parts to stop, faults)."""
    from crowdllama_tpu.testing.modelgen import permutation_checkpoint

    ckpt = permutation_checkpoint(MODEL, tmp_path / "ckpt", max_context=CTX)
    boot, _ = await new_host_and_dht(JKey.generate(), listen_host="127.0.0.1")
    node = dict(listen_host="127.0.0.1",
                bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
    parts = []
    peers = []
    for _ in range(workers):
        if fake:
            eng = FakeEngine(models=[MODEL])
            peer = TPeer(TKey.generate(), TConf(model=MODEL, **node), eng)
        elif worker_kind == "jax":
            eng, peer = _jax_worker(node, ckpt)
        else:
            eng, peer = _torch_worker(node, ckpt, runner)
        await eng.start()
        parts.append(eng)
        await peer.start()
        parts.append(peer)
        peers.append(peer)
    cons, gw = _gateway(gw_kind, node, ckpt)
    await cons.start()
    parts.append(cons)
    await gw.start()
    parts.append(gw)
    await _wait(lambda: {p.peer_id for p in peers} <= {
        p.peer_id for p in cons.peer_manager.get_healthy_peers()},
        "the workers")
    url = f"http://127.0.0.1:{_port(gw_kind, gw)}/api/chat"
    return url, gw, parts[::-1], boot


async def _post(s, url) -> str:
    async with s.post(url, json=_chat()) as resp:
        assert resp.status == 200
        return _content(await resp.text())


@pytest.mark.parametrize("gw_kind,worker_kind,runner", [
    ("jax", "torch", "draft"), ("jax", "torch", "ngram"),
    ("jax", "torch", "ngram_int8"), ("torch", "jax", "draft"),
    ("torch", "torch", "draft")])
def test_gateway_draft_byte_identity_and_midverify_kill(tmp_path, gw_kind,
                                                        worker_kind, runner):
    async def go():
        url, gw, parts, boot = await _swarm(tmp_path, gw_kind, worker_kind,
                                            runner=runner)
        faults = jfaults if worker_kind == "jax" else tfaults
        try:
            async with aiohttp.ClientSession() as s:
                gw.spec_pipeline = "off"
                baseline = await _post(s, url)
                assert len(baseline) > 8
                gw.spec_pipeline = "gateway"
                assert await _post(s, url) == baseline
                stats = dict(gw._spec_stats)
                assert stats["offered"] > 0 and stats["accepted"] > 0
                assert stats["nacks"] == 0
                plan = faults.FaultPlan(seed=7, rules=[faults.FaultRule(
                    site="spec.verify", action="kill_stream", after=2,
                    times=1)])
                with faults.installed(plan):
                    assert await _post(s, url) == baseline
                assert plan.log and plan.log[0][2] == "kill_stream"
                if gw_kind == "torch":
                    # Pure ack credits: the worker paces on its own drafts.
                    gw.spec_pipeline = "worker"
                    acks = gw._spec_stats["acks"]
                    assert await _post(s, url) == baseline
                    assert gw._spec_stats["acks"] > acks
            return True
        finally:
            jfaults.clear()
            tfaults.clear()
            for part in parts:
                await part.stop()
            await boot.close()

    assert asyncio.run(asyncio.wait_for(go(), 240))


def test_gateway_draft_degrades_against_fake_worker(tmp_path):
    """A torch FakeEngine worker cannot verify: its peer nacks every
    credit and the stream equals the plain one."""
    async def go():
        url, gw, parts, boot = await _swarm(tmp_path, "torch", "torch",
                                            workers=1, fake=True)
        try:
            async with aiohttp.ClientSession() as s:
                gw.spec_pipeline = "off"
                baseline = await _post(s, url)
                gw.spec_pipeline = "gateway"
                assert await _post(s, url) == baseline
                # No handshake came back: the pump offered nothing.
                assert gw._spec_stats["offered"] == 0
            return baseline
        finally:
            for part in parts:
                await part.stop()
            await boot.close()

    assert asyncio.run(asyncio.wait_for(go(), 120)).startswith("echo:")
