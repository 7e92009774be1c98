"""NAT traversal in the port (``net/relay.py``, the dial ladder of
``net/host.py``, ``Peer``'s relay plane): the scenarios of
``tests/test_relay.py`` on torch nodes, a torch ``RelayService`` and the
port's gateway, plus two mixed swarms.

- Protocol level: register + connect splices an end-to-end authenticated
  stream; dial-back reports loopback reachability; connection reversal
  and a hole punch give a direct path; each falls back to the splice when
  the far side never dials; a forged reversal marker is refused; the
  relay client re-registers after a relay restart and fails over to a
  candidate relay.
- Peer level: a ``relay_mode="always"`` worker serves ``/api/chat``
  through the port's gateway over the splice (the trace crosses it) and
  over reversed connections; an ``"auto"`` worker on loopback stays
  direct, upgrades to direct once its dial-back succeeds, and a NATed
  worker fails over to a public worker's relay.
- Swarms on the permutation checkpoint, each through the splice, a
  reversal and a hole punch: a JAX bootstrap/relay with a relayed torch
  worker (JAX gateway), a torch relay (the port's ``cli/dht.py`` server)
  with a relayed JAX worker, and a torch-only swarm (port gateways); each
  serves a greedy ``/api/chat`` whose text equals the worker's reply over
  a direct dial, and each side counts the rung's streams.

Each test bounds itself with ``asyncio.wait_for``: the hole punch runs
simultaneous connects on loopback, and a hang must fail the test, not the
suite's clock.
"""

import asyncio
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_handle import COMMON, _perm  # noqa: E402

from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.engine.engine import FakeEngine as JFake  # noqa: E402
from crowdllama_tpu.engine.engine import JaxEngine  # noqa: E402
from crowdllama_tpu.gateway.gateway import Gateway as JGateway  # noqa: E402
from crowdllama_tpu.net import discovery as jdiscovery  # noqa: E402
from crowdllama_tpu.net.relay import RelayService as JRelay  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.cli import dht as tcli_dht  # noqa: E402
from crowdllama_tpu_torch.config import Configuration, Intervals  # noqa: E402
from crowdllama_tpu_torch.core import wire as twire  # noqa: E402
from crowdllama_tpu_torch.core.messages import (  # noqa: E402
    create_generate_request,
)
from crowdllama_tpu_torch.core.protocol import (  # noqa: E402
    INFERENCE_PROTOCOL,
    REVERSE_PROTOCOL,
)
from crowdllama_tpu_torch.engine.engine import FakeEngine  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.weights import (  # noqa: E402
    params_from_numpy,
)
from crowdllama_tpu_torch.gateway.gateway import Gateway  # noqa: E402
from crowdllama_tpu_torch.net import http  # noqa: E402
from crowdllama_tpu_torch.net import relay as relay_mod  # noqa: E402
from crowdllama_tpu_torch.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu_torch.net.host import (  # noqa: E402
    Contact,
    Host,
    read_json_frame,
    write_json_frame,
)
from crowdllama_tpu_torch.net.relay import (  # noqa: E402
    RelayClient,
    RelayService,
    dialback_probe,
)
from crowdllama_tpu_torch.peer.peer import Peer  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

MODEL = "tiny-test"


def run(coro, timeout: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _cfg(bootstrap, **kw):
    cfg = Configuration(listen_host="127.0.0.1", bootstrap_peers=[bootstrap],
                        intervals=Intervals.default())
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


async def _wait_for(cond, timeout=20.0, what="condition"):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return
        await asyncio.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


async def _chat(port: int, content: str, timeout: float = 30.0,
                **extra) -> tuple[int, dict]:
    body = {"model": MODEL, "stream": False,
            "messages": [{"role": "user", "content": content}], **extra}
    async with http.request("POST", f"http://127.0.0.1:{port}/api/chat",
                            json=body, timeout=timeout) as resp:
        text = await resp.text()
    return resp.status, (json.loads(text) if text else {})


async def _hosts(n: int) -> list[Host]:
    hosts = []
    for _ in range(n):
        h = Host(TKey.generate(), listen_host="127.0.0.1")
        await h.start()
        hosts.append(h)
    return hosts


async def _echo(stream):
    data = await stream.reader.readexactly(5)
    stream.writer.write(data[::-1])
    await stream.writer.drain()


async def _ok(stream):
    stream.writer.write(b"ok")
    await stream.writer.drain()


def _relayed(worker: Host, relay: Host) -> Contact:
    return Contact(peer_id=worker.peer_id, host="127.0.0.1",
                   port=relay.listen_port, relay=True)


# ------------------------------------------------------ protocol scenarios


def test_relay_reverse_stream_and_dialback(monkeypatch):
    """register + connect splices an end-to-end authenticated stream;
    dial-back reports loopback reachability."""
    monkeypatch.setenv("CROWDLLAMA_TPU_NO_PUNCH", "1")

    async def go():
        relay_host, worker_host, client_host = await _hosts(3)
        RelayService(relay_host)
        relay_addr = f"127.0.0.1:{relay_host.listen_port}"
        served = asyncio.Event()

        async def echo(stream):
            await _echo(stream)
            served.set()

        worker_host.set_stream_handler("/test/echo", echo)
        rc = RelayClient(worker_host, relay_addr)
        try:
            assert await dialback_probe(worker_host, relay_addr) is True
            await rc.start()
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_host), "/test/echo")
            # The identity is the WORKER's: the handshake ran end to end.
            assert stream.remote_peer_id == worker_host.peer_id
            stream.writer.write(b"hello")
            await stream.writer.drain()
            assert await stream.reader.readexactly(5) == b"olleh"
            await asyncio.wait_for(served.wait(), 5)
            stream.close()
            assert client_host.stats.get("streams_relayed_out", 0) == 1
            assert worker_host.stats.get("streams_relayed_in", 0) == 1
            assert client_host.dial_ladder[("splice", "ok")] == 1
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_host):
                await h.close()

    run(go())


def test_relayed_worker_serves_through_gateway(monkeypatch):
    """A worker whose hellos never advertise its address serves the
    port gateway's /api/chat through the relay splice, and the gateway's
    trace id reaches the worker's ring across it."""
    monkeypatch.setenv("CROWDLLAMA_TPU_NO_PUNCH", "1")
    monkeypatch.setenv("CROWDLLAMA_TPU_NO_REVERSE", "1")

    async def go():
        boot_host, _ = await new_host_and_dht(TKey.generate(),
                                              listen_host="127.0.0.1")
        RelayService(boot_host)
        bootstrap = f"127.0.0.1:{boot_host.listen_port}"
        worker = Peer(TKey.generate(), _cfg(bootstrap, relay_mode="always"),
                      engine=FakeEngine(models=[MODEL]), worker_mode=True)
        await worker.start()
        consumer = Peer(TKey.generate(), _cfg(bootstrap),
                        engine=FakeEngine(models=[]), worker_mode=False)
        gateway = Gateway(consumer, port=0, host="127.0.0.1")
        try:
            assert worker.relay_client is not None
            assert worker.resource.reachability == "relay"
            assert worker.host.contact.relay is True
            await consumer.start()
            await gateway.start()
            await _wait_for(
                lambda: consumer.peer_manager.find_best_worker(MODEL)
                is not None, what="consumer discovering the relayed worker")
            assert worker.host.stats.get("streams_relayed_in", 0) >= 1
            status, d = await _chat(gateway.port, "via relay")
            assert status == 200, d
            assert "via relay" in d["message"]["content"]
            assert d["worker_id"] == worker.peer_id
            assert worker.host.stats.get("streams_reversed_in", 0) == 0
            gw_traces = gateway.obs.trace.snapshot()["traces"]
            tid = gw_traces[-1]["trace_id"]
            wk = worker.obs.trace.get(tid)
            assert wk is not None, f"trace {tid} did not reach the worker"
            wk_spans = {s["name"]: s for s in wk["spans"]}
            assert {"worker_queue", "prefill", "decode_step"} <= set(wk_spans)
            assert all(s.get("parent") == "gateway"
                       for s in wk_spans.values())
            gw_spans = {s["name"] for s in gw_traces[-1]["spans"]}
            assert {"route", "serde", "aead", "io_wait"} <= gw_spans
        finally:
            await gateway.stop()
            await consumer.stop()
            await worker.stop()
            await boot_host.close()

    run(go())


def test_connection_reversal_direct_data_path():
    """A dial-back-confirmed requester gets a DIRECT reversed connection
    to a relayed worker: the splice is never used, and the stream still
    authenticates as the worker."""
    async def go():
        relay_host, worker_host, client_host = await _hosts(3)
        RelayService(relay_host)
        worker_host.set_stream_handler("/test/echo", _echo)
        client_host.reverse_dialable = True  # what the startup probe sets
        rc = RelayClient(worker_host, f"127.0.0.1:{relay_host.listen_port}")
        try:
            await rc.start()
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_host), "/test/echo")
            assert stream.remote_peer_id == worker_host.peer_id
            stream.writer.write(b"hello")
            await stream.writer.drain()
            assert await stream.reader.readexactly(5) == b"olleh"
            stream.close()
            assert client_host.stats.get("streams_reversed_out", 0) == 1
            assert client_host.stats.get("streams_relayed_out", 0) == 0
            assert worker_host.stats.get("streams_reversed_in", 0) == 1
            assert worker_host.stats.get("streams_relayed_in", 0) == 0
            assert client_host.dial_ladder[("reverse", "ok")] == 1
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_host):
                await h.close()

    run(go())


def test_gateway_chat_rides_reversed_connections():
    """Reversal on (the default): the consumer's startup dial-back marks
    it public, so its streams to the relayed worker (discovery metadata
    and the inference stream) arrive as direct reversed connections."""
    async def go():
        boot_host, _ = await new_host_and_dht(TKey.generate(),
                                              listen_host="127.0.0.1")
        RelayService(boot_host)
        bootstrap = f"127.0.0.1:{boot_host.listen_port}"
        worker = Peer(TKey.generate(), _cfg(bootstrap, relay_mode="always"),
                      engine=FakeEngine(models=[MODEL]), worker_mode=True)
        await worker.start()
        consumer = Peer(TKey.generate(), _cfg(bootstrap),
                        engine=FakeEngine(models=[]), worker_mode=False)
        gateway = Gateway(consumer, port=0, host="127.0.0.1")
        try:
            await consumer.start()
            assert consumer.host.reverse_dialable is True  # loopback probe
            await gateway.start()
            await _wait_for(
                lambda: consumer.peer_manager.find_best_worker(MODEL)
                is not None, what="consumer discovering the relayed worker")
            status, d = await _chat(gateway.port, "reversed")
            assert status == 200, d
            assert d["worker_id"] == worker.peer_id
            assert worker.host.stats.get("streams_reversed_in", 0) >= 2
            assert consumer.host.stats.get("streams_reversed_out", 0) >= 2
        finally:
            await gateway.stop()
            await consumer.stop()
            await worker.stop()
            await boot_host.close()

    run(go())


def test_reversal_falls_back_to_splice(monkeypatch):
    """A reversal that never arrives falls back to the splice inside the
    same new_stream call."""
    monkeypatch.setenv("CROWDLLAMA_TPU_NO_PUNCH", "1")
    monkeypatch.setattr(RelayClient, "_reverse",
                        lambda self, addr, nonce: asyncio.sleep(0))

    async def go():
        relay_host, worker_host, client_host = await _hosts(3)
        RelayService(relay_host)
        worker_host.set_stream_handler("/test/echo", _ok)
        client_host.reverse_dialable = True
        rc = RelayClient(worker_host, f"127.0.0.1:{relay_host.listen_port}")
        try:
            await rc.start()
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_host), "/test/echo", timeout=8.0)
            assert await stream.reader.readexactly(2) == b"ok"
            stream.close()
            assert client_host.stats.get("streams_relayed_out", 0) == 1
            assert client_host.stats.get("streams_reversed_out", 0) == 0
            assert client_host.dial_ladder[("reverse", "fail")] == 1
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_host):
                await h.close()

    run(go())


def test_reverse_marker_with_unknown_nonce_rejected():
    """A forged or stale REVERSE opening frame is refused without
    touching any waiter."""
    async def go():
        (h,) = await _hosts(1)
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", h.listen_port)
            await write_json_frame(writer, {"proto": REVERSE_PROTOCOL,
                                            "nonce": "deadbeef"})
            reply = await read_json_frame(reader, 5.0)
            assert "error" in reply
            writer.close()
            assert h.stats["rejected"] >= 1
        finally:
            await h.close()

    run(go())


def test_direct_worker_stays_direct_in_auto_mode():
    async def go():
        boot_host, _ = await new_host_and_dht(TKey.generate(),
                                              listen_host="127.0.0.1")
        RelayService(boot_host)
        worker = Peer(TKey.generate(),
                      _cfg(f"127.0.0.1:{boot_host.listen_port}",
                           relay_mode="auto"),
                      engine=FakeEngine(models=[MODEL]), worker_mode=True)
        await worker.start()
        try:
            assert worker.relay_client is None
            assert worker.resource.reachability == "direct"
            assert worker.host.contact.relay is False
            assert worker.relay_service is not None
            assert worker.host.reverse_dialable is True
        finally:
            await worker.stop()
            await boot_host.close()

    run(go())


def test_relay_client_reregisters_after_relay_restart():
    async def go():
        relay_host, worker_host, client_host = await _hosts(3)
        RelayService(relay_host)
        relay_port = relay_host.listen_port
        worker_host.set_stream_handler("/test/echo", _echo)
        rc = RelayClient(worker_host, f"127.0.0.1:{relay_port}",
                         ping_interval=0.2)
        relay_host2 = None
        try:
            await rc.start()
            await relay_host.close()
            await asyncio.sleep(0.3)
            assert not rc.registered.is_set()
            relay_host2 = Host(TKey.generate(), listen_host="127.0.0.1",
                               listen_port=relay_port)
            for _ in range(40):
                try:
                    await relay_host2.start()
                    break
                except OSError:
                    await asyncio.sleep(0.25)
            else:
                raise AssertionError("could not rebind the relay port")
            RelayService(relay_host2)
            await asyncio.wait_for(rc.registered.wait(), 15)
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_host2), "/test/echo")
            stream.writer.write(b"hello")
            await stream.writer.drain()
            assert await stream.reader.readexactly(5) == b"olleh"
            stream.close()
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_host2):
                if h is not None:
                    await h.close()

    run(go())


def test_relay_client_fails_over_to_candidate_relay():
    async def go():
        relay_a, relay_b, worker_host, client_host = await _hosts(4)
        RelayService(relay_a)
        RelayService(relay_b)
        addr_a = f"127.0.0.1:{relay_a.listen_port}"
        addr_b = f"127.0.0.1:{relay_b.listen_port}"
        worker_host.set_stream_handler("/test/echo", _echo)
        changes = []
        rc = RelayClient(worker_host, addr_a, ping_interval=0.2,
                         candidates=lambda: [addr_a, addr_b],
                         on_relay_change=changes.append)
        try:
            await rc.start()
            assert rc.relay_addr == addr_a and changes == [addr_a]
            await relay_a.close()  # relay A dies for good
            await _wait_for(lambda: rc.registered.is_set()
                            and rc.relay_addr == addr_b,
                            what="failover to relay B")
            assert changes[-1] == addr_b
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_b), "/test/echo")
            stream.writer.write(b"hello")
            await stream.writer.drain()
            assert await stream.reader.readexactly(5) == b"olleh"
            stream.close()
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_b):
                await h.close()

    run(go())


def test_worker_fails_over_to_peer_relay_and_serves(monkeypatch):
    """The bootstrap relay closes; the NATed worker re-relays through a
    public worker advertising relay_capable and still serves /api/chat."""
    monkeypatch.setenv("CROWDLLAMA_TPU_NO_PUNCH", "1")

    async def go():
        boot_host, _ = await new_host_and_dht(TKey.generate(),
                                              listen_host="127.0.0.1")
        boot_relay = RelayService(boot_host)
        bootstrap = f"127.0.0.1:{boot_host.listen_port}"
        public = Peer(TKey.generate(), _cfg(bootstrap, relay_mode="auto"),
                      engine=FakeEngine(models=["other-model"]),
                      worker_mode=True)
        worker = Peer(TKey.generate(), _cfg(bootstrap, relay_mode="always"),
                      engine=FakeEngine(models=[MODEL]), worker_mode=True)
        consumer = Peer(TKey.generate(), _cfg(bootstrap),
                        engine=FakeEngine(models=[]), worker_mode=False)
        gateway = Gateway(consumer, port=0, host="127.0.0.1")
        started = []
        try:
            for part in (public, worker, consumer, gateway):
                await part.start()
                started.append(part)
            assert public.relay_service is not None
            assert public.resource.relay_capable is True
            assert worker.relay_client is not None
            public_addr = f"127.0.0.1:{public.host.listen_port}"
            await _wait_for(
                lambda: consumer.peer_manager.find_best_worker(MODEL)
                is not None
                and any(getattr(p.resource, "relay_capable", False)
                        for p in worker.peer_manager.get_healthy_peers()),
                what="discovery incl. the relay_capable advertisement")
            assert public_addr in worker._relay_candidates()
            boot_relay.close()  # the bootstrap stops relaying
            await _wait_for(
                lambda: worker.relay_client.registered.is_set()
                and worker.relay_client.relay_addr == public_addr,
                timeout=30.0, what="failover to the public worker's relay")
            assert worker.host.relay_contact.port == public.host.listen_port

            async def chat_ok():
                try:
                    status, d = await _chat(gateway.port, "hi", timeout=5)
                except Exception:
                    return False
                return status == 200 and d.get("worker_id") == worker.peer_id

            # The consumer may hold the stale relay contact briefly; the
            # re-advertised contact must propagate.
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 30
            ok = False
            while loop.time() < deadline and not ok:
                ok = await chat_ok()
            assert ok, "chat via the failover relay never succeeded"
        finally:
            for part in reversed(started):
                await part.stop()
            await boot_host.close()

    run(go(), timeout=90.0)


def test_auto_worker_upgrades_to_direct(monkeypatch):
    """A relaying "auto" worker whose port BECOMES reachable drops the
    relay at the next re-probe, advertises itself directly and starts
    relaying for others."""
    real_probe = relay_mod.dialback_probe

    async def unreachable(host, relay_addr):
        return False

    async def go():
        boot_host, _ = await new_host_and_dht(TKey.generate(),
                                              listen_host="127.0.0.1")
        RelayService(boot_host)
        monkeypatch.setattr(relay_mod, "dialback_probe", unreachable)
        worker = Peer(TKey.generate(),
                      _cfg(f"127.0.0.1:{boot_host.listen_port}",
                           relay_mode="auto"),
                      engine=FakeEngine(models=[MODEL]), worker_mode=True)
        await worker.start()
        try:
            assert worker.relay_client is not None
            assert worker.resource.reachability == "relay"
            monkeypatch.setattr(relay_mod, "dialback_probe", real_probe)
            await _wait_for(lambda: worker.relay_client is None,
                            timeout=30.0, what="relay dropped")
            assert worker.resource.reachability == "direct"
            assert worker.host.hello_dialable is True
            assert worker.host.relay_contact is None
            assert worker.relay_service is not None
            assert worker.resource.relay_capable is True
        finally:
            await worker.stop()
            await boot_host.close()

    run(go())


def test_hole_punch_direct_path():
    """Both sides NATed (the requester is not reverse-dialable): the relay
    coordinates a punch and the data path goes direct."""
    async def go():
        relay_host, worker_host, client_host = await _hosts(3)
        RelayService(relay_host)
        worker_host.set_stream_handler("/test/echo", _echo)
        assert not client_host.reverse_dialable
        rc = RelayClient(worker_host, f"127.0.0.1:{relay_host.listen_port}")
        try:
            await rc.start()
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_host), "/test/echo",
                timeout=10.0)
            assert stream.remote_peer_id == worker_host.peer_id
            stream.writer.write(b"hello")
            await stream.writer.drain()
            assert await stream.reader.readexactly(5) == b"olleh"
            stream.close()
            assert client_host.stats.get("streams_punched_out", 0) == 1
            assert client_host.stats.get("streams_relayed_out", 0) == 0
            # A crossed punch may establish one connection each way; the
            # worker serves (and counts) both.
            assert worker_host.stats.get("streams_punched_in", 0) >= 1
            assert worker_host.stats.get("streams_relayed_in", 0) == 0
            assert client_host.dial_ladder[("punch", "ok")] == 1
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_host):
                await h.close()

    run(go())


def test_punch_falls_back_to_splice(monkeypatch):
    """A punch whose far side never dials falls back to the splice inside
    the same new_stream call."""
    monkeypatch.setattr(RelayClient, "_punch",
                        lambda self, addr, control: asyncio.sleep(0))

    async def go():
        relay_host, worker_host, client_host = await _hosts(3)
        RelayService(relay_host)
        worker_host.set_stream_handler("/test/echo", _ok)
        rc = RelayClient(worker_host, f"127.0.0.1:{relay_host.listen_port}")
        try:
            await rc.start()
            stream = await client_host.new_stream(
                _relayed(worker_host, relay_host), "/test/echo",
                timeout=15.0)
            assert await stream.reader.readexactly(2) == b"ok"
            stream.close()
            assert client_host.stats.get("streams_relayed_out", 0) == 1
            assert client_host.stats.get("streams_punched_out", 0) == 0
            assert client_host.dial_ladder[("punch", "fail")] == 1
        finally:
            await rc.stop()
            for h in (client_host, worker_host, relay_host):
                await h.close()

    run(go())


# -------------------------------------------------------------- mixed swarms

GREEDY = {"messages": [{"role": "user", "content": "the quick brown fox"}],
          "options": {"num_predict": 10}}


async def _direct_text(worker_host_port: int, worker_id: str) -> str:
    """The greedy request the gateway sends for GREEDY, streamed to the
    worker from a port host over a DIRECT dial of its real port: its
    text."""
    msg = create_generate_request(
        MODEL, messages=GREEDY["messages"], stream=True,
        max_tokens=GREEDY["options"]["num_predict"], top_p=1.0,
        repeat_penalty=1.0)
    (host,) = await _hosts(1)
    s = await host.new_stream(Contact(worker_id, "127.0.0.1",
                                      worker_host_port), INFERENCE_PROTOCOL)
    try:
        await twire.write_length_prefixed_pb(s.writer, msg)
        text = []
        while True:
            m = await twire.read_length_prefixed_pb(s.reader, timeout=120)
            text.append(m.generate_response.response)
            if m.generate_response.done:
                return "".join(text)
    finally:
        s.close()
        await host.close()


async def _gateway_text(port: int) -> tuple[str, str]:
    body = dict(GREEDY, model=MODEL, stream=True)
    async with http.request("POST", f"http://127.0.0.1:{port}/api/chat",
                            json=body, timeout=120) as resp:
        assert resp.status == 200
        lines = [json.loads(ln) for ln in (await resp.text()).splitlines()]
    assert lines[-1]["done"]
    return ("".join(ln["message"]["content"] for ln in lines),
            lines[-1]["worker_id"])


SWARMS = ("jax_relay_torch_worker", "torch_relay_jax_worker", "torch_only")
RUNGS = {  # rung -> (the ladder's other rungs off, the stream kind)
    "splice": ({"CROWDLLAMA_TPU_NO_REVERSE": "1",
                "CROWDLLAMA_TPU_NO_PUNCH": "1"}, "relayed"),
    "reverse": ({}, "reversed"),
    "punch": ({"CROWDLLAMA_TPU_NO_REVERSE": "1"}, "punched"),
}


async def _swarm(tmp_path, swarm: str, kind: str) -> dict:
    """A bootstrap/relay, a worker on the permutation checkpoint that
    advertises only the relay (``relay_mode="always"``), a consumer and its
    gateway: "jax_relay_torch_worker" (the JAX bootstrap/relay and JAX
    consumer, a torch worker), "torch_relay_jax_worker" (the port's
    ``cli/dht.py run_server``, a JAX worker, the port's consumer) or
    "torch_only" (the port's server, worker and consumer).  A greedy chat
    through the gateway, the same request over a direct dial, and the
    streams of ``kind`` ("relayed", "reversed", "punched") each side saw."""
    ckpt, flat = _perm(tmp_path)
    started, out = [], {}
    server = None
    if swarm == "jax_relay_torch_worker":
        boot, _ = await jdiscovery.new_host_and_dht(
            JKey.generate(), listen_host="127.0.0.1")
        JRelay(boot)
        addr = f"127.0.0.1:{boot.listen_port}"
    else:
        port_holder = Host(TKey.generate(), listen_host="127.0.0.1")
        await port_holder.start()
        port = port_holder.listen_port
        await port_holder.close()
        server = asyncio.create_task(tcli_dht.run_server(
            "127.0.0.1", port, str(tmp_path / "dht-key"), 3600.0))
        addr = f"127.0.0.1:{port}"
        await asyncio.sleep(0.5)
    iv = JIntervals.default()
    try:
        if swarm == "torch_relay_jax_worker":
            engine = JaxEngine(JConf(model=MODEL, model_path=ckpt,
                                     warmup=False, intervals=iv, **COMMON))
            worker = JPeer(JKey.generate(), JConf(
                intervals=iv, listen_host="127.0.0.1",
                bootstrap_peers=[addr], relay_mode="always", **COMMON),
                engine=engine, worker_mode=True)
        else:
            engine = TorchEngine(device="cpu", params=params_from_numpy(
                flat, dtype=torch.bfloat16), model=MODEL, warmup=False,
                **COMMON)
            worker = Peer(TKey.generate(), Configuration(
                device="cpu", model=MODEL, listen_host="127.0.0.1",
                bootstrap_peers=[addr], relay_mode="always", **COMMON),
                engine)
        if swarm == "jax_relay_torch_worker":
            consumer = JPeer(JKey.generate(), JConf(
                intervals=iv, listen_host="127.0.0.1",
                bootstrap_peers=[addr]), engine=JFake(models=[]),
                worker_mode=False)
            gateway = JGateway(consumer, port=0, host="127.0.0.1")
        else:
            consumer = Peer(TKey.generate(), _cfg(addr),
                            engine=FakeEngine(models=[]), worker_mode=False)
            gateway = Gateway(consumer, port=0, host="127.0.0.1")
        for part in (engine, worker, consumer, gateway):
            await part.start()
            started.append(part)
        gw_port = (gateway._runner.addresses[0][1]
                   if swarm == "jax_relay_torch_worker" else gateway.port)
        assert worker.relay_client is not None
        assert worker.host.contact.relay is True
        await _wait_for(
            lambda: consumer.peer_manager.find_best_worker(MODEL)
            is not None, timeout=60.0, what="the relayed worker")
        out["gateway"] = await _gateway_text(gw_port)
        out["direct"] = await _direct_text(worker.host.listen_port,
                                           worker.peer_id)
        out["worker_id"] = worker.peer_id
        out["in"] = worker.host.stats.get(f"streams_{kind}_in", 0)
        out["out"] = consumer.host.stats.get(f"streams_{kind}_out", 0)
    finally:
        for part in reversed(started):
            await part.stop()
        if server is not None:
            server.cancel()
            await asyncio.gather(server, return_exceptions=True)
        else:
            await boot.close()
    return out


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("swarm", SWARMS)
def test_relayed_worker_serves_byte_equal_to_direct(monkeypatch, tmp_path,
                                                    swarm, rung):
    env, kind = RUNGS[rung]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = run(_swarm(tmp_path, swarm, kind), timeout=240.0)
    text, worker_id = out["gateway"]
    assert worker_id == out["worker_id"]
    assert text and text == out["direct"]
    assert out["in"] >= 1 and out["out"] >= 1
