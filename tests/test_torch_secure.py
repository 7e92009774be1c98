"""The port's secure host (``net/secure.py``, ``net/host.py``) against the
JAX package's.

- ``derive_keys`` equals JAX's on the same inputs.
- A port ``Host`` and a JAX ``Host`` complete the signed handshake in
  both directions on loopback and exchange JSON frames and llama.v1
  frames (each side encodes and decodes with its own package).
- The cases of ``tests/test_secure.py`` against the port, through the
  same recording proxy: no plaintext on the wire, a tampered frame
  refused, a replayed frame refused, truncation mid-frame and an
  unauthenticated FIN refused.
- A JAX key file loads in the port's ``KeyManager`` with the same peer id,
  and the other way round.
"""

import asyncio

import pytest
from test_secure import Wiretap

from crowdllama_tpu.core import messages as jmessages
from crowdllama_tpu.core import wire as jwire
from crowdllama_tpu.net import host as jhost
from crowdllama_tpu.net import secure as jsecure
from crowdllama_tpu.utils import keys as jkeys
from crowdllama_tpu.utils.crypto_compat import (
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.core import messages as tmessages
from crowdllama_tpu_torch.core import wire as twire
from crowdllama_tpu_torch.net import host as thost
from crowdllama_tpu_torch.net import secure as tsecure
from crowdllama_tpu_torch.utils import keys as tkeys
from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey as TKey

PROTO = "/test/echo/1.0.0"
SECRET = b"the launch code is 0000-corge-grault"
DEADLINE = 30.0


@pytest.mark.parametrize("args", [
    (b"s" * 32, "/p/1", "alice", "bob", "n1", "n2"),
    (bytes(range(32)), "/crowdllama/inference/1.0.0", "a" * 40, "b" * 40,
     "00" * 16, "ff" * 16),
])
def test_derive_keys_equal_jax(args):
    assert tsecure.derive_keys(*args) == jsecure.derive_keys(*args)


PKGS = {
    "torch": (thost, TKey, tmessages, twire),
    "jax": (jhost, JKey, jmessages, jwire),
}


async def _exchange(server_pkg: str, client_pkg: str) -> dict:
    """A server host of one package, a client host of the other: one JSON
    frame and one llama.v1 request each way over one stream."""
    s_host, s_key, s_msgs, s_wire = PKGS[server_pkg]
    c_host, c_key, c_msgs, c_wire = PKGS[client_pkg]
    seen: dict = {}

    async def handler(stream):
        seen["remote"] = stream.remote_peer_id
        obj = await s_host.read_json_frame(stream.reader, 10)
        await s_host.write_json_frame(stream.writer, {"echo": obj})
        req = await s_wire.read_length_prefixed_pb(stream.reader, 10)
        seen["prompt"] = req.generate_request.prompt
        await s_wire.write_length_prefixed_pb(
            stream.writer, s_msgs.create_generate_response(
                "m", "reply to " + req.generate_request.prompt,
                worker_id="w"))

    server = s_host.Host(s_key.generate(), listen_host="127.0.0.1")
    server.set_stream_handler(PROTO, handler)
    await server.start()
    client = c_host.Host(c_key.generate(), listen_host="127.0.0.1")
    await client.start()
    try:
        contact = c_host.Contact(server.peer_id, "127.0.0.1",
                                 server.listen_port)
        stream = await client.new_stream(contact, PROTO)
        await c_host.write_json_frame(stream.writer, {"x": [1, "é"]})
        echo = await c_host.read_json_frame(stream.reader, 10)
        await c_wire.write_length_prefixed_pb(
            stream.writer, c_msgs.create_generate_request("m", "héllo"))
        reply = await c_wire.read_length_prefixed_pb(stream.reader, 10)
        stream.close()
        return {"echo": echo, "reply": reply.generate_response.response,
                "server_saw": seen, "client_id": client.peer_id,
                "remote": stream.remote_peer_id, "server_id": server.peer_id,
                "peerstore": client.peerstore.get(server.peer_id)}
    finally:
        await client.close()
        await server.close()


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_handshake_and_frames_across_packages(server, client):
    out = asyncio.run(asyncio.wait_for(_exchange(server, client), DEADLINE))
    assert out["echo"] == {"echo": {"x": [1, "é"]}}
    assert out["reply"] == "reply to héllo"
    assert out["server_saw"] == {"remote": out["client_id"],
                                 "prompt": "héllo"}
    assert out["remote"] == out["server_id"]
    assert out["peerstore"].port > 0


def test_port_refuses_a_jax_peer_with_a_different_identity():
    async def go():
        server = jhost.Host(JKey.generate(), listen_host="127.0.0.1")
        server.set_stream_handler(PROTO, lambda s: asyncio.sleep(0))
        await server.start()
        client = thost.Host(TKey.generate(), listen_host="127.0.0.1")
        try:
            wrong = thost.Contact("0" * 40, "127.0.0.1", server.listen_port)
            with pytest.raises(thost.HandshakeError, match="identity"):
                await client.new_stream(wrong, PROTO)
            relayed = thost.Contact(server.peer_id, "127.0.0.1",
                                    server.listen_port, relay=True)
            with pytest.raises(thost.HandshakeError, match="relay"):
                await client.new_stream(relayed, PROTO)
        finally:
            await server.close()

    asyncio.run(asyncio.wait_for(go(), DEADLINE))


# ---------------------------------------- the cases of tests/test_secure.py

async def _echo_topology():
    received: list[bytes] = []

    async def echo_handler(stream):
        data = await stream.reader.readexactly(len(SECRET))
        received.append(data)
        stream.writer.write(b"echo:" + data)
        await stream.writer.drain()
        stream.writer.write_eof()

    server = thost.Host(TKey.generate(), listen_host="127.0.0.1")
    server.set_stream_handler(PROTO, echo_handler)
    await server.start()
    tap = Wiretap(server.listen_port)
    tap_port = await tap.start()
    client = thost.Host(TKey.generate(), listen_host="127.0.0.1")
    await client.start()
    return server, tap, tap_port, client, received


DEAD = (asyncio.IncompleteReadError, tsecure.TamperError,
        ConnectionResetError, asyncio.TimeoutError)


async def _no_plaintext():
    server, tap, tap_port, client, received = await _echo_topology()
    try:
        stream = await client.new_stream(f"127.0.0.1:{tap_port}", PROTO)
        stream.writer.write(SECRET)
        await stream.writer.drain()
        assert await stream.reader.readexactly(5 + len(SECRET)) == (
            b"echo:" + SECRET)
        assert received == [SECRET]
        stream.close()
        for blob in (bytes(tap.c2s), bytes(tap.s2c)):
            assert SECRET not in blob
            assert b"echo:" not in blob
            assert b"launch" not in blob
    finally:
        await client.close()
        await tap.stop()
        await server.close()


async def _tampered():
    server, tap, tap_port, client, received = await _echo_topology()
    try:
        stream = await client.new_stream(f"127.0.0.1:{tap_port}", PROTO)
        handshake_len = len(tap.c2s)
        stream.writer.write(SECRET)
        await stream.writer.drain()
        await stream.reader.readexactly(5 + len(SECRET))
        stream.close()
        tap.c2s.clear()
        tap.s2c.clear()
        tap.corrupt_after_c2s = handshake_len + 10
        stream2 = await client.new_stream(f"127.0.0.1:{tap_port}", PROTO)
        stream2.writer.write(SECRET)
        await stream2.writer.drain()
        with pytest.raises(DEAD):
            data = await asyncio.wait_for(
                stream2.reader.readexactly(5 + len(SECRET)), 5.0)
            raise AssertionError(f"tampered frame accepted: {data!r}")
        assert len(received) == 1
        stream2.close()
    finally:
        await client.close()
        await tap.stop()
        await server.close()


async def _replayed():
    server, tap, tap_port, client, received = await _echo_topology()

    async def collect_handler(stream):
        try:
            while True:
                data = await stream.reader.readexactly(len(SECRET))
                received.append(data)
                stream.writer.write(b"echo:" + data)
                await stream.writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass

    server.set_stream_handler(PROTO, collect_handler)
    try:
        stream = await client.new_stream(f"127.0.0.1:{tap_port}", PROTO)
        tap.replay_after_c2s = len(tap.c2s)
        stream.writer.write(SECRET)
        await stream.writer.drain()
        assert await stream.reader.readexactly(5 + len(SECRET)) == (
            b"echo:" + SECRET)
        with pytest.raises(DEAD):
            await asyncio.wait_for(
                stream.reader.readexactly(5 + len(SECRET)), 5.0)
        assert received == [SECRET]
        stream.close()
    finally:
        await client.close()
        await tap.stop()
        await server.close()


@pytest.mark.parametrize("case", [_no_plaintext, _tampered, _replayed],
                         ids=["no_plaintext", "tampered", "replayed"])
def test_wire_cases_against_the_port(case):
    asyncio.run(asyncio.wait_for(case(), DEADLINE))


class _Sink:
    def __init__(self):
        self.buf = bytearray()

    def write(self, data):
        self.buf.extend(data)

    def write_eof(self):
        pass


def _reader(data: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    return r


def test_roundtrip_truncation_and_jax_interop():
    """Port writer -> JAX reader and back, bytes equal for the same key;
    a frame cut in half is refused."""
    key = bytes(range(32))

    async def go():
        big = b"x" * (300 * 1024)  # spans two frames
        sinks = {}
        for name, mod in (("torch", tsecure), ("jax", jsecure)):
            sink = _Sink()
            w = mod.SecureWriter(sink, key)
            w.write(b"hello")
            w.write(big)
            w.write_eof()
            sinks[name] = bytes(sink.buf)
        if jsecure.HAVE_CRYPTOGRAPHY:
            assert sinks["torch"] == sinks["jax"]
            jr = jsecure.SecureReader(_reader(sinks["torch"]), key)
            assert await jr.readexactly(5) == b"hello"
            assert await jr.read(-1) == big
        tr = tsecure.SecureReader(_reader(sinks["torch"]), key)
        assert await tr.readexactly(5) == b"hello"
        assert await tr.read(-1) == big
        assert tr.at_eof()
        sink = _Sink()
        tsecure.SecureWriter(sink, key).write(b"secret payload")
        cut = tsecure.SecureReader(_reader(bytes(sink.buf[:len(sink.buf) // 2])),
                                   key)
        with pytest.raises(tsecure.TamperError):
            await cut.readexactly(5)

    asyncio.run(go())


def test_unauthenticated_fin_rejected_for_read_to_eof():
    key = bytes(range(32))

    async def go():
        sink = _Sink()
        tsecure.SecureWriter(sink, key).write(b"partial metadata")
        with pytest.raises(tsecure.TamperError, match="authenticated close"):
            await tsecure.SecureReader(_reader(bytes(sink.buf)), key).read(-1)
        sink = _Sink()
        w = tsecure.SecureWriter(sink, key)
        w.write(b"partial metadata")
        w._frame(b"")
        assert await tsecure.SecureReader(
            _reader(bytes(sink.buf)), key).read(-1) == b"partial metadata"
        sink = _Sink()
        tsecure.SecureWriter(sink, key).write(b"x" * 10)
        r = tsecure.SecureReader(_reader(bytes(sink.buf)), key)
        assert await r.read(10) == b"x" * 10
        with pytest.raises(tsecure.TamperError, match="authenticated close"):
            await r.read(10)

    asyncio.run(go())


def test_key_files_cross_packages(tmp_path):
    jkm = jkeys.KeyManager(tmp_path / "jax")
    jpid = jkeys.peer_id_from_public_key(
        jkm.get_or_create_private_key("worker").public_key())
    assert tkeys.KeyManager(tmp_path / "jax").peer_id("worker") == jpid
    tkm = tkeys.KeyManager(tmp_path / "torch")
    tpid = tkeys.peer_id_from_public_key(
        tkm.get_or_create_private_key("worker").public_key())
    assert jkeys.KeyManager(tmp_path / "torch").peer_id("worker") == tpid
    assert (tmp_path / "torch" / "worker.key").stat().st_mode & 0o777 == 0o600
    assert tkeys.peer_id_to_dht_id(tpid) == jkeys.peer_id_to_dht_id(tpid)
