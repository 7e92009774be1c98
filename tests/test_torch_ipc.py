"""The port's IPC server (``crowdllama_tpu_torch/ipc/server.py``).

- Parity: the JAX ``IPCServer`` over ``JaxEngine`` and the port's over
  ``TorchEngine`` (the permutation checkpoint, as in
  ``test_torch_handle.py``) are fed the same bytes on a real Unix socket:
  JSON ``ping``, ``initialize``, ``prompt`` (and one for a model not
  served), ``status``, an unknown type and a garbage line give
  byte-identical reply lines; ``embed`` vectors agree within 1e-5; PB
  GenerateRequest and EmbedRequest frames give replies equal field by
  field but ``created_at`` and ``total_duration``.  A frame header over
  the cap drops that connection on both; the server keeps serving.
- ``tests/test_ipc.py``'s cases against the port's ``FakeEngine``: PB
  round trip, the JSON types, socket mode 0600, the garbage line, embed;
  and ``profile`` (refused without ``capture_profile`` or
  ``profile_dir``, a trace directory with them).
"""

import asyncio
import json
import stat
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu.core import messages as jmessages  # noqa: E402
from crowdllama_tpu.core import wire as jwire  # noqa: E402
from crowdllama_tpu_torch.core import wire as twire  # noqa: E402
from crowdllama_tpu_torch.core.messages import (  # noqa: E402
    create_generate_request,
    extract_generate_response,
)
from crowdllama_tpu_torch.engine.engine import FakeEngine, TorchEngine  # noqa: E402
from crowdllama_tpu_torch.ipc.server import IPCServer  # noqa: E402

EMBED_ATOL = 1e-5


def _line(obj) -> bytes:
    return json.dumps(obj).encode() + b"\n"


def _frame(msg) -> bytes:
    return jwire.encode_frame(msg)


# (name, bytes sent, reply kind)
EXCHANGES = [
    ("ping", _line({"type": "ping"}), "json"),
    ("initialize", _line({"type": "initialize", "mode": "worker"}), "json"),
    ("prompt", _line({"type": "prompt", "text": "abc",
                      "model": "tiny-test"}), "json"),
    ("prompt_no_model", _line({"type": "prompt", "prompt": "the fox"}),
     "json"),
    ("prompt_bad_model", _line({"type": "prompt", "text": "x",
                                "model": "nope"}), "json"),
    ("status", _line({"type": "status"}), "json"),
    ("unknown", _line({"type": "bogus"}), "json"),
    ("garbage", b"{garbage that is not json\n", "json"),
    ("short", b"{}\n", "json"),
    ("embed", _line({"type": "embed", "model": "tiny-test",
                     "input": ["alpha", "beta gamma"]}), "json"),
    ("embed_text", _line({"type": "embed", "text": "one"}), "json"),
    ("pb_generate", _frame(jmessages.create_generate_request(
        "tiny-test", "the quick brown fox", max_tokens=8)), "pb"),
    ("pb_seeded", _frame(jmessages.create_generate_request(
        "tiny-test", "seeded", max_tokens=8, temperature=0.8, seed=1234)),
     "pb"),
    ("pb_embed", _frame(jmessages.create_embed_request(
        "tiny-test", ["alpha", "beta"])), "pb"),
    ("profile", _line({"type": "profile", "seconds": 0.1}), "json"),
]


async def _exchange(sock: str, decode) -> dict:
    replies = {}
    reader, writer = await asyncio.open_unix_connection(sock)
    try:
        for name, data, kind in EXCHANGES:
            writer.write(data)
            await writer.drain()
            if kind == "json":
                replies[name] = await asyncio.wait_for(reader.readline(), 60)
            else:
                replies[name] = await asyncio.wait_for(
                    jwire.read_frame_payload(reader), 60)
        # A header over the cap: that connection is dropped ...
        writer.write(struct.pack(">I", twire.MAX_MESSAGE_SIZE + 1))
        await writer.drain()
        replies["oversized"] = await asyncio.wait_for(reader.read(), 10)
    finally:
        writer.close()
    # ... and the server keeps serving.
    reader, writer = await asyncio.open_unix_connection(sock)
    try:
        writer.write(_line({"type": "ping"}))
        await writer.drain()
        replies["after"] = await asyncio.wait_for(reader.readline(), 10)
    finally:
        writer.close()
    return replies


def _fields(payload: bytes, decode) -> dict:
    from test_torch_handle import _fields as fields

    return fields(decode(payload))


@pytest.fixture(scope="module")
def ipc_replies(tmp_path_factory):
    from crowdllama_tpu.ipc.server import IPCServer as JaxIPCServer

    from test_torch_handle import _engines, _perm

    tmp = tmp_path_factory.mktemp("ipc")
    ckpt, flat = _perm(tmp)
    jeng, teng = _engines(ckpt, flat)

    async def go(engine, server_cls, decode, sock):
        await engine.start()
        srv = server_cls(str(tmp / sock), engine)
        await srv.start()
        try:
            return await _exchange(str(tmp / sock), decode)
        finally:
            await srv.stop()
            await engine.stop()

    want = asyncio.run(go(jeng, JaxIPCServer, jwire.decode_payload,
                          "jax.sock"))
    got = asyncio.run(go(teng, IPCServer, twire.decode_payload,
                         "torch.sock"))
    return want, got


@pytest.mark.parametrize("name", [n for n, _, _ in EXCHANGES]
                         + ["oversized", "after"])
def test_ipc_replies_match_the_jax_server(ipc_replies, name):
    want, got = ipc_replies
    kind = dict((n, k) for n, _, k in EXCHANGES).get(name, "json")
    if name.startswith("embed"):
        w, t = json.loads(want[name]), json.loads(got[name])
        wv, tv = w.pop("embeddings"), t.pop("embeddings")
        assert t == w and t["type"] == "embeddings"
        np.testing.assert_allclose(np.array(tv), np.array(wv),
                                   atol=EMBED_ATOL, rtol=0)
    elif kind == "pb":
        w = _fields(want[name], jwire.decode_payload)
        t = _fields(got[name], twire.decode_payload)
        if name == "pb_embed":
            assert len(t["embeddings"]) == 2
            np.testing.assert_allclose(np.array(t.pop("embeddings")),
                                       np.array(w.pop("embeddings")),
                                       atol=EMBED_ATOL, rtol=0)
        assert t == w
    elif name == "profile":
        # Neither engine has a profile_dir.
        assert got[name] == want[name] == (
            b'{"type":"error","error":"profiling disabled: set profile_dir '
            b'(--profile-dir / CROWDLLAMA_TPU_PROFILE_DIR)"}\n')
    else:
        assert got[name] == want[name]
    if name == "oversized":
        assert got[name] == b""
    if name == "prompt":
        # The permutation model walks the bytes on from the prompt's last.
        assert json.loads(got[name])["response"].startswith("defghijk")


# ------------------------------------------ tests/test_ipc.py, ported

async def _ask(reader, writer, obj):
    writer.write(json.dumps(obj).encode() + b"\n")
    await writer.drain()
    return json.loads(await asyncio.wait_for(reader.readline(), 5))


async def test_pb_roundtrip(tmp_path):
    sock = str(tmp_path / "ipc.sock")
    srv = IPCServer(sock, FakeEngine(models=["m"]))
    await srv.start()
    try:
        reader, writer = await asyncio.open_unix_connection(sock)
        writer.write(twire.encode_frame(create_generate_request(
            "m", "hello ipc")))
        await writer.drain()
        resp = extract_generate_response(
            await twire.read_length_prefixed_pb(reader, timeout=5))
        assert resp.response == "echo: hello ipc" and resp.done
        writer.close()
    finally:
        await srv.stop()


async def test_json_ping_initialize_prompt_status(tmp_path):
    sock = str(tmp_path / "ipc.sock")
    srv = IPCServer(sock, FakeEngine(models=["m"]))
    await srv.start()
    try:
        reader, writer = await asyncio.open_unix_connection(sock)
        assert (await _ask(reader, writer, {"type": "ping"}))["type"] == (
            "pong")
        init = await _ask(reader, writer, {"type": "initialize",
                                           "mode": "worker"})
        assert init == {"type": "initialized", "mode": "worker",
                        "peer_id": ""}
        resp = await _ask(reader, writer, {"type": "prompt", "text": "hi"})
        assert resp == {"type": "response", "response": "echo: hi",
                        "done": True}
        assert await _ask(reader, writer, {"type": "status"}) == {
            "type": "status", "peer_id": "", "workers": []}
        err = await _ask(reader, writer, {"type": "bogus"})
        assert err == {"type": "error", "error": "unknown type 'bogus'"}
        writer.close()
    finally:
        await srv.stop()


async def test_socket_permissions(tmp_path):
    sock = tmp_path / "sub" / "ipc.sock"
    srv = IPCServer(str(sock), FakeEngine())
    await srv.start()
    try:
        assert stat.S_IMODE(sock.stat().st_mode) == 0o600
        await srv.stop()
        assert not sock.exists()
        sock.write_text("stale")  # a leftover file is replaced
        await srv.start()
        assert stat.S_ISSOCK(sock.stat().st_mode)
    finally:
        await srv.stop()


async def test_garbage_line(tmp_path):
    sock = str(tmp_path / "ipc.sock")
    srv = IPCServer(sock, FakeEngine())
    await srv.start()
    try:
        reader, writer = await asyncio.open_unix_connection(sock)
        writer.write(b"{garbage that is not json\n")
        await writer.drain()
        reply = json.loads(await asyncio.wait_for(reader.readline(), 5))
        assert reply == {"type": "error", "error": "unparseable message"}
        writer.close()
    finally:
        await srv.stop()


async def test_json_embed_and_profile(tmp_path):
    sock = str(tmp_path / "ipc.sock")
    srv = IPCServer(sock, FakeEngine(models=["m"]))
    await srv.start()
    try:
        reader, writer = await asyncio.open_unix_connection(sock)
        reply = await _ask(reader, writer, {"type": "embed", "model": "m",
                                            "input": ["alpha", "beta"]})
        assert reply["type"] == "embeddings"
        assert len(reply["embeddings"]) == 2
        assert reply["embeddings"][0] != reply["embeddings"][1]
        assert reply["prompt_tokens"] > 0
        assert await _ask(reader, writer, {"type": "profile"}) == {
            "type": "error", "error": "engine does not support profiling"}
        writer.close()
    finally:
        await srv.stop()


async def test_undecodable_frame_drops_only_that_connection(tmp_path):
    sock = str(tmp_path / "ipc.sock")
    srv = IPCServer(sock, FakeEngine(models=["m"]))
    await srv.start()
    try:
        for bad in (b"\x00\x00\x00\x03\x0a\x05a",   # length past the end
                    b"\x00\x00\x00\x00",            # empty frame
                    b"\x00\x00\x00\x02\x12\xc3"):   # truncated submessage
            reader, writer = await asyncio.open_unix_connection(sock)
            writer.write(bad)
            await writer.drain()
            assert await asyncio.wait_for(reader.read(), 5) == b""
            writer.close()
        reader, writer = await asyncio.open_unix_connection(sock)
        assert (await _ask(reader, writer, {"type": "ping"}))["type"] == (
            "pong")
        writer.close()
    finally:
        await srv.stop()


async def test_profile_over_ipc_writes_a_trace(tmp_path):
    engine = TorchEngine(device="cpu", dtype=torch.float32, model="tiny-test",
                         max_context_length=256, kv_page_size=16,
                         max_batch_slots=2, warmup=False,
                         profile_dir=str(tmp_path / "prof"))
    await engine.start()
    sock = str(tmp_path / "ipc.sock")
    srv = IPCServer(sock, engine)
    await srv.start()
    try:
        reader, writer = await asyncio.open_unix_connection(sock)
        reply = await _ask(reader, writer, {"type": "profile",
                                            "seconds": 0.1})
        assert reply["type"] == "profile"
        traces = list((tmp_path / "prof").rglob("*.pt.trace.json"))
        assert [str(t.parent) for t in traces] == [reply["trace_dir"]]
        writer.close()
    finally:
        await srv.stop()
        await engine.stop()
