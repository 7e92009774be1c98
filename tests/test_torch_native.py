"""The port's native data plane (``crowdllama_tpu_torch/native``) against
its Python paths and the JAX package's native library, on the same
inputs (numpy-seeded or drawn by hypothesis).

- AEAD: the port's native ChaCha20-Poly1305 frames equal the port's
  Python path (``utils/crypto.py``, as ``SecureWriter`` seals) and JAX's
  ``AeadSession(..., FLAVOR_CHACHA)`` at lengths 0, 1, ``CHUNK`` +- 1,
  several chunks, with and without the EOF frame; the one-shot seal
  reproduces ``net/crypto_golden.py`` (the ``cryptography`` package's
  bytes); a tampered frame opens to None and advances the counter as
  JAX's does and as the Python reader does.
- The frame scanner: native = Python = JAX's, on partial and oversized
  frames.
- The envelopes: ``encode_genresp_frame`` / ``encode_genreq_frame``
  equal protobuf (``llama_v1_pb2``) and the port's codec on every field
  (unicode, empty, ``done_reason`` cleared when not done);
  ``decode_payload_fast`` returns the codec's fields.
- The routing table: the native table, the port's Python table and JAX's
  native table run one random sequence of upsert, evict, remove, closest
  and dump alike.
- Both paths: the secure-stream cases of ``test_torch_secure.py`` pass
  with and without ``CROWDLLAMA_NO_NATIVE=1``; ``/metrics`` shows the
  native families; ``load()`` under a running loop builds off the loop.
"""

import asyncio
import contextlib
import ctypes
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_secure import (
    _exchange,
    _no_plaintext,
    _replayed,
    _tampered,
)

from crowdllama_tpu import native as jnative
from crowdllama_tpu.core import llama_v1_pb2 as jpb
from crowdllama_tpu.core import wire as jwire
from crowdllama_tpu.net import dht as jdht
from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.core import llama_v1 as tpb
from crowdllama_tpu_torch.core import messages as tmessages
from crowdllama_tpu_torch.core import wire as twire
from crowdllama_tpu_torch.net import crypto_golden
from crowdllama_tpu_torch.net import dht as tdht
from crowdllama_tpu_torch.net import secure as tsecure
from crowdllama_tpu_torch.net.host import Contact
from crowdllama_tpu_torch.obs.http import native_metric_lines
from crowdllama_tpu_torch.utils.crypto import ChaCha20Poly1305

LIB = native.load()
JLIB = jnative.load()
CHUNK = tsecure.CHUNK
LENGTHS = [0, 1, 63, 64, 65, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 7]
pytestmark = pytest.mark.skipif(
    LIB is None or JLIB is None,
    reason=f"native library did not build: {native.stats()['build_error']}")


@contextlib.contextmanager
def _python_path():
    """CROWDLLAMA_NO_NATIVE=1 for the block (usable under hypothesis,
    where a function-scoped monkeypatch is not)."""
    old = os.environ.get("CROWDLLAMA_NO_NATIVE")
    os.environ["CROWDLLAMA_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["CROWDLLAMA_NO_NATIVE"]
        else:
            os.environ["CROWDLLAMA_NO_NATIVE"] = old


def _key(seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(32)


def _py_seal_frames(aead, ctr: int, data: bytes, chunk: int,
                    with_eof: bool) -> tuple[bytes, int]:
    """What the Python ``SecureWriter`` puts on the wire: one sealed frame
    per ``chunk`` of ``data`` under the next counter, then the empty
    frame if ``with_eof``."""
    out = bytearray()
    pieces = [data[o:o + chunk] for o in range(0, len(data), chunk)]
    if with_eof:
        pieces.append(b"")
    for piece in pieces:
        ct = aead.encrypt(ctr.to_bytes(12, "big"), piece, None)
        ctr += 1
        out += len(ct).to_bytes(4, "big") + ct
    return bytes(out), ctr


def _seal_both(key: bytes, cases) -> list[tuple[bytes, bytes, bytes]]:
    """(port native, JAX native, Python) wire bytes of each
    ``(data, chunk, with_eof)`` case, sealed in order on one session each
    so the counters advance across cases."""
    tn = native.AeadSession(LIB, key)
    jn = jnative.AeadSession(JLIB, key, jnative.FLAVOR_CHACHA)
    aead, ctr = ChaCha20Poly1305(key), 0
    out = []
    for data, chunk, with_eof in cases:
        py, ctr = _py_seal_frames(aead, ctr, data, chunk, with_eof)
        out.append((tn.seal_frames(data, chunk, with_eof),
                    jn.seal_frames(data, chunk, with_eof), py))
    assert tn.counter == jn.counter == ctr
    return out


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("with_eof", [False, True], ids=["data", "eof"])
def test_aead_frames_equal_python_and_jax(n, with_eof):
    rng = np.random.default_rng(n)
    data = rng.bytes(n)
    if n == 0 and not with_eof:
        with_eof = True  # an empty write is the close frame alone
    for tn, jn, py in _seal_both(_key(n), [(data, CHUNK, with_eof),
                                           (data[:17], CHUNK, False)]):
        assert tn == jn == py


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(sizes=st.lists(st.integers(0, 700), min_size=1, max_size=6),
       chunk=st.sampled_from([1, 16, 64, 257]),
       eofs=st.lists(st.booleans(), min_size=6, max_size=6),
       seed=st.integers(0, 2**16))
def test_aead_frames_at_random_chunks(sizes, chunk, eofs, seed):
    rng = np.random.default_rng(seed)
    cases = [(rng.bytes(n), chunk, eof or n == 0)
             for n, eof in zip(sizes, eofs)]
    for tn, jn, py in _seal_both(_key(seed), cases):
        assert tn == jn == py


def test_one_shot_seal_reproduces_the_goldens():
    prims = crypto_golden.port_primitives()
    prims.aead_encrypt = lambda k, n, d, a: native.seal_raw(k, n, d, a or b"")
    got = crypto_golden.vectors(prims)
    aead = {k: v for k, v in got.items() if k.startswith("aead_")}
    assert len(aead) == 2 * len(crypto_golden.AEAD_SIZES)
    assert aead == {k: crypto_golden.VECTORS[k] for k in aead}


def _frames(wire: bytes) -> list[bytes]:
    out, pos = [], 0
    while pos < len(wire):
        n = int.from_bytes(wire[pos:pos + 4], "big")
        out.append(wire[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


@pytest.mark.parametrize("where", ["tag", "body", "length"])
def test_tampered_frame_opens_to_none_and_advances_the_counter(where):
    key = _key(7)
    rng = np.random.default_rng(7)
    msgs = [rng.bytes(n) for n in (40, 300, 5)]
    sealed = native.AeadSession(LIB, key).seal_frames(b"".join(msgs), 40)
    frames = _frames(sealed)
    bad = bytearray(frames[1])
    if where == "tag":
        bad[-1] ^= 1
    elif where == "body":
        bad[3] ^= 0x80
    else:
        bad = bad[:-1]
    frames[1] = bytes(bad)
    tn = native.AeadSession(LIB, key)
    jn = jnative.AeadSession(JLIB, key, jnative.FLAVOR_CHACHA)
    got_t = [tn.open(f) for f in frames]
    got_j = [jn.open(f) for f in frames]
    assert got_t == got_j
    assert got_t[0] == msgs[0][:40] and got_t[1] is None
    # The counter moved past the bad frame, so the next frame opens under
    # the right nonce.
    assert got_t[2] == b"".join(msgs)[80:120]
    assert tn.counter == jn.counter == len(frames)


@pytest.mark.parametrize("no_native", ["0", "1"])
def test_reader_counters_agree_on_a_bad_tag(monkeypatch, no_native):
    """Both paths of ``SecureReader`` advance the counter on a failed tag
    and raise ``TamperError``."""
    monkeypatch.setenv("CROWDLLAMA_NO_NATIVE", no_native)
    key = _key(9)
    sealed = native.AeadSession(LIB, key).seal_frames(b"x" * 30, 10)
    frames = _frames(sealed)
    frames[1] = frames[1][:-1] + bytes([frames[1][-1] ^ 1])
    wire = b"".join(len(f).to_bytes(4, "big") + f for f in frames)

    async def go():
        r = asyncio.StreamReader()
        r.feed_data(wire)
        r.feed_eof()
        reader = tsecure.SecureReader(r, key)
        assert (reader._native is None) == (no_native == "1")
        first = await reader.readexactly(10)
        with pytest.raises(tsecure.TamperError):
            await reader.readexactly(10)
        return first, reader.counter

    assert asyncio.run(go()) == (b"x" * 10, 2)


# ----------------------------------------------------------- frame scanner


def _scan_all(buf: bytes, monkeypatch):
    out = {"native": twire.scan_frames(buf), "jax": jwire.scan_frames(buf)}
    with monkeypatch.context() as m:
        m.setenv("CROWDLLAMA_NO_NATIVE", "1")
        out["python"] = twire.scan_frames(buf)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_scan_frames_native_python_and_jax_agree(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    payloads = [rng.bytes(int(n)) for n in rng.integers(0, 300, 7)]
    buf = b"".join(len(p).to_bytes(4, "big") + p for p in payloads)
    cut = int(rng.integers(0, len(buf) + 1))
    before = native.stats()["fallbacks"].get("frame_scan", 0)
    got = _scan_all(buf[:cut], monkeypatch)
    assert got["native"] == got["python"] == got["jax"]
    if cut == len(buf):
        assert got["native"] == (payloads, len(buf))
    assert native.stats()["fallbacks"].get("frame_scan", 0) == before + 1


def test_scan_frames_refuses_an_oversized_frame_alike(monkeypatch):
    ok = (3).to_bytes(4, "big") + b"abc"
    big = (twire.MAX_MESSAGE_SIZE + 1).to_bytes(4, "big")
    for buf in (big, ok + big):
        with pytest.raises(twire.WireError):
            twire.scan_frames(buf)
        with pytest.raises(jwire.WireError):
            jwire.scan_frames(buf)
        with monkeypatch.context() as m:
            m.setenv("CROWDLLAMA_NO_NATIVE", "1")
            with pytest.raises(twire.WireError):
                twire.scan_frames(buf)
    edge = twire.MAX_MESSAGE_SIZE.to_bytes(4, "big") + b"x"
    assert _scan_all(edge, monkeypatch)["native"] == ([], 0)


# --------------------------------------------------------------- envelopes

TEXT = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
               max_size=40)
I32 = st.integers(0, 2**31 - 1)


def _pb_genresp(f: dict) -> bytes:
    resp = jpb.GenerateResponse(
        model=f["model"], response=f["response"], done=f["done"],
        done_reason=f["done_reason"] if f["done"] else "",
        worker_id=f["worker_id"], total_duration=f["total"],
        prompt_tokens=f["pt"], completion_tokens=f["ct"])
    resp.created_at.FromNanoseconds(f["created"])
    msg = jpb.BaseMessage(generate_response=resp)
    msg.trace_id, msg.parent_span = f["trace_id"], f["parent_span"]
    payload = msg.SerializeToString()
    return len(payload).to_bytes(4, "big") + payload


GENRESP = st.fixed_dictionaries({
    "model": TEXT, "response": TEXT | st.just("é" * 3000),
    "worker_id": TEXT, "done": st.booleans(), "done_reason": TEXT,
    "total": st.integers(0, 2**62), "pt": I32, "ct": I32,
    "created": st.integers(0, 2**62), "trace_id": TEXT,
    "parent_span": TEXT})


@settings(max_examples=150, deadline=None)
@given(f=GENRESP)
def test_genresp_frames_equal_protobuf_and_the_codec(f):
    kw = dict(model=f["model"], response=f["response"],
              worker_id=f["worker_id"], done=f["done"],
              done_reason=f["done_reason"], total_duration_ns=f["total"],
              prompt_tokens=f["pt"], completion_tokens=f["ct"],
              created_ns=f["created"], trace_id=f["trace_id"],
              parent_span=f["parent_span"])
    nat = twire.encode_genresp_frame(**kw)
    with _python_path():
        codec = tmessages.genresp_frame_bytes(**kw)
    assert nat == codec == _pb_genresp(f)
    assert tmessages.genresp_frame_bytes(**kw) == nat
    fast = twire.decode_payload_fast(nat[4:])
    slow = twire.decode_payload(nat[4:])
    a, b = fast.generate_response, slow.generate_response
    for name in ("model", "response", "done", "done_reason", "worker_id",
                 "total_duration", "prompt_tokens", "completion_tokens"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.created_at.ToNanoseconds() == b.created_at.ToNanoseconds()
    assert (fast.trace_id, fast.parent_span) == (slow.trace_id,
                                                  slow.parent_span)
    assert isinstance(fast, twire.FastBaseMessage)


MSG = st.fixed_dictionaries({"role": TEXT, "content": TEXT})
F32 = st.floats(allow_nan=False, allow_infinity=False, width=32).filter(
    lambda v: not (v == 0.0 and str(v).startswith("-")))
GENREQ = st.fixed_dictionaries({
    "model": TEXT, "prompt": TEXT, "stream": st.booleans(),
    "messages": st.lists(MSG, max_size=4), "max_tokens": I32,
    "temperature": F32, "top_p": F32, "seed": st.integers(0, 2**64 - 1),
    "stop": st.lists(TEXT, max_size=3), "top_k": I32,
    "repeat_penalty": F32, "kv_donor": TEXT, "migrate": st.booleans(),
    "trace_id": TEXT, "parent_span": TEXT})


def _genreq_msg(mod, f: dict):
    req = mod.GenerateRequest(
        model=f["model"], prompt=f["prompt"], stream=f["stream"],
        max_tokens=f["max_tokens"], temperature=f["temperature"],
        top_p=f["top_p"], seed=f["seed"], top_k=f["top_k"],
        repeat_penalty=f["repeat_penalty"], kv_donor=f["kv_donor"],
        migrate=f["migrate"], stop=list(f["stop"]),
        messages=[mod.ChatMessage(role=m["role"], content=m["content"])
                  for m in f["messages"]])
    msg = mod.BaseMessage(generate_request=req)
    msg.trace_id, msg.parent_span = f["trace_id"], f["parent_span"]
    payload = msg.SerializeToString()
    return len(payload).to_bytes(4, "big") + payload


@settings(max_examples=150, deadline=None)
@given(f=GENREQ)
def test_genreq_frames_equal_protobuf_and_the_codec(f):
    nat = twire.encode_genreq_frame(**{k: (tuple(v) if isinstance(v, list)
                                           else v) for k, v in f.items()})
    assert nat == _genreq_msg(jpb, f) == _genreq_msg(tpb, f)


def test_genreq_values_the_c_encoder_does_not_model_fall_back():
    assert twire.encode_genreq_frame("m", temperature=-0.0) is None
    assert twire.encode_genreq_frame("m", seed=-1) is None
    assert twire.encode_genreq_frame("m", max_tokens=2**31) is None
    assert twire.encode_genreq_frame(
        "m", messages=({"role": 1, "content": "x"},)) is None


def test_decode_fast_defers_every_other_shape():
    big = "x" * 4096
    req = _genreq_msg(tpb, dict(
        model="m", prompt=big, stream=False, messages=[], max_tokens=0,
        temperature=0.0, top_p=0.0, seed=0, stop=[], top_k=0,
        repeat_penalty=0.0, kv_donor="", migrate=False, trace_id="t",
        parent_span=""))[4:]
    got = twire.decode_payload_fast(req)
    assert isinstance(got, tpb.BaseMessage)
    assert got.generate_request.prompt == big
    # An unknown field after the arm: the strict decoder refuses it, the
    # codec skips it, and the values are the codec's.
    resp = twire.encode_genresp_frame("m", big, trace_id="t")[4:]
    odd = resp + b"\x78\x01"
    got = twire.decode_payload_fast(odd)
    assert isinstance(got, tpb.BaseMessage)
    assert got.generate_response.response == big and got.trace_id == "t"
    assert isinstance(twire.decode_payload_fast(resp),
                      twire.FastBaseMessage)


# ----------------------------------------------------------- routing table


def _peer_ids(rng, n: int) -> list[str]:
    return [rng.bytes(20).hex() for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_routing_tables_run_one_sequence_alike(seed):
    rng = np.random.default_rng(seed)
    self_id = rng.bytes(32)
    k = int(rng.integers(1, 5))
    tables = {"native": tdht.NativeRoutingTable(self_id, k, lib=LIB),
              "python": tdht.PyRoutingTable(self_id, k),
              "jax": jdht.NativeRoutingTable(self_id, k, lib=JLIB)}
    contacts = {"jax": jdht.Contact, "native": Contact, "python": Contact}
    ids = _peer_ids(rng, 120)

    def view(name, t):
        return [c.peer_id for c in t.contacts()], len(t)

    for step in range(600):
        op = rng.choice(["upsert", "upsert", "upsert", "remove", "closest"])
        pid = ids[int(rng.integers(0, len(ids)))]
        port = int(rng.integers(1, 65535))
        for name, t in tables.items():
            if op == "upsert":
                t.update(contacts[name](pid, "127.0.0.1", port))
            elif op == "remove":
                t.remove(pid)
        if op == "closest":
            target = rng.bytes(32)
            kk = int(rng.integers(1, 30))
            got = {n: [c.peer_id for c in t.closest(target, kk)]
                   for n, t in tables.items()}
            assert got["native"] == got["python"] == got["jax"], step
        views = {n: view(n, t) for n, t in tables.items()}
        assert views["native"] == views["python"] == views["jax"], step
    assert len(tables["native"]) > k  # buckets filled and evicted


def test_the_dht_uses_the_native_table():
    assert isinstance(tdht.RoutingTable(b"\0" * 32), tdht.NativeRoutingTable)


# ------------------------------------------------------------- both paths


@pytest.mark.parametrize("no_native", ["0", "1"], ids=["native", "python"])
@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_handshake_and_frames_on_both_paths(monkeypatch, no_native, server,
                                            client):
    monkeypatch.setenv("CROWDLLAMA_NO_NATIVE", no_native)
    out = asyncio.run(asyncio.wait_for(_exchange(server, client), 30))
    assert out["echo"] == {"echo": {"x": [1, "é"]}}
    assert out["reply"] == "reply to héllo"


@pytest.mark.parametrize("no_native", ["0", "1"], ids=["native", "python"])
@pytest.mark.parametrize("case", [_no_plaintext, _tampered, _replayed],
                         ids=lambda c: c.__name__.strip("_"))
def test_wire_cases_on_both_paths(monkeypatch, no_native, case):
    monkeypatch.setenv("CROWDLLAMA_NO_NATIVE", no_native)
    before = native.stats()["fallbacks"].get("aead", 0)
    asyncio.run(asyncio.wait_for(case(), 30))
    moved = native.stats()["fallbacks"].get("aead", 0) - before
    assert (moved > 0) == (no_native == "1")


def test_native_families_on_metrics(monkeypatch):
    lines = native_metric_lines()
    assert "crowdllama_native_enabled 1" in lines
    assert {ln.split("{")[0].split(" ")[0] for ln in lines
            if ln.startswith("crowdllama")} \
        == {"crowdllama_native_enabled", "crowdllama_native_fallbacks_total"}
    for comp in ("aead", "envelope", "frame_scan"):
        assert any(f'component="{comp}"' in ln for ln in lines)
    monkeypatch.setenv("CROWDLLAMA_NO_NATIVE", "1")
    assert not native.native_enabled()
    assert twire.encode_genresp_frame("m", "r") is None
    lines = native_metric_lines()
    assert "crowdllama_native_enabled 0" in lines
    env = [ln for ln in lines if 'component="envelope"' in ln][0]
    assert int(env.rsplit(" ", 1)[1]) >= 1


def test_first_build_under_a_running_loop_goes_off_the_loop(
        monkeypatch, tmp_path):
    """``load()`` on a loop thread with no built library starts the build
    on a thread and returns None; the library serves once it is built."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native._reset_for_tests()
    try:
        async def go():
            first = native.load()
            thread = native._bg_build
            assert first is None and thread is not None
            while thread.is_alive():
                await asyncio.sleep(0.05)
            return native.load()

        lib = asyncio.run(go())
        assert lib is not None and native.native_enabled()
        assert list(tmp_path.glob("crowdllama_native-*.so"))
        assert not list(tmp_path.glob("*.tmp.*"))
    finally:
        monkeypatch.undo()
        native._reset_for_tests()
        assert native.ensure_built()


def test_library_exports_what_the_port_declares():
    for name in ("cl_frame_scan", "cl_rt_new", "cl_aead_new",
                 "cl_aead_seal_frames", "cl_aead_open",
                 "cl_env_encode_genresp",
                 "cl_env_encode_genreq", "cl_env_decode_genresp"):
        assert isinstance(getattr(LIB, name), ctypes._CFuncPtr)
