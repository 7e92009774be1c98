"""The port's llama.v1 codec and framing (``crowdllama_tpu_torch/core``)
against protobuf and the JAX package's wire layer.

- Random instances of every message of the schema (hypothesis): the
  port's bytes equal protobuf's ``SerializeToString``; protobuf parses the
  port's bytes back to the instance; the port decodes protobuf's bytes to
  the same fields.
- Random byte strings: the port refuses exactly what protobuf refuses and
  otherwise decodes the same fields.
- The wire facts one by one: field order, empty arms, ``-0.0``, negative
  int32, uint64 2^64-1, non-ASCII strings, packed and unpacked repeated
  scalars, unknown fields, the last of repeated singular scalars, merged
  submessages, truncated input, invalid UTF-8, oversized frames.
- ``core/wire_golden.py``: the JAX package's messages give the golden
  bytes, and so do the port's; the framing helpers over real sockets.
"""

import asyncio
import socket
import struct

import pytest
from google.protobuf import timestamp_pb2
from google.protobuf.message import DecodeError as PbDecodeError
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from crowdllama_tpu.core import llama_v1_pb2 as jpb
from crowdllama_tpu.core import messages as jmessages
from crowdllama_tpu.core import wire as jwire
from crowdllama_tpu_torch.core import llama_v1 as tpb
from crowdllama_tpu_torch.core import messages as tmessages
from crowdllama_tpu_torch.core import wire as twire
from crowdllama_tpu_torch.core import wire_golden

NAMES = sorted(tpb.MESSAGES)


def _pb_class(full_name: str):
    if full_name == "google.protobuf.Timestamp":
        return timestamp_pb2.Timestamp
    return getattr(jpb, full_name.split(".")[-1])


_RANGES = {"int32": (-(2**31), 2**31 - 1), "int64": (-(2**63), 2**63 - 1),
           "uint64": (0, 2**64 - 1)}


def _scalar(kind: str):
    if kind == "string":
        return st.text(max_size=12)
    if kind == "bytes":
        return st.binary(max_size=12)
    if kind == "bool":
        return st.booleans()
    if kind == "float":
        return st.floats(width=32, allow_nan=False)
    lo, hi = _RANGES[kind]
    return st.one_of(st.integers(lo, hi), st.sampled_from([lo, hi, 0, 1, -1]
                                                          if lo else
                                                          [0, 1, hi]))


def _tree(cls) -> st.SearchStrategy:
    """A random instance of ``cls`` as (class, {field: value or subtree}),
    at most one arm of each oneof set."""
    plain, arms = {}, {}
    for f in cls.FIELDS:
        if f.kind == "message":
            sub = _tree(f.message)
            s = st.lists(sub, max_size=3) if f.repeated else sub
        else:
            s = _scalar(f.kind)
            s = st.lists(s, max_size=4) if f.repeated else s
        (arms.setdefault(f.oneof, {}) if f.oneof else plain)[f.name] = s

    @st.composite
    def build(draw):
        vals = {k: v for k, v in draw(st.fixed_dictionaries(
            {}, optional=plain)).items()}
        for group in arms.values():
            arm = draw(st.sampled_from([None, *group]))
            if arm is not None:
                vals[arm] = draw(group[arm])
        return cls, vals

    return build()


def _make(tree, port: bool):
    """The tree as a port message (``port``) or a protobuf one."""
    cls, vals = tree
    out = {}
    for name, v in vals.items():
        if isinstance(v, tuple):
            v = _make(v, port)
        elif isinstance(v, list) and v and isinstance(v[0], tuple):
            v = [_make(x, port) for x in v]
        out[name] = v
    if port:
        return cls(**out)
    return _pb_class(_full_name(cls))(**out)


def _full_name(cls) -> str:
    return next(k for k, v in tpb.MESSAGES.items() if v is cls)


def _f32(v: float) -> bytes:
    """A float field's value as its float32 bit pattern: NaN compares
    equal to the same NaN (``==`` on floats never holds for NaN)."""
    return struct.pack("<f", v)


def _port_fields(m) -> dict:
    out = {}
    for f in m.FIELDS:
        v = m._v[f.name]
        if f.kind == "message":
            v = ([_port_fields(x) for x in v] if f.repeated
                 else None if v is None else _port_fields(v))
        elif f.kind == "float":
            v = [_f32(x) for x in v] if f.repeated else _f32(v)
        elif f.repeated:
            v = list(v)
        out[f.name] = v
    return out


def _pb_fields(m) -> dict:
    out = {}
    for fd in m.DESCRIPTOR.fields:
        v = getattr(m, fd.name)
        repeated = fd.is_repeated
        if fd.message_type is not None:
            v = ([_pb_fields(x) for x in v] if repeated
                 else _pb_fields(v) if m.HasField(fd.name) else None)
        elif fd.type == fd.TYPE_FLOAT:
            v = [_f32(x) for x in v] if repeated else _f32(v)
        elif repeated:
            v = list(v)
        out[fd.name] = v
    return out


_SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                     suppress_health_check=list(HealthCheck))


def test_schema_covers_every_protobuf_message():
    """Every message protobuf's descriptor declares has a port table with
    the same fields, numbers, kinds and oneof arms."""
    names = set(jpb.DESCRIPTOR.message_types_by_name)
    assert {f"llama.v1.{n}" for n in names} | {
        "google.protobuf.Timestamp"} == set(tpb.MESSAGES)
    kinds = {9: "string", 12: "bytes", 8: "bool", 5: "int32", 3: "int64",
             4: "uint64", 2: "float", 11: "message"}
    for name in NAMES:
        desc = _pb_class(name).DESCRIPTOR
        want = {(fd.number, fd.name, kinds[fd.type],
                 fd.is_repeated,
                 fd.containing_oneof.name if fd.containing_oneof else "")
                for fd in desc.fields}
        got = {(f.number, f.name, f.kind, f.repeated, f.oneof)
               for f in tpb.MESSAGES[name].FIELDS}
        assert got == want, name


@pytest.mark.parametrize("name", NAMES)
def test_random_messages_match_protobuf(name):
    cls = tpb.MESSAGES[name]

    @_SETTINGS
    @given(_tree(cls))
    def check(tree):
        port, ref = _make(tree, True), _make(tree, False)
        data = port.SerializeToString()
        assert data == ref.SerializeToString()
        back = type(ref)()
        back.ParseFromString(data)
        assert back == ref
        decoded = cls.FromString(ref.SerializeToString())
        assert decoded == port
        assert _port_fields(decoded) == _pb_fields(ref)

    check()


@pytest.mark.parametrize("name", ["llama.v1.BaseMessage",
                                  "llama.v1.GenerateRequest",
                                  "llama.v1.EmbedResponse",
                                  "llama.v1.VerifyResult",
                                  "llama.v1.GossipFrame"])
def test_random_bytes_decode_like_protobuf(name):
    """Arbitrary bytes, and truncations and one-byte corruptions of valid
    encodings: the port raises DecodeError exactly where protobuf raises,
    and otherwise reads the same fields."""
    cls, pbcls = tpb.MESSAGES[name], _pb_class(name)

    def same(data: bytes) -> None:
        ref = pbcls()
        try:
            ref.ParseFromString(data)
        except PbDecodeError:
            with pytest.raises(tpb.DecodeError):
                cls.FromString(data)
            return
        assert _port_fields(cls.FromString(data)) == _pb_fields(ref), data

    @_SETTINGS
    @given(st.binary(max_size=40), _tree(cls), st.integers(0, 10**6),
           st.integers(0, 255))
    def check(noise, tree, at, byte):
        same(noise)
        data = _make(tree, False).SerializeToString()
        for n in range(len(data)):
            same(data[:n])
        if data:
            i = at % len(data)
            same(data[:i] + bytes([byte]) + data[i + 1:])

    check()


# ------------------------------------------------------------ wire facts

@pytest.mark.parametrize("case,want", [
    ("order", "2a0174320170" "4a030a0174"),
    ("empty_arm", "0a00"),
    ("empty_timestamp", "1200"),
    ("neg_zero", "3500000080"),
    ("neg_int32", "28ffffffffffffffffff01"),
    ("uint64_max", "40ffffffffffffffffff01"),
    ("non_ascii", "1209c3a9e29883f09f8e89"),
    ("packed", "0a0c0000803f00000080000040c0"),
    ("packed_ints", "220d01ffffffffffffffffff01ac02"),
])
def test_wire_facts(case, want):
    build = {
        "order": lambda m: m.BaseMessage(
            migrate_frame=m.MigrateFrame(model="t"), trace_id="t",
            parent_span="p"),
        "empty_arm": lambda m: m.BaseMessage(
            generate_request=m.GenerateRequest()),
        "empty_timestamp": lambda m: m.GenerateResponse(
            created_at=(m.Timestamp() if m is tpb
                        else timestamp_pb2.Timestamp())),
        "neg_zero": lambda m: m.GenerateRequest(temperature=-0.0),
        "neg_int32": lambda m: m.GenerateRequest(max_tokens=-1),
        "uint64_max": lambda m: m.GenerateRequest(seed=2**64 - 1),
        "non_ascii": lambda m: m.GenerateRequest(prompt="é☃🎉"),
        "packed": lambda m: m.Embedding(values=[1.0, -0.0, -3.0]),
        "packed_ints": lambda m: m.VerifyResult(tokens=[1, -1, 300]),
    }[case]
    assert build(jpb).SerializeToString().hex() == want
    assert build(tpb).SerializeToString().hex() == want
    assert tpb.MESSAGES[_full_name(type(build(tpb)))].FromString(
        bytes.fromhex(want)) == build(tpb)


def test_floats_hold_float32_values():
    """0.8 reads back as its float32 value on both packages, through the
    setter and through the wire."""
    j = jpb.GenerateRequest(temperature=0.8, top_p=0.9, repeat_penalty=1.1)
    t = tpb.GenerateRequest(temperature=0.8, top_p=0.9, repeat_penalty=1.1)
    for name in ("temperature", "top_p", "repeat_penalty"):
        assert getattr(t, name) == getattr(j, name) != round(
            getattr(j, name), 6)
    back = tpb.GenerateRequest.FromString(j.SerializeToString())
    assert back.temperature == j.temperature
    assert tpb.Embedding(values=[1e39]).values == [float("inf")]
    assert list(jpb.Embedding(values=[1e39]).values) == [float("inf")]


def _key(num: int, wt: int) -> bytes:
    return tpb._varint((num << 3) | wt)


def test_unpacked_repeated_scalars_decode_like_packed():
    unpacked = b"".join(_key(1, 5) + struct.pack("<f", x)
                        for x in (1.0, 2.5))
    ints = b"".join(_key(4, 0) + tpb._varint(x) for x in (3, 2**64 - 5))
    for name, data in (("llama.v1.Embedding", unpacked),
                       ("llama.v1.VerifyResult", ints)):
        ref = _pb_class(name).FromString(data)
        got = tpb.MESSAGES[name].FromString(data)
        assert _port_fields(got) == _pb_fields(ref)
    assert tpb.Embedding.FromString(unpacked).values == [1.0, 2.5]
    assert tpb.VerifyResult.FromString(ints).tokens == [3, -5]


def test_unknown_fields_are_skipped():
    body = tpb.GenerateRequest(prompt="hi", max_tokens=3).SerializeToString()
    extra = (_key(99, 0) + tpb._varint(7) + _key(98, 2) + b"\x02ab"
             + _key(97, 5) + b"\0\0\0\0" + _key(96, 1) + b"\0" * 8
             + _key(95, 3) + _key(1, 0) + b"\x01" + _key(95, 4)
             # A known number sent with another wire type is unknown too.
             + _key(2, 0) + b"\x05")
    data = extra[:3] + body + extra[3:]
    ref = jpb.GenerateRequest.FromString(data)
    got = tpb.GenerateRequest.FromString(data)
    assert _port_fields(got) == _pb_fields(ref)
    assert (got.prompt, got.max_tokens) == ("hi", 3)


def test_last_scalar_wins_and_submessages_merge():
    data = (tpb.GenerateResponse(model="a", created_at=tpb.Timestamp(
        seconds=5)).SerializeToString()
            + tpb.GenerateResponse(model="b", created_at=tpb.Timestamp(
                nanos=7)).SerializeToString())
    ref = jpb.GenerateResponse.FromString(data)
    got = tpb.GenerateResponse.FromString(data)
    assert _port_fields(got) == _pb_fields(ref)
    assert (got.model, got.created_at.seconds, got.created_at.nanos) == (
        "b", 5, 7)
    # Two arms of the oneof on the wire: the last one stands.
    two = (tpb.BaseMessage(generate_request=tpb.GenerateRequest(prompt="x"))
           .SerializeToString()
           + tpb.BaseMessage(embed_request=tpb.EmbedRequest(model="m"))
           .SerializeToString())
    got = tpb.BaseMessage.FromString(two)
    assert got.WhichOneof("message") == "embed_request"
    assert (jpb.BaseMessage.FromString(two).WhichOneof("message")
            == "embed_request")


@pytest.mark.parametrize("data", [
    "0a05616263",            # length past the end
    "28ff",                  # truncated varint
    "28" + "ff" * 10 + "01",  # varint of 11 bytes
    "1202c328",              # invalid UTF-8 in a string field
    "0a",                    # key without a value
    "3500",                  # truncated fixed32
    "808080801000",          # tag of 2**32: past 32 bits
    "0d0000000080808080" "1000",  # the same after a known field
    "888080808000" "00",     # tag of 6 bytes (value 8)
    "ffffffff0f",            # tag 0xffffffff: wire type 7
    "0b00000c",              # field number 0 inside a group
    "0b888080801000" "0c",   # a 33-bit tag inside a group
])
def test_invalid_input_raises_decode_error(data):
    raw = bytes.fromhex(data)
    with pytest.raises(PbDecodeError):
        jpb.GenerateRequest.FromString(raw)
    with pytest.raises(tpb.DecodeError):
        tpb.GenerateRequest.FromString(raw)


@pytest.mark.parametrize("data", [
    "8880808000" "00",       # tag of 5 bytes (value 8): field 1
    "f8ffffff0f" "00",       # field 2**29 - 1, the largest
    "0bf8ffffff0f000c",      # the same inside a group
])
def test_widest_tags_decode_like_protobuf(data):
    raw = bytes.fromhex(data)
    assert _port_fields(tpb.GenerateRequest.FromString(raw)) == _pb_fields(
        jpb.GenerateRequest.FromString(raw))


def test_bytes_fields_take_any_bytes_and_setters_check_types():
    m = tpb.TraceSpans(payload=b"\xff\xfe")
    assert tpb.TraceSpans.FromString(m.SerializeToString()).payload == (
        b"\xff\xfe")
    with pytest.raises(TypeError):
        tpb.GenerateRequest(prompt=b"x")
    with pytest.raises(ValueError):
        tpb.GenerateRequest(max_tokens=2**31)
    with pytest.raises(ValueError):
        tpb.GenerateRequest(seed=-1)
    with pytest.raises(AttributeError):
        tpb.GenerateRequest(nope=1)
    with pytest.raises(TypeError):
        tpb.BaseMessage(generate_request=tpb.EmbedRequest())


def test_oneof_and_presence():
    m = tpb.BaseMessage()
    assert m.WhichOneof("message") is None
    assert m.generate_request == tpb.GenerateRequest()  # read, not set
    assert not m.HasField("generate_request")
    m.generate_request = tpb.GenerateRequest(prompt="p")
    m.embed_request = tpb.EmbedRequest()
    assert m.WhichOneof("message") == "embed_request"
    assert not m.HasField("generate_request")
    assert m.SerializeToString() == jpb.BaseMessage(
        embed_request=jpb.EmbedRequest()).SerializeToString()
    fr = tpb.GossipFrame()
    fr.entries.add(key="k", version=3)
    fr.usage.append(tpb.TenantUsage(tenant="t"))
    with pytest.raises(TypeError):
        fr.entries.append(tpb.TenantUsage())
    ts = tpb.Timestamp()
    ts.FromNanoseconds(-1)
    assert (ts.seconds, ts.nanos, ts.ToNanoseconds()) == (-1, 999999999, -1)


# --------------------------------------------------- goldens and framing

@pytest.mark.parametrize("case", sorted(wire_golden.FRAMES))
def test_wire_golden_is_protobufs_and_the_ports(case):
    want = wire_golden.FRAMES[case]
    assert wire_golden.frames(jmessages)[case].hex() == want
    assert wire_golden.frames(tmessages)[case].hex() == want
    payload = bytes.fromhex(want)[4:]
    assert _port_fields(twire.decode_payload(payload)) == _pb_fields(
        jwire.decode_payload(payload))


def test_wire_golden_check():
    assert wire_golden.check() == {"frames": len(wire_golden.FRAMES),
                                   "bytes": sum(len(h) // 2 for h in
                                                wire_golden.FRAMES.values())}


def test_message_helpers_match_the_jax_package():
    """Extractors, and genresp_frame_bytes on every argument, give the JAX
    package's results."""
    kw = dict(worker_id="w", done=True, done_reason="stop",
              total_duration_ns=5, prompt_tokens=3, completion_tokens=2,
              trace_id="t", parent_span="p", created_ns=123)
    for done in (True, False):
        kw["done"] = done
        assert (tmessages.genresp_frame_bytes("m", "txt ☃", **kw)
                == jmessages.genresp_frame_bytes("m", "txt ☃", **kw))
    msg = tmessages.create_generate_request("m", "p")
    assert tmessages.extract_generate_request(msg).prompt == "p"
    with pytest.raises(ValueError, match="EmbedRequest"):
        tmessages.extract_embed_request(msg)
    chat = [{"role": "system", "content": "s"}, {"content": "u"}]
    assert tmessages.flatten_chat(chat) == jmessages.flatten_chat(chat)


def test_frame_scanning_and_oversized_headers():
    frames = [tmessages.genresp_frame_bytes("m", str(i), created_ns=i)
              for i in range(3)]
    buf = b"".join(frames) + frames[0][:5]
    assert twire.scan_frames(buf) == jwire.scan_frames(buf)
    payloads, used = twire.scan_frames(buf)
    assert used == len(buf) - 5 and payloads[1] == frames[1][4:]
    big = struct.pack(">I", twire.MAX_MESSAGE_SIZE + 1)
    with pytest.raises(twire.WireError):
        twire.scan_frames(big + b"\0" * 8)
    with pytest.raises(twire.WireError):
        twire.encode_frame(tpb.BaseMessage(trace_spans=tpb.TraceSpans(
            payload=b"\0" * twire.MAX_MESSAGE_SIZE)))
    a, b = socket.socketpair()
    with a, b:
        a.sendall(b"".join(frames))
        reader = twire.SyncFrameReader(b, recv_size=7)
        got = [reader.read_message() for _ in frames]
        assert [m.generate_response.response for m in got] == ["0", "1", "2"]
        twire.write_length_prefixed_pb_sync(a, twire.decode_payload(
            frames[2][4:]))
        assert twire.read_length_prefixed_pb_sync(b) == got[2]
        a.sendall(big)
        with pytest.raises(twire.WireError):
            twire.read_length_prefixed_pb_sync(b)
        a.sendall(frames[0][:6])
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(twire.WireError):
            twire.SyncFrameReader(b).read_message()


async def test_async_framing_over_a_socket():
    async def serve(reader, writer):
        msg = await twire.read_length_prefixed_pb(reader, timeout=5)
        await twire.write_length_prefixed_pb(writer, msg)
        await twire.write_frame_bytes(writer, struct.pack(
            ">I", twire.MAX_MESSAGE_SIZE + 1))
        writer.close()

    srv = await asyncio.start_server(serve, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        sent = tmessages.create_generate_request("m", "é", temperature=0.8,
                                                 seed=7)
        writer.write(jwire.encode_frame(jwire.decode_payload(
            twire.encode_frame(sent)[4:])))
        await writer.drain()
        assert await twire.read_length_prefixed_pb(reader, timeout=5) == sent
        with pytest.raises(twire.WireError, match="exceeds"):
            await twire.read_frame_payload(reader, timeout=5)
        writer.close()
    finally:
        srv.close()
        await srv.wait_closed()
