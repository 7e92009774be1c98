"""The llama.v1 wire schema (``proto/llama_v1.proto``), encoded without
protobuf.

Counterpart of ``crowdllama_tpu/core/llama_v1_pb2.py``: every message of
the schema plus ``google.protobuf.Timestamp``, declared as one field table
per message (number, name, kind, repeated, submessage, oneof group) and
encoded and decoded by one table-driven proto3 codec.  The machine that
serves the port has no ``protobuf`` package, and a torch worker must speak
the same bytes as a JAX worker, so the encoder reproduces
``SerializeToString`` of protobuf's Python runtime byte for byte:

- fields go out in field-number order, oneof arms included (so
  ``BaseMessage.trace_id`` = 5 precedes the arms 7-16);
- a set submessage is emitted even when empty (``GenerateRequest()`` in
  ``BaseMessage`` is ``0a00``); unset ones are not;
- a scalar is emitted when it differs from its default; a float when its
  float32 bit pattern is non-zero (``-0.0`` is sent), as fixed32;
- negative int32/int64 are 10-byte varints;
- repeated numeric scalars are packed; repeated strings, bytes and
  messages go one record each.

The decoder takes packed and unpacked repeated scalars alike, skips
unknown fields (and known numbers sent with another wire type, as
protobuf does), keeps the last value of a singular scalar, merges a
singular submessage sent twice, and raises ``DecodeError`` on truncated
varints or lengths, invalid UTF-8 in a ``string`` field and nesting past
100 levels.

Message objects keep the surface the handlers use: attribute access
(an unset submessage reads as an empty instance, which is not stored:
assign a submessage to set it), ``WhichOneof``, ``HasField``, repeated
fields as lists (``append``/``extend``, ``add(**fields)`` for messages),
``SerializeToString``/``ParseFromString``/``FromString``.  Float fields
hold float32 values, as protobuf's do, so a ``temperature`` of 0.8 reads
back as 0.800000011920929 on either package.
"""

from __future__ import annotations

import math
import operator
import struct

__all__ = [
    "DecodeError", "Field", "Message", "Repeated", "Timestamp",
    "ChatMessage", "GenerateRequest", "GenerateResponse", "EmbedRequest",
    "Embedding", "EmbedResponse", "KvFetchRequest", "KvPages",
    "MigrateFrame", "GossipEntry", "TenantUsage", "GossipFrame",
    "TraceFetch", "TraceSpans", "MetricsFetch", "MetricsSnapshot",
    "DraftChunk", "VerifyResult", "BaseMessage", "MESSAGES",
]

_F32 = struct.Struct("<f")
_MASK64 = (1 << 64) - 1
_MAX_DEPTH = 100

# Wire types.
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5

_KIND_WIRE = {"string": _LEN, "bytes": _LEN, "message": _LEN,
              "bool": _VARINT, "int32": _VARINT, "int64": _VARINT,
              "uint64": _VARINT, "float": _I32}
_DEFAULTS = {"string": "", "bytes": b"", "bool": False, "int32": 0,
             "int64": 0, "uint64": 0, "float": 0.0}
_PACKED = frozenset({"bool", "int32", "int64", "uint64", "float"})
_RANGES = {"int32": (-(1 << 31), (1 << 31) - 1),
           "int64": (-(1 << 63), (1 << 63) - 1),
           "uint64": (0, _MASK64)}


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message (protobuf's
    ``DecodeError``)."""


# ------------------------------------------------------------------ fields

class Field:
    """One row of a message's field table."""

    __slots__ = ("number", "name", "kind", "repeated", "message", "oneof",
                 "key", "packed")

    def __init__(self, number: int, name: str, kind: str,
                 repeated: bool = False, message: type | None = None,
                 oneof: str = ""):
        if kind not in _KIND_WIRE:
            raise ValueError(f"unknown field kind {kind!r}")
        if (kind == "message") != (message is not None):
            raise ValueError(f"field {name}: a message kind names its class")
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.message, self.oneof = repeated, message, oneof
        self.packed = repeated and kind in _PACKED
        self.key = _varint((number << 3)
                           | (_LEN if self.packed else _KIND_WIRE[kind]))

    def __repr__(self) -> str:
        rep = "repeated " if self.repeated else ""
        kind = self.message.__name__ if self.message else self.kind
        return f"Field({rep}{kind} {self.name} = {self.number})"


def _coerce(kind: str, value):
    """A Python value checked and converted as protobuf's setters do:
    TypeError for a wrong type, ValueError out of range; floats rounded
    to float32."""
    if kind == "string":
        if not isinstance(value, str):
            raise TypeError(f"expected str, got {type(value).__name__}")
        return value
    if kind == "bytes":
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"expected bytes, got {type(value).__name__}")
        return bytes(value)
    if kind == "float":
        if isinstance(value, (str, bytes)):
            raise TypeError(f"expected float, got {type(value).__name__}")
        return _to_f32(float(value))
    i = operator.index(value)
    if kind == "bool":
        return bool(i)
    lo, hi = _RANGES[kind]
    if not lo <= i <= hi:
        raise ValueError(f"value {i} out of range for {kind}")
    return i


def _to_f32(x: float) -> float:
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except OverflowError:  # beyond float32: protobuf stores +-inf
        return math.copysign(math.inf, x)


class Repeated(list):
    """A repeated field: a list whose elements are checked (and floats
    rounded) as they are added."""

    __slots__ = ("_field",)

    def __init__(self, field: Field, items=()):
        super().__init__()
        self._field = field
        self.extend(items)

    def _check(self, value):
        f = self._field
        if f.kind == "message":
            if not isinstance(value, f.message):
                raise TypeError(f"{f.name}: expected {f.message.__name__}, "
                                f"got {type(value).__name__}")
            return value
        return _coerce(f.kind, value)

    def append(self, value) -> None:
        super().append(self._check(value))

    def extend(self, values) -> None:
        super().extend(self._check(v) for v in values)

    def insert(self, index, value) -> None:
        super().insert(index, self._check(value))

    def __setitem__(self, index, value) -> None:
        if isinstance(index, slice):
            super().__setitem__(index, [self._check(v) for v in value])
        else:
            super().__setitem__(index, self._check(value))

    def add(self, **fields):
        """Append a new submessage built from ``fields`` and return it."""
        if self._field.kind != "message":
            raise TypeError(f"{self._field.name} is not a message field")
        msg = self._field.message(**fields)
        super().append(msg)
        return msg


# ---------------------------------------------------------------- messages

class Message:
    """Base of every message; a subclass declares ``FIELDS``."""

    FIELDS: tuple[Field, ...] = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.FIELDS = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._BY_NAME = {f.name: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        cls._ONEOFS = {}
        for f in cls.FIELDS:
            if f.oneof:
                cls._ONEOFS.setdefault(f.oneof, []).append(f.name)
        cls._INIT = {f.name: None if f.kind == "message" else
                     _DEFAULTS[f.kind] for f in cls.FIELDS if not f.repeated}
        cls._REPEATED = tuple(f for f in cls.FIELDS if f.repeated)

    def __init__(self, **fields):
        v = dict(self._INIT)
        for f in self._REPEATED:
            v[f.name] = Repeated(f)
        object.__setattr__(self, "_v", v)
        for name, value in fields.items():
            setattr(self, name, value)

    def __getattr__(self, name: str):
        try:
            f = type(self)._BY_NAME[name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}") from None
        value = self._v[name]
        return f.message() if value is None else value

    def __setattr__(self, name: str, value) -> None:
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        if f.repeated:
            value = Repeated(f, value)
        elif f.kind == "message":
            if value is not None and not isinstance(value, f.message):
                raise TypeError(f"{name}: expected {f.message.__name__}, "
                                f"got {type(value).__name__}")
        else:
            value = _coerce(f.kind, value)
        if f.oneof and value is not None:
            for other in self._ONEOFS[f.oneof]:
                self._v[other] = None
        self._v[name] = value

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._v == other._v

    __hash__ = None  # mutable

    def __repr__(self) -> str:
        parts = [f"{f.name}={self._v[f.name]!r}" for f in self.FIELDS
                 if self._is_set(f)]
        return f"{type(self).__name__}({', '.join(parts)})"

    def _is_set(self, f: Field) -> bool:
        value = self._v[f.name]
        if f.repeated:
            return bool(value)
        if f.kind == "message":
            return value is not None
        if f.kind == "float":
            return _F32.pack(value) != b"\0\0\0\0"
        return bool(value)

    def WhichOneof(self, group: str) -> str | None:  # noqa: N802
        try:
            arms = self._ONEOFS[group]
        except KeyError:
            raise ValueError(f"{type(self).__name__} has no oneof "
                             f"{group!r}") from None
        for name in arms:
            if self._v[name] is not None:
                return name
        return None

    def HasField(self, name: str) -> bool:  # noqa: N802
        if name in self._ONEOFS:
            return self.WhichOneof(name) is not None
        f = self._BY_NAME.get(name)
        if f is None or f.repeated or f.kind != "message":
            raise ValueError(f"{type(self).__name__}.{name} has no presence")
        return self._v[name] is not None

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        _encode(self, out)
        return bytes(out)

    def ParseFromString(self, data) -> int:  # noqa: N802
        """Replace this message's fields with those decoded from
        ``data``; returns the number of bytes read."""
        self.__init__()
        return self.MergeFromString(data)

    def MergeFromString(self, data) -> int:  # noqa: N802
        buf = bytes(data)
        _decode_into(self, buf, 0, len(buf), 0)
        return len(buf)

    @classmethod
    def FromString(cls, data):  # noqa: N802
        msg = cls()
        msg.MergeFromString(data)
        return msg


# ------------------------------------------------------------------ encode

_SMALL = [bytes((i,)) for i in range(128)]


def _varint(v: int) -> bytes:
    if 0 <= v < 128:
        return _SMALL[v]
    v &= _MASK64  # negative ints: 64-bit two's complement, 10 bytes
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _scalar_bytes(kind: str, value) -> bytes:
    """The encoded value of one scalar, without its key."""
    if kind == "float":
        return _F32.pack(value)
    if kind == "string":
        data = value.encode("utf-8")
        return _varint(len(data)) + data
    if kind == "bytes":
        return _varint(len(value)) + value
    return _varint(int(value))  # bool, int32, int64, uint64


def _encode(msg: Message, out: bytearray) -> None:
    v = msg._v
    for f in msg.FIELDS:
        value = v[f.name]
        if f.repeated:
            if not value:
                continue
            if f.packed:
                body = b"".join(_scalar_bytes(f.kind, x) for x in value)
                out += f.key
                out += _varint(len(body))
                out += body
            elif f.kind == "message":
                for m in value:
                    sub = m.SerializeToString()
                    out += f.key
                    out += _varint(len(sub))
                    out += sub
            else:
                for x in value:
                    out += f.key
                    out += _scalar_bytes(f.kind, x)
        elif f.kind == "message":
            if value is not None:
                sub = value.SerializeToString()
                out += f.key
                out += _varint(len(sub))
                out += sub
        elif f.kind == "float":
            data = _F32.pack(value)
            if data != b"\0\0\0\0":
                out += f.key
                out += data
        elif value:
            out += f.key
            out += _scalar_bytes(f.kind, value)


# ------------------------------------------------------------------ decode

def _read_varint(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _read_len(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    n, pos = _read_varint(buf, pos, end)
    if n > end - pos:
        raise DecodeError("truncated length-delimited field")
    return pos + n, pos


def _skip(buf: bytes, pos: int, end: int, wt: int, num: int,
          depth: int) -> int:
    if wt == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wt == _I64 or wt == _I32:
        pos += 8 if wt == _I64 else 4
        if pos > end:
            raise DecodeError("truncated fixed-width field")
        return pos
    if wt == _LEN:
        return _read_len(buf, pos, end)[0]
    if wt == _SGROUP:
        if depth >= _MAX_DEPTH:
            raise DecodeError("nesting too deep")
        while True:
            key, pos = _read_varint(buf, pos, end)
            if key & 7 == _EGROUP:
                if key >> 3 != num:
                    raise DecodeError("mismatched end group")
                return pos
            pos = _skip(buf, pos, end, key & 7, key >> 3, depth + 1)
    raise DecodeError(f"invalid wire type {wt}")


def _varint_value(kind: str, raw: int):
    if kind == "bool":
        return raw != 0
    if kind == "int32":
        raw &= 0xFFFFFFFF
        return raw - (1 << 32) if raw >> 31 else raw
    if kind == "int64":
        return raw - (1 << 64) if raw >> 63 else raw
    return raw  # uint64


def _read_scalar(kind: str, buf: bytes, pos: int, end: int):
    """One scalar value of ``kind`` at ``pos`` -> (value, new pos)."""
    if kind == "float":
        if pos + 4 > end:
            raise DecodeError("truncated float")
        return _F32.unpack_from(buf, pos)[0], pos + 4
    if kind in ("string", "bytes"):
        stop, pos = _read_len(buf, pos, end)
        data = buf[pos:stop]
        if kind == "string":
            try:
                return data.decode("utf-8"), stop
            except UnicodeDecodeError:
                raise DecodeError("string field is not valid UTF-8") from None
        return data, stop
    raw, pos = _read_varint(buf, pos, end)
    return _varint_value(kind, raw), pos


def _decode_into(msg: Message, buf: bytes, pos: int, end: int,
                 depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise DecodeError("nesting too deep")
    by_number, v = msg._BY_NUMBER, msg._v
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        num, wt = key >> 3, key & 7
        if num == 0:
            raise DecodeError("field number 0")
        f = by_number.get(num)
        if f is None or (wt != _KIND_WIRE[f.kind]
                         and not (f.packed and wt == _LEN)):
            pos = _skip(buf, pos, end, wt, num, depth)
            continue
        if f.kind == "message":
            stop, pos = _read_len(buf, pos, end)
            if f.repeated:
                sub = f.message()
                _decode_into(sub, buf, pos, stop, depth + 1)
                list.append(v[f.name], sub)
            else:
                sub = v[f.name]
                if sub is None:
                    sub = f.message()
                    setattr(msg, f.name, sub)
                _decode_into(sub, buf, pos, stop, depth + 1)
            pos = stop
        elif f.packed and wt == _LEN:
            stop, pos = _read_len(buf, pos, end)
            items = v[f.name]
            while pos < stop:
                x, pos = _read_scalar(f.kind, buf, pos, stop)
                list.append(items, x)
        else:
            x, pos = _read_scalar(f.kind, buf, pos, end)
            if f.repeated:
                list.append(v[f.name], x)
            else:
                v[f.name] = x


# ------------------------------------------------------------ the schema

def _f(number, name, kind, repeated=False, message=None, oneof=""):
    return Field(number, name, kind, repeated, message, oneof)


class Timestamp(Message):
    """``google.protobuf.Timestamp``."""

    FIELDS = (_f(1, "seconds", "int64"), _f(2, "nanos", "int32"))

    def FromNanoseconds(self, nanos: int) -> None:  # noqa: N802
        self.seconds, self.nanos = divmod(int(nanos), 1_000_000_000)

    def ToNanoseconds(self) -> int:  # noqa: N802
        return self.seconds * 1_000_000_000 + self.nanos


class ChatMessage(Message):
    FIELDS = (_f(1, "role", "string"), _f(2, "content", "string"))


class GenerateRequest(Message):
    FIELDS = (
        _f(1, "model", "string"), _f(2, "prompt", "string"),
        _f(3, "stream", "bool"),
        _f(4, "messages", "message", True, ChatMessage),
        _f(5, "max_tokens", "int32"), _f(6, "temperature", "float"),
        _f(7, "top_p", "float"), _f(8, "seed", "uint64"),
        _f(9, "stop", "string", True), _f(10, "top_k", "int32"),
        _f(11, "repeat_penalty", "float"), _f(12, "kv_donor", "string"),
        _f(13, "migrate", "bool"), _f(14, "remote_draft", "bool"))


class GenerateResponse(Message):
    FIELDS = (
        _f(1, "model", "string"),
        _f(2, "created_at", "message", message=Timestamp),
        _f(3, "response", "string"), _f(4, "done", "bool"),
        _f(5, "done_reason", "string"), _f(6, "worker_id", "string"),
        _f(7, "total_duration", "int64"), _f(8, "prompt_tokens", "int32"),
        _f(9, "completion_tokens", "int32"))


class EmbedRequest(Message):
    FIELDS = (_f(1, "model", "string"), _f(2, "input", "string", True),
              _f(3, "truncate", "bool"))


class Embedding(Message):
    FIELDS = (_f(1, "values", "float", True),)


class EmbedResponse(Message):
    FIELDS = (
        _f(1, "model", "string"),
        _f(2, "embeddings", "message", True, Embedding),
        _f(3, "worker_id", "string"), _f(4, "total_duration", "int64"),
        _f(5, "prompt_tokens", "int32"), _f(6, "error", "string"))


class KvFetchRequest(Message):
    FIELDS = (_f(1, "model", "string"),
              _f(2, "chain_hashes", "bytes", True),
              _f(3, "page_size", "int32"))


class KvPages(Message):
    FIELDS = (
        _f(1, "model", "string"), _f(2, "matched", "int32"),
        _f(3, "start", "int32"), _f(4, "k_pages", "bytes", True),
        _f(5, "v_pages", "bytes", True), _f(6, "k_scales", "bytes", True),
        _f(7, "v_scales", "bytes", True), _f(8, "kv_dtype", "string"),
        _f(9, "done", "bool"), _f(10, "error", "string"))


class MigrateFrame(Message):
    FIELDS = (
        _f(1, "model", "string"), _f(2, "worker_id", "string"),
        _f(3, "delivered_tokens", "int32"), _f(4, "prompt_tokens", "int32"),
        _f(5, "chain_hashes", "bytes", True), _f(6, "page_size", "int32"),
        _f(7, "reason", "string"))


class GossipEntry(Message):
    FIELDS = (_f(1, "key", "string"), _f(2, "value", "string"),
              _f(3, "version", "uint64"), _f(4, "tombstone", "bool"),
              _f(5, "origin", "string"))


class TenantUsage(Message):
    FIELDS = (_f(1, "origin", "string"), _f(2, "tenant", "string"),
              _f(3, "admitted", "uint64"), _f(4, "version", "uint64"))


class GossipFrame(Message):
    FIELDS = (
        _f(1, "origin", "string"),
        _f(2, "entries", "message", True, GossipEntry),
        _f(3, "usage", "message", True, TenantUsage),
        _f(4, "sync", "bool"), _f(5, "clock", "uint64"))


class TraceFetch(Message):
    FIELDS = (_f(1, "trace_id", "string"),)


class TraceSpans(Message):
    FIELDS = (_f(1, "trace_id", "string"), _f(2, "node", "string"),
              _f(3, "payload", "bytes"), _f(4, "found", "bool"),
              _f(5, "error", "string"))


class MetricsFetch(Message):
    FIELDS = (_f(1, "families", "string", True),)


class MetricsSnapshot(Message):
    FIELDS = (_f(1, "node", "string"), _f(2, "payload", "bytes"),
              _f(3, "found", "bool"), _f(4, "error", "string"))


class DraftChunk(Message):
    FIELDS = (_f(1, "model", "string"), _f(2, "chunk_id", "uint64"),
              _f(3, "position", "int32"), _f(4, "tokens", "int32", True))


class VerifyResult(Message):
    FIELDS = (
        _f(1, "chunk_id", "uint64"), _f(2, "position", "int32"),
        _f(3, "accepted", "int32"), _f(4, "tokens", "int32", True),
        _f(5, "done", "bool"), _f(6, "draft_k", "int32"),
        _f(7, "depth_hint", "int32"), _f(8, "prompt_ids", "int32", True))


def _arm(number, name, message):
    return _f(number, name, "message", message=message, oneof="message")


class BaseMessage(Message):
    """The envelope every frame carries: one arm of the ``message`` oneof
    plus the tracing ids."""

    FIELDS = (
        _arm(1, "generate_request", GenerateRequest),
        _arm(2, "generate_response", GenerateResponse),
        _arm(3, "embed_request", EmbedRequest),
        _arm(4, "embed_response", EmbedResponse),
        _f(5, "trace_id", "string"), _f(6, "parent_span", "string"),
        _arm(7, "kv_fetch_request", KvFetchRequest),
        _arm(8, "kv_pages", KvPages),
        _arm(9, "migrate_frame", MigrateFrame),
        _arm(10, "gossip_frame", GossipFrame),
        _arm(11, "trace_fetch", TraceFetch),
        _arm(12, "trace_spans", TraceSpans),
        _arm(13, "metrics_fetch", MetricsFetch),
        _arm(14, "metrics_snapshot", MetricsSnapshot),
        _arm(15, "draft_chunk", DraftChunk),
        _arm(16, "verify_result", VerifyResult))


# Every message of the schema by its protobuf name (Timestamp under its
# package's).
MESSAGES: dict[str, type[Message]] = {
    "google.protobuf.Timestamp": Timestamp,
    **{f"llama.v1.{cls.__name__}": cls for cls in (
        ChatMessage, GenerateRequest, GenerateResponse, EmbedRequest,
        Embedding, EmbedResponse, KvFetchRequest, KvPages, MigrateFrame,
        GossipEntry, TenantUsage, GossipFrame, TraceFetch, TraceSpans,
        MetricsFetch, MetricsSnapshot, DraftChunk, VerifyResult,
        BaseMessage)},
}
