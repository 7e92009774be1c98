"""Length-prefixed llama.v1 framing over byte streams.

Counterpart of ``crowdllama_tpu/core/wire.py``: a frame is a 4-byte
big-endian length followed by an encoded ``llama.v1.BaseMessage``
(``core/llama_v1.py``, no protobuf), with a 10 MB read cap.  Helpers for
asyncio streams (the serving plane is asyncio) and for blocking sockets
(simple clients), and ``FrameBatcher``, which coalesces a stream's frames
per event-loop tick.

The native data plane (``native/``) serves three hot paths here:
``scan_frames``; ``encode_genresp_frame`` / ``encode_genreq_frame``,
which build a whole wire frame straight from scalars (None means "use
the codec": the library is not loaded, or a value the C encoder
does not model); and ``decode_payload_fast``, whose strict decoder
yields a ``FastBaseMessage`` for a plain GenerateResponse envelope and
defers every other shape to ``decode_payload``.  Each yields the bytes
or values of the Python codec.
"""

from __future__ import annotations

import asyncio
import ctypes
import math
import socket
import struct
import threading

from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.core import llama_v1 as pb

MAX_MESSAGE_SIZE = 10 * 1024 * 1024

_LEN = struct.Struct(">I")


class WireError(Exception):
    """Framing-level error (oversized frame, truncated stream)."""


def encode_frame(msg: pb.BaseMessage) -> bytes:
    payload = msg.SerializeToString()
    if len(payload) > MAX_MESSAGE_SIZE:
        raise WireError(f"message size {len(payload)} exceeds maximum "
                        f"{MAX_MESSAGE_SIZE}")
    return _LEN.pack(len(payload)) + payload


def decode_payload(payload: bytes) -> pb.BaseMessage:
    return pb.BaseMessage.FromString(payload)


def _check_length(length: int) -> None:
    if length > MAX_MESSAGE_SIZE:
        raise WireError(f"message size {length} exceeds maximum "
                        f"{MAX_MESSAGE_SIZE}")


async def write_length_prefixed_pb(writer: asyncio.StreamWriter,
                                   msg: pb.BaseMessage) -> None:
    writer.write(encode_frame(msg))
    await writer.drain()


async def write_frame_bytes(writer: asyncio.StreamWriter,
                            frame: bytes) -> None:
    """Write an already-encoded frame (``encode_frame`` output), so a
    caller that may retry on a second stream encodes once."""
    writer.write(frame)
    await writer.drain()


async def read_frame_payload(reader: asyncio.StreamReader,
                             timeout: float | None = None) -> bytes:
    """Read one frame and return its raw payload (not decoded)."""
    async def _read() -> bytes:
        try:
            (length,) = _LEN.unpack(await reader.readexactly(_LEN.size))
            _check_length(length)
            return await reader.readexactly(length)
        except asyncio.IncompleteReadError as e:
            raise WireError("stream closed mid-frame") from e

    if timeout is None:
        return await _read()
    return await asyncio.wait_for(_read(), timeout)


async def read_length_prefixed_pb(reader: asyncio.StreamReader,
                                  timeout: float | None = None
                                  ) -> pb.BaseMessage:
    return decode_payload(await read_frame_payload(reader, timeout))


def write_length_prefixed_pb_sync(sock: socket.socket,
                                  msg: pb.BaseMessage) -> None:
    sock.sendall(encode_frame(msg))


def read_length_prefixed_pb_sync(sock: socket.socket) -> pb.BaseMessage:
    (length,) = _LEN.unpack(_recvexact(sock, _LEN.size))
    _check_length(length)
    return decode_payload(_recvexact(sock, length))


def _recvexact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireError("stream closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


# ------------------------------------------------------- envelope fast path
#
# The native encoders and the strict decoder serve every envelope while
# the library is loaded: against the port's pure-Python codec the ctypes
# call costs less at every frame size, a one-character reply frame
# included (chip_smoke.py's ``native`` phase times both paths at 1 B to
# 64 KiB of text).  Each native dispatch is counted
# (``native.record_call("envelope")``).

_scratch = threading.local()


def _enc_buf(need: int) -> ctypes.Array:
    buf = getattr(_scratch, "buf", None)
    if buf is None or len(buf) < need:
        buf = ctypes.create_string_buffer(max(need, 1 << 16))
        _scratch.buf = buf
    return buf


def _set_str(fields, name: str, value: str) -> None:
    b = value.encode("utf-8")
    setattr(fields, name, b)
    setattr(fields, name + "_len", len(b))


def _finish(lib_call, fields, need: int) -> bytes:
    buf = _enc_buf(need)
    n = lib_call(ctypes.byref(fields), buf, len(buf))
    if n < 0:
        raise WireError("native encode capacity error")
    native.record_call("envelope")
    if n - 4 > MAX_MESSAGE_SIZE:
        raise WireError(f"message size {n - 4} exceeds maximum "
                        f"{MAX_MESSAGE_SIZE}")
    return ctypes.string_at(buf, n)


def encode_genresp_frame(
    model: str,
    response: str,
    worker_id: str = "",
    done: bool = True,
    done_reason: str = "stop",
    total_duration_ns: int = 0,
    prompt_tokens: int = 0,
    completion_tokens: int = 0,
    created_ns: int = 0,
    trace_id: str = "",
    parent_span: str = "",
) -> bytes | None:
    """A BaseMessage{generate_response} wire frame from scalars, or None
    when the library is not loaded (the caller encodes with the codec).
    ``done_reason`` is cleared when not done, as the constructors of
    ``messages`` clear it."""
    lib = native.load()
    if lib is None:
        native.record_fallback("envelope")
        return None
    f = native.ClGenRespFields()
    _set_str(f, "model", model)
    _set_str(f, "response", response)
    _set_str(f, "done_reason", done_reason if done else "")
    _set_str(f, "worker_id", worker_id)
    _set_str(f, "trace_id", trace_id)
    _set_str(f, "parent_span", parent_span)
    f.created_seconds = created_ns // 1_000_000_000
    f.created_nanos = created_ns % 1_000_000_000
    f.has_created = 1
    f.done = 1 if done else 0
    f.total_duration = total_duration_ns
    f.prompt_tokens = prompt_tokens
    f.completion_tokens = completion_tokens
    need = (4 + 64 + f.model_len + f.response_len + f.done_reason_len
            + f.worker_id_len + f.trace_id_len + f.parent_span_len)
    return _finish(lib.cl_env_encode_genresp, f, need)


def encode_genreq_frame(
    model: str,
    prompt: str = "",
    stream: bool = False,
    messages: tuple = (),
    max_tokens: int = 0,
    temperature: float = 0.0,
    top_p: float = 0.0,
    seed: int = 0,
    stop: tuple = (),
    top_k: int = 0,
    repeat_penalty: float = 0.0,
    kv_donor: str = "",
    migrate: bool = False,
    trace_id: str = "",
    parent_span: str = "",
) -> bytes | None:
    """A BaseMessage{generate_request} wire frame from scalars, or None
    when the library is not loaded or a value is one the C encoder does
    not model (a negative-zero float, an out-of-range int, a chat field
    that is not a string): the caller encodes with the codec then."""
    lib = native.load()
    if lib is None:
        native.record_fallback("envelope")
        return None
    try:
        if not (0 <= seed < 2**64) or not (-2**31 <= max_tokens < 2**31) \
                or not (-2**31 <= top_k < 2**31):
            return None
        for v in (temperature, top_p, repeat_penalty):
            if v == 0.0 and math.copysign(1.0, v) < 0:
                return None
        for m in messages:
            if not isinstance(m.get("role", "user"), str) \
                    or not isinstance(m.get("content", ""), str):
                return None
    except (TypeError, AttributeError):
        return None
    f = native.ClGenReqFields()
    _set_str(f, "model", model)
    _set_str(f, "prompt", prompt)
    _set_str(f, "kv_donor", kv_donor)
    _set_str(f, "trace_id", trace_id)
    _set_str(f, "parent_span", parent_span)
    msgs = list(messages)
    roles = [str(m.get("role", "user")).encode("utf-8") for m in msgs]
    conts = [str(m.get("content", "")).encode("utf-8") for m in msgs]
    stops = [str(s).encode("utf-8") for s in stop]
    if msgs:
        f.msg_roles = (ctypes.c_char_p * len(roles))(*roles)
        f.msg_role_lens = (ctypes.c_size_t * len(roles))(*map(len, roles))
        f.msg_contents = (ctypes.c_char_p * len(conts))(*conts)
        f.msg_content_lens = (ctypes.c_size_t * len(conts))(*map(len, conts))
    if stops:
        f.stops = (ctypes.c_char_p * len(stops))(*stops)
        f.stop_lens = (ctypes.c_size_t * len(stops))(*map(len, stops))
    f.n_msgs = len(msgs)
    f.n_stop = len(stops)
    f.stream = 1 if stream else 0
    f.max_tokens = max_tokens
    f.temperature = temperature
    f.top_p = top_p
    f.repeat_penalty = repeat_penalty
    f.top_k = top_k
    f.seed = seed
    f.migrate = 1 if migrate else 0
    need = (4 + 96 + f.model_len + f.prompt_len + f.kv_donor_len
            + f.trace_id_len + f.parent_span_len
            + sum(len(r) + len(c) + 8 for r, c in zip(roles, conts))
            + sum(len(s) + 4 for s in stops))
    return _finish(lib.cl_env_encode_genreq, f, need)


class FastTimestamp:
    """Plain mutable mirror of ``Timestamp``'s read surface."""

    __slots__ = ("seconds", "nanos")

    def __init__(self, seconds: int = 0, nanos: int = 0):
        self.seconds = seconds
        self.nanos = nanos

    def ToNanoseconds(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos


class FastGenerateResponse:
    """Plain mutable mirror of the GenerateResponse fields the gateway
    reads (and its replay trim mutates)."""

    __slots__ = ("model", "created_at", "response", "done", "done_reason",
                 "worker_id", "total_duration", "prompt_tokens",
                 "completion_tokens")

    def __init__(self) -> None:
        self.model = ""
        self.created_at = FastTimestamp()
        self.response = ""
        self.done = False
        self.done_reason = ""
        self.worker_id = ""
        self.total_duration = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0


class FastBaseMessage:
    """Decoded view of a BaseMessage whose arm is generate_response:
    ``WhichOneof``, ``generate_response``, ``trace_id`` and
    ``parent_span``, the surface the gateway's hot path touches."""

    __slots__ = ("generate_response", "trace_id", "parent_span")

    def __init__(self) -> None:
        self.generate_response = FastGenerateResponse()
        self.trace_id = ""
        self.parent_span = ""

    def WhichOneof(self, name: str) -> str | None:
        if name != "message":
            raise ValueError(f"unknown oneof {name!r}")
        return "generate_response"


def decode_payload_fast(payload: bytes) -> "pb.BaseMessage | FastBaseMessage":
    """Decode a frame payload: the native strict decoder for a plain
    GenerateResponse envelope, ``decode_payload`` for everything else.
    The strict decoder refuses any shape it is not sure about (unknown
    fields, other arms, non-canonical order), so a fast object holds
    exactly the values the Python codec would decode."""
    lib = native.load()
    if lib is None:
        native.record_fallback("envelope")
        return decode_payload(payload)
    view = getattr(_scratch, "view", None)
    if view is None:
        view = _scratch.view = native.ClGenRespView()
    if lib.cl_env_decode_genresp(payload, len(payload),
                                 ctypes.byref(view)) != 1:
        return decode_payload(payload)

    def text(off: int, n: int) -> str:
        return payload[off:off + n].decode("utf-8")

    try:
        msg = FastBaseMessage()
        resp = msg.generate_response
        resp.model = text(view.model_off, view.model_len)
        resp.response = text(view.response_off, view.response_len)
        resp.done_reason = text(view.done_reason_off, view.done_reason_len)
        resp.worker_id = text(view.worker_id_off, view.worker_id_len)
        msg.trace_id = text(view.trace_id_off, view.trace_id_len)
        msg.parent_span = text(view.parent_span_off, view.parent_span_len)
    except UnicodeDecodeError:
        # The codec validates UTF-8 too: defer so the error is its own.
        return decode_payload(payload)
    resp.done = bool(view.done)
    resp.total_duration = view.total_duration
    resp.prompt_tokens = view.prompt_tokens
    resp.completion_tokens = view.completion_tokens
    resp.created_at.seconds = view.created_seconds
    resp.created_at.nanos = view.created_nanos
    native.record_call("envelope")
    return msg


class FrameBatcher:
    """Coalesces the frame writes issued within one event-loop tick into
    one underlying ``write``: over a ``SecureWriter`` a batch of small
    frames becomes one sealed AEAD frame instead of one each.  The flush
    runs through ``loop.call_soon``, as soon as the producer suspends.

    The stream's first frame is written inline: the time to the first
    token must not depend on the producer ever suspending (a burst
    producer may emit a whole stream without yielding to the loop).
    ``drain()`` does not force a flush; it raises a captured write error
    and applies the writer's backpressure.  Pending bytes are bounded by
    ``max_pending`` (an oversized batch flushes inline).  Call ``flush()``
    before closing the stream.
    """

    def __init__(self, writer, max_pending: int = 64 * 1024):
        self._w = writer
        self._max_pending = max_pending
        self._pending = bytearray()
        self._scheduled = False
        self._first = True
        self._error: BaseException | None = None
        self.batched_writes = 0   # frames accepted
        self.flushes = 0          # underlying write calls

    def write(self, frame: bytes) -> None:
        if self._error:
            return  # surfaced on the next drain()/flush()
        self._pending += frame
        self.batched_writes += 1
        if self._first:
            self._first = False
            self._flush_now()
        elif len(self._pending) >= self._max_pending:
            self._flush_now()
        elif not self._scheduled:
            self._scheduled = True
            asyncio.get_running_loop().call_soon(self._tick)

    def _tick(self) -> None:
        self._scheduled = False
        self._flush_now()

    def _flush_now(self) -> None:
        if not self._pending or self._error:
            return
        data = bytes(self._pending)
        self._pending.clear()
        try:
            self._w.write(data)
            self.flushes += 1
        except Exception as e:  # surfaced on the next drain()/flush()
            self._error = e

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    async def drain(self) -> None:
        self._raise_pending_error()
        await self._w.drain()
        self._raise_pending_error()

    async def flush(self) -> None:
        """Force out anything still pending (end of stream)."""
        self._flush_now()
        self._raise_pending_error()
        await self._w.drain()


def scan_frames(buf: bytes | bytearray | memoryview
                ) -> tuple[list[bytes], int]:
    """Every complete frame payload in ``buf`` -> (payloads, bytes
    consumed); bytes past ``consumed`` are an incomplete trailing frame for
    the caller to keep.  Raises WireError on a frame declaring a length
    over the cap.  The native scanner serves when the library is loaded."""
    data = bytes(buf)
    lib = native.load()
    if lib is not None:
        max_frames = max(1, len(data) // 4)
        offs = (ctypes.c_uint32 * max_frames)()
        sizes = (ctypes.c_uint32 * max_frames)()
        consumed = ctypes.c_size_t(0)
        n = lib.cl_frame_scan(data, len(data), MAX_MESSAGE_SIZE, offs, sizes,
                              max_frames, ctypes.byref(consumed))
        if n < 0:
            raise WireError("frame exceeds maximum size")
        native.record_call("frame_scan")
        return ([data[offs[i]:offs[i] + sizes[i]] for i in range(n)],
                consumed.value)
    native.record_fallback("frame_scan")
    payloads: list[bytes] = []
    pos = 0
    while pos + _LEN.size <= len(data):
        (length,) = _LEN.unpack_from(data, pos)
        if length > MAX_MESSAGE_SIZE:
            raise WireError("frame exceeds maximum size")
        if pos + _LEN.size + length > len(data):
            break
        payloads.append(data[pos + _LEN.size:pos + _LEN.size + length])
        pos += _LEN.size + length
    return payloads, pos


class SyncFrameReader:
    """Buffered multi-frame reader for blocking sockets: one recv can
    yield many frames (a streaming response is one frame per chunk).  The
    scan runs only once the first frame is complete, so a large frame
    received in many small recvs is not rescanned per recv."""

    def __init__(self, sock: socket.socket, recv_size: int = 65536):
        self._sock = sock
        self._recv_size = recv_size
        self._buf = bytearray()
        self._ready: list[bytes] = []

    def _first_frame_complete(self) -> bool:
        if len(self._buf) < _LEN.size:
            return False
        (length,) = _LEN.unpack_from(self._buf, 0)
        _check_length(length)
        return len(self._buf) >= _LEN.size + length

    def read_message(self) -> pb.BaseMessage:
        while not self._ready:
            if self._first_frame_complete():
                payloads, consumed = scan_frames(self._buf)
                del self._buf[:consumed]
                self._ready.extend(payloads)
                continue
            chunk = self._sock.recv(self._recv_size)
            if not chunk:
                raise WireError("stream closed mid-frame")
            self._buf.extend(chunk)
        return decode_payload(self._ready.pop(0))
