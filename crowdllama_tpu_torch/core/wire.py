"""Length-prefixed llama.v1 framing over byte streams.

Counterpart of ``crowdllama_tpu/core/wire.py`` (its framing, socket
helpers and frame scanner): a frame is a 4-byte big-endian length followed
by an encoded ``llama.v1.BaseMessage`` (``core/llama_v1.py``, no
protobuf), with a 10 MB read cap.  Helpers for asyncio streams (the
serving plane is asyncio) and for blocking sockets (simple clients), and
``FrameBatcher``, which coalesces a stream's frames per event-loop tick.
The JAX package's native envelope encoder is not ported.
"""

from __future__ import annotations

import asyncio
import socket
import struct

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
    over the cap."""
    data = bytes(buf)
    payloads: list[bytes] = []
    pos = 0
    while pos + _LEN.size <= len(data):
        (length,) = _LEN.unpack_from(data, pos)
        _check_length(length)
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
