"""Unix-domain-socket IPC server.

Counterpart of ``crowdllama_tpu/ipc/server.py``: a socket for a desktop
app (mode 0600, bound under umask 0o177 so it is never world-connectable,
not even between bind and chmod).  Framing is told apart by the first
byte: ``{`` starts a newline-delimited JSON message, anything else the
4-byte big-endian length of a llama.v1 frame (whose first byte is 0x00
for any frame under the cap).  PB frames go through ``engine.handle``;
a frame that does not decode, or declares a length of 0 or over the cap,
drops the connection.

JSON message types: ``ping`` -> ``pong``; ``initialize`` {mode} -> ack;
``prompt`` {text, model?} -> {response}; ``embed`` {input, model?} ->
{embeddings, prompt_tokens}; ``profile`` {seconds} -> {trace_dir}
(engines with ``capture_profile``); ``status``; anything else -> error.
Replies are ``json.dumps(obj, separators=(",", ":"))`` plus a newline,
byte for byte the JAX server's.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
from pathlib import Path

from crowdllama_tpu_torch.core import llama_v1 as pb
from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import create_generate_request
from crowdllama_tpu_torch.engine.engine import Engine

log = logging.getLogger("crowdllama.torch.ipc")

_LEN = struct.Struct(">I")


class IPCServer:
    def __init__(self, socket_path: str, engine: Engine, peer=None):
        self.socket_path = socket_path
        self.engine = engine
        self.peer = peer  # optional live peer for status queries
        self._server: asyncio.Server | None = None

    @property
    def _peer_id(self) -> str:
        return self.peer.peer_id if self.peer is not None else ""

    async def start(self) -> None:
        path = Path(self.socket_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.exists():
            path.unlink()
        old_umask = os.umask(0o177)
        try:
            self._server = await asyncio.start_unix_server(self._handle,
                                                           path=str(path))
        finally:
            os.umask(old_umask)
        os.chmod(path, 0o600)
        log.info("ipc listening on %s", path)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        try:
            Path(self.socket_path).unlink(missing_ok=True)
        except OSError:
            pass

    # ------------------------------------------------------------- framing

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                # One byte first, so a short JSON line never splices into
                # the next message.
                first = await reader.read(1)
                if not first:
                    break
                if first == b"{":
                    rest = await reader.readline()
                    await self._handle_json_line(first + rest, writer)
                    continue
                try:
                    (length,) = _LEN.unpack(first
                                            + await reader.readexactly(3))
                    if not 0 < length <= wire.MAX_MESSAGE_SIZE:
                        raise ValueError(f"bad frame length {length}")
                    msg = wire.decode_payload(
                        await reader.readexactly(length))
                except (asyncio.IncompleteReadError, ValueError):
                    break  # truncated or unframeable: drop the connection
                await self._handle_pb(msg, writer)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            log.exception("ipc connection error")
        finally:
            writer.close()

    async def _handle_pb(self, msg: pb.BaseMessage,
                         writer: asyncio.StreamWriter) -> None:
        reply = await self.engine.handle(msg, worker_id=self._peer_id)
        await wire.write_length_prefixed_pb(writer, reply)

    async def _handle_json_line(self, data: bytes,
                                writer: asyncio.StreamWriter) -> None:
        try:
            obj = json.loads(data)
        except json.JSONDecodeError:
            await self._send_json(writer, {"type": "error",
                                           "error": "unparseable message"})
            return
        mtype = obj.get("type", "")
        if mtype == "ping":
            await self._send_json(writer, {"type": "pong"})
        elif mtype == "initialize":
            await self._send_json(writer, {
                "type": "initialized", "mode": obj.get("mode", "consumer"),
                "peer_id": self._peer_id})
        elif mtype == "prompt":
            text = obj.get("text") or obj.get("prompt") or ""
            try:
                reply = await self.engine.handle(
                    create_generate_request(model=obj.get("model", ""),
                                            prompt=text),
                    worker_id=self._peer_id)
                await self._send_json(writer, {
                    "type": "response",
                    "response": reply.generate_response.response,
                    "done": True})
            except Exception as e:
                await self._send_json(writer, {"type": "error",
                                               "error": str(e)})
        elif mtype == "embed":
            inputs = obj.get("input")
            if inputs is None:
                inputs = obj.get("text", "")
            if isinstance(inputs, str):
                inputs = [inputs]
            try:
                vecs, n_tokens = await self.engine.embed(
                    inputs, model=obj.get("model", ""))
                await self._send_json(writer, {
                    "type": "embeddings", "embeddings": vecs,
                    "prompt_tokens": n_tokens})
            except Exception as e:
                await self._send_json(writer, {"type": "error",
                                               "error": str(e)})
        elif mtype == "profile":
            capture = getattr(self.engine, "capture_profile", None)
            if capture is None:
                await self._send_json(writer, {
                    "type": "error",
                    "error": "engine does not support profiling"})
                return
            try:
                path = await capture(float(obj.get("seconds", 3.0)))
                await self._send_json(writer, {"type": "profile",
                                               "trace_dir": path})
            except Exception as e:
                await self._send_json(writer, {"type": "error",
                                               "error": str(e)})
        elif mtype == "status":
            workers = []
            if (self.peer is not None
                    and self.peer.peer_manager is not None):
                workers = [p.peer_id
                           for p in self.peer.peer_manager.get_workers()]
            await self._send_json(writer, {
                "type": "status", "peer_id": self._peer_id,
                "workers": workers})
        else:
            await self._send_json(writer, {
                "type": "error", "error": f"unknown type {mtype!r}"})

    @staticmethod
    async def _send_json(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write(json.dumps(obj, separators=(",", ":")).encode() + b"\n")
        await writer.drain()
