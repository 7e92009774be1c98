"""Asyncio TCP stream host with authenticated, encrypted protocol streams.

Counterpart of ``crowdllama_tpu/net/host.py`` over direct TCP: a node
listens on one port; every logical *stream* is a fresh TCP connection
opened with a signed hello naming a protocol ID, dispatched to the handler
registered for that protocol.  Identity is an Ed25519 key; peer IDs derive
from the public key, so a forged hello fails signature or ID
verification.  Each signed hello carries an ephemeral X25519 key covered
by the signature; the ECDH secret keys the AEAD frames of
``net/secure.py``, and there is no plaintext mode.  The wire bytes are the
JAX host's, so a port host and a JAX host handshake either way.

Not ported: the relay splice, hole punching and connection reversal.
Dialing a relayed contact raises ``HandshakeError`` naming the missing
rung; an inbound reversal marker is refused as an unknown protocol.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from crowdllama_tpu_torch.net.secure import (
    SecureReader,
    SecureWriter,
    derive_keys,
    ecdh,
)
from crowdllama_tpu_torch.testing import faults
from crowdllama_tpu_torch.utils.crypto import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
    InvalidSignature,
    X25519PrivateKey,
)
from crowdllama_tpu_torch.utils.keys import peer_id_from_public_key

_LEN = struct.Struct(">I")
MAX_JSON_FRAME = 1 * 1024 * 1024
HELLO_MAX_SKEW = 300.0  # seconds of clock skew tolerated in signed hellos
HANDSHAKE_TIMEOUT = 10.0
#: Default idle window for pooled streams; the serving side of a pooled
#: protocol holds its read loop open at least this long (plus slack).
STREAM_POOL_IDLE_S = 30.0

log = logging.getLogger("crowdllama.torch.net.host")


class HandshakeError(Exception):
    pass


async def write_json_frame(writer: asyncio.StreamWriter, obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > MAX_JSON_FRAME:
        raise ValueError(f"json frame too large: {len(payload)}")
    writer.write(_LEN.pack(len(payload)) + payload)
    await writer.drain()


async def read_json_frame(reader: asyncio.StreamReader,
                          timeout: float | None = None) -> dict:
    async def _read() -> dict:
        try:
            header = await reader.readexactly(_LEN.size)
            (length,) = _LEN.unpack(header)
            if length > MAX_JSON_FRAME:
                raise HandshakeError(f"json frame too large: {length}")
            payload = await reader.readexactly(length)
        except asyncio.IncompleteReadError as e:
            raise HandshakeError("stream closed mid-frame") from e
        obj = json.loads(payload)
        if not isinstance(obj, dict):
            raise HandshakeError("json frame is not an object")
        return obj

    if timeout is None:
        return await _read()
    return await asyncio.wait_for(_read(), timeout)


@dataclass(frozen=True)
class Contact:
    """A dialable peer: identity + address.  ``relay=True`` marks a
    relayed address (a relay node's, reached through a splice)."""

    peer_id: str
    host: str
    port: int
    relay: bool = False

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def to_dict(self) -> dict:
        d = {"peer_id": self.peer_id, "host": self.host, "port": self.port}
        if self.relay:
            d["relay"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Contact":
        return cls(peer_id=str(d["peer_id"]), host=str(d["host"]),
                   port=int(d["port"]), relay=bool(d.get("relay", False)))


@dataclass
class Stream:
    """An open protocol-tagged byte stream to an authenticated peer;
    reader/writer are the AEAD adapters of ``net/secure.py``."""

    protocol: str
    remote_peer_id: str
    remote_contact: Contact | None  # None when the remote is not listening
    reader: SecureReader
    writer: SecureWriter

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:  # pragma: no cover - best-effort close
            pass


def _hello_signing_bytes(proto: str, peer_id: str, ts: float, nonce: str,
                         listen_port: int, eph_hex: str) -> bytes:
    """Bytes a hello/ack signature covers: ``nonce`` is the remote's fresh
    challenge (no replay), ``listen_port`` the advertised dial-back port,
    ``eph_hex`` the X25519 ephemeral key (no key substitution)."""
    return b"crowdllama-tpu-hello|" + "|".join(
        [proto, peer_id, f"{ts:.3f}", nonce, str(listen_port), eph_hex]
    ).encode()


StreamHandler = Callable[[Stream], Awaitable[None]]


class StreamPool:
    """Idle-stream reuse keyed by remote: amortizes TCP + the signed hello
    over many exchanges.  Borrowing is exclusive (``get`` pops); after
    ``close()`` late ``put`` calls close their stream."""

    def __init__(self, max_per_key: int = 2,
                 idle_s: float = STREAM_POOL_IDLE_S):
        self.max_per_key = max_per_key
        self.idle_s = idle_s
        self._pools: dict[str, list] = {}
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.evicted_dead = 0  # pooled streams the remote had closed

    @staticmethod
    def _transport_dead(s: Stream) -> bool:
        try:
            return bool(s.reader.at_eof())
        except Exception:
            return True

    def get(self, key: str) -> Stream | None:
        pool = self._pools.get(key, [])
        while pool:
            s, ts = pool.pop()
            if (time.monotonic() - ts < self.idle_s
                    and not s.writer.is_closing()):
                if self._transport_dead(s):
                    self.evicted_dead += 1
                    s.close()
                    continue
                self.hits += 1
                return s
            s.close()
        self.misses += 1
        return None

    def put(self, key: str, s: Stream) -> None:
        if self._closed or s.writer.is_closing():
            s.close()
            return
        pool = self._pools.setdefault(key, [])
        if len(pool) >= self.max_per_key:
            s.close()
            return
        pool.append((s, time.monotonic()))

    def close_key(self, key: str) -> None:
        for s, _ts in self._pools.pop(key, []):
            s.close()

    def close(self) -> None:
        self._closed = True
        for pool in self._pools.values():
            for s, _ts in pool:
                s.close()
        self._pools.clear()


class Host:
    """One listening node; opens and accepts authenticated streams."""

    def __init__(self, key: Ed25519PrivateKey, listen_host: str = "0.0.0.0",
                 listen_port: int = 0, advertise_host: str | None = None):
        self.key = key
        self.public_key = key.public_key()
        self.peer_id = peer_id_from_public_key(self.public_key)
        self.listen_host = listen_host
        self.listen_port = listen_port
        self.advertise_host = advertise_host
        self._handlers: dict[str, StreamHandler] = {}
        self._server: asyncio.Server | None = None
        # peerstore: peer_id -> Contact learned from hellos / DHT results
        self.peerstore: dict[str, Contact] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        self.stats: dict[str, int] = {
            "streams_in": 0, "streams_out": 0, "rejected": 0,
            # Cumulative client-side handshake time (signed hello + ECDH).
            "handshake_ns": 0,
        }
        # Dial attempts by (rung, outcome); the port climbs only "direct".
        self.dial_ladder: dict[tuple[str, str], int] = {}

    def _ladder_inc(self, outcome: str) -> None:
        key = ("direct", outcome)
        self.dial_ladder[key] = self.dial_ladder.get(key, 0) + 1

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.listen_host, self.listen_port)
        self.listen_port = self._server.sockets[0].getsockname()[1]
        log.debug("host %s listening on %s:%d", self.peer_id[:8],
                  self.listen_host, self.listen_port)

    async def close(self) -> None:
        # Cancel in-flight handlers before wait_closed(): on Python 3.12 it
        # waits for every handler, and one parked in a long read would
        # deadlock shutdown.
        if self._server is not None:
            self._server.close()
        while True:
            # A just-accepted handler may not have registered yet: yield
            # once, then cancel what is there, until nothing is.
            await asyncio.sleep(0)
            tasks = list(self._conn_tasks)
            if not tasks:
                break
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    @property
    def contact(self) -> Contact:
        host = self.advertise_host or (
            "127.0.0.1" if self.listen_host in ("0.0.0.0", "::")
            else self.listen_host)
        return Contact(peer_id=self.peer_id, host=host, port=self.listen_port)

    def set_stream_handler(self, protocol: str,
                           handler: StreamHandler) -> None:
        self._handlers[protocol] = handler

    # -- outbound ----------------------------------------------------------

    async def new_stream(self, target: Contact | str, protocol: str,
                         timeout: float = HANDSHAKE_TIMEOUT) -> Stream:
        """Dial a peer and open an authenticated stream for ``protocol``.
        ``target`` is a Contact (identity checked against its peer_id) or
        a bare "host:port" (identity learned from the remote hello)."""
        await faults.inject(
            "host.new_stream", protocol=protocol,
            peer=target.peer_id if isinstance(target, Contact) else "")
        if isinstance(target, Contact) and target.relay:
            raise HandshakeError(
                f"peer {target.peer_id[:8]} is reachable only through a "
                f"relay ({target.addr}): the relay splice, hole punch and "
                "connection reversal rungs are not ported to "
                "crowdllama_tpu_torch yet")
        if isinstance(target, Contact):
            host, port, expect_id = target.host, target.port, target.peer_id
        else:
            host, _, port_s = target.rpartition(":")
            host, port, expect_id = host or "127.0.0.1", int(port_s), None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout)
        except Exception:
            self._ladder_inc("fail")
            raise
        try:
            stream = await self._client_handshake(
                reader, writer, protocol, expect_id, timeout,
                Contact(expect_id or "", host, port))
        except Exception:
            writer.close()
            self._ladder_inc("fail")
            raise
        self._ladder_inc("ok")
        return stream

    async def _client_handshake(self, reader, writer, protocol: str,
                                expect_id: str | None, timeout: float,
                                dialed: Contact) -> Stream:
        """Client side of the signed-hello + AEAD handshake."""
        t_hs = time.perf_counter_ns()
        # Nonce exchange: we challenge the server, it challenges us.
        my_nonce = os.urandom(16).hex()
        await write_json_frame(writer, {"proto": protocol, "nonce": my_nonce})
        challenge = await read_json_frame(reader, timeout)
        if challenge.get("error"):
            raise HandshakeError(
                f"remote rejected stream: {challenge['error']}")
        server_nonce = str(challenge.get("nonce", ""))
        if not server_nonce:
            raise HandshakeError("missing server nonce")
        eph = X25519PrivateKey.generate()
        eph_hex = eph.public_key().public_bytes_raw().hex()
        ts = time.time()
        lport = self.listen_port
        sig = self.key.sign(_hello_signing_bytes(
            protocol, self.peer_id, ts, server_nonce, lport, eph_hex))
        await write_json_frame(writer, {
            "proto": protocol, "peer_id": self.peer_id,
            "pubkey": self._pubkey_hex(), "ts": ts, "sig": sig.hex(),
            "listen_port": lport, "eph": eph_hex})
        ack = await read_json_frame(reader, timeout)
        if not ack.get("ok"):
            raise HandshakeError(
                f"remote rejected stream: {ack.get('error', 'unknown')}")
        remote_id, remote_eph = _verify_hello(ack, protocol, my_nonce)
        if expect_id is not None and remote_id != expect_id:
            raise HandshakeError(f"peer identity mismatch: expected "
                                 f"{expect_id[:8]} got {remote_id[:8]}")
        c2s, s2c = derive_keys(ecdh(eph, remote_eph), protocol, self.peer_id,
                               remote_id, my_nonce, server_nonce)
        remote_contact = Contact(remote_id, dialed.host, dialed.port)
        self.peerstore[remote_id] = remote_contact
        self.stats["streams_out"] += 1
        self.stats["handshake_ns"] += time.perf_counter_ns() - t_hs
        return Stream(protocol=protocol, remote_peer_id=remote_id,
                      remote_contact=remote_contact,
                      reader=SecureReader(reader, s2c),
                      writer=SecureWriter(writer, c2s))

    # -- inbound -----------------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        await self._serve_pipe(reader, writer,
                               writer.get_extra_info("peername"))

    async def _serve_pipe(self, reader, writer, peername) -> None:
        """Server side of the handshake, then the handler."""
        handshaked = False
        try:
            opening = await read_json_frame(reader, HANDSHAKE_TIMEOUT)
            proto = str(opening.get("proto", ""))
            client_nonce = str(opening.get("nonce", ""))
            handler = self._handlers.get(proto)
            if handler is None:
                self.stats["rejected"] += 1
                await write_json_frame(
                    writer, {"error": f"unknown protocol {proto!r}"})
                return
            my_nonce = os.urandom(16).hex()
            await write_json_frame(writer, {"nonce": my_nonce})
            hello = await read_json_frame(reader, HANDSHAKE_TIMEOUT)
            if str(hello.get("proto", "")) != proto:
                raise HandshakeError("protocol changed mid-handshake")
            remote_id, remote_eph = _verify_hello(hello, proto, my_nonce)
            # A dialable contact for the remote: observed source host + its
            # advertised listening port.
            remote_contact: Contact | None = None
            lport = int(hello.get("listen_port", 0))
            if peername and lport > 0:
                remote_contact = Contact(remote_id, peername[0], lport)
                self.peerstore[remote_id] = remote_contact
            eph = X25519PrivateKey.generate()
            eph_hex = eph.public_key().public_bytes_raw().hex()
            ts = time.time()
            sig = self.key.sign(_hello_signing_bytes(
                proto, self.peer_id, ts, client_nonce, self.listen_port,
                eph_hex))
            await write_json_frame(writer, {
                "ok": True, "proto": proto, "peer_id": self.peer_id,
                "pubkey": self._pubkey_hex(), "ts": ts, "sig": sig.hex(),
                "listen_port": self.listen_port, "eph": eph_hex})
            c2s, s2c = derive_keys(ecdh(eph, remote_eph), proto, remote_id,
                                   self.peer_id, client_nonce, my_nonce)
            stream = Stream(
                protocol=proto, remote_peer_id=remote_id,
                remote_contact=remote_contact,
                reader=SecureReader(reader, c2s),
                writer=SecureWriter(writer, s2c))
            self.stats["streams_in"] += 1
            handshaked = True
            await handler(stream)
        except (HandshakeError, json.JSONDecodeError,
                asyncio.TimeoutError) as e:
            # Only handshake-phase failures are rejections.
            if not handshaked:
                self.stats["rejected"] += 1
            log.debug("inbound stream rejected: %s", e)
        except asyncio.CancelledError:  # host shutting down
            raise
        except Exception:
            log.exception("stream handler error")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _pubkey_hex(self) -> str:
        return self.public_key.public_bytes_raw().hex()


def _verify_hello(hello: dict, proto: str,
                  expected_nonce: str) -> tuple[str, bytes]:
    """Verify a signed hello/ack against our challenge; returns (peer ID,
    ephemeral X25519 public key).  A hello without an identity-bound
    ephemeral key is refused: there is no plaintext mode."""
    try:
        peer_id = str(hello["peer_id"])
        pubkey_raw = bytes.fromhex(str(hello["pubkey"]))
        ts = float(hello["ts"])
        listen_port = int(hello.get("listen_port", 0))
        sig = bytes.fromhex(str(hello["sig"]))
        eph_hex = str(hello["eph"])
        eph_raw = bytes.fromhex(eph_hex)
        if len(eph_raw) != 32:
            raise ValueError("bad ephemeral key length")
    except (KeyError, ValueError, TypeError) as e:
        raise HandshakeError(f"malformed hello: {e}") from e
    if abs(time.time() - ts) > HELLO_MAX_SKEW:
        raise HandshakeError("hello timestamp outside accepted window")
    try:
        pub = Ed25519PublicKey.from_public_bytes(pubkey_raw)
        pub.verify(sig, _hello_signing_bytes(proto, peer_id, ts,
                                             expected_nonce, listen_port,
                                             eph_hex))
    except (InvalidSignature, ValueError) as e:
        raise HandshakeError("hello signature verification failed") from e
    if peer_id_from_public_key(pub) != peer_id:
        raise HandshakeError("peer id does not match public key")
    return peer_id, eph_raw
