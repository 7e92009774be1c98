"""Asyncio TCP stream host with authenticated, encrypted protocol streams.

Counterpart of ``crowdllama_tpu/net/host.py``: a node listens on one
port; every logical *stream* is a fresh TCP connection opened with a
signed hello naming a protocol ID, dispatched to the handler registered
for that protocol.  Identity is an Ed25519 key; peer IDs derive from the
public key, so a forged hello fails signature or ID verification.  Each
signed hello carries an ephemeral X25519 key covered by the signature;
the ECDH secret keys the AEAD frames of ``net/secure.py``, and there is
no plaintext mode.  The wire bytes are the JAX host's, so a port host and
a JAX host handshake either way.

A contact marked ``relay=True`` (a NATed peer reached through a relay,
``net/relay.py``) is dialed up a ladder of rungs: connection reversal
(the peer dials a dial-back-confirmed requester directly), a
relay-coordinated TCP hole punch, and the relay splice.  Every rung runs
the same signed hello and AEAD handshake end to end, so a relay sees only
ciphertext.  ``dial_ladder`` counts each rung's outcomes and
``stats_by_addr_class`` the distinct inbound peers per address class.
"""

from __future__ import annotations

import asyncio
import ipaddress
import json
import logging
import os
import socket
import struct
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from crowdllama_tpu_torch.core.protocol import (
    RELAY_PROTOCOL,
    REVERSE_PROTOCOL,
)
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
# Connection reversal: how long to wait for the reversed dial before the
# splice fallback, and how long to skip reversal to a peer whose reversal
# failed (its NAT filters egress, or its relay dropped the signal).
REVERSE_WAIT = 4.0
REVERSE_FAIL_COOLDOWN = 60.0
# Hole punch (a listener plus repeated connects from the port whose NAT
# mapping the relay observed): per-attempt connect budget, attempt count,
# the per-peer cooldown after a failed punch, and a cap on one whole
# punch so a symmetric-NAT peer costs little before the splice.
PUNCH_ATTEMPTS = 4
PUNCH_CONNECT_TIMEOUT = 0.5
PUNCH_FAIL_COOLDOWN = 60.0
PUNCH_TOTAL_BUDGET = 3.5
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
    # Socket-observed source IP and port of an INBOUND stream ("" / 0 for
    # outbound and relayed ones): the relay's dial-back probe needs the
    # IP, and hole-punch coordination the endpoint (it is the peer's NAT
    # mapping for that socket).
    observed_ip: str = ""
    observed_port: int = 0

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:  # pragma: no cover - best-effort close
            pass


def _addr_class(host: str) -> str:
    """loopback / private / public / hostname: where an address is
    reachable from."""
    try:
        ip = ipaddress.ip_address(host)
    except ValueError:
        return "hostname"
    if ip.is_loopback:
        return "loopback"
    if ip.is_private or ip.is_link_local:
        return "private"
    return "public"


def _hello_signing_bytes(proto: str, peer_id: str, ts: float, nonce: str,
                         listen_port: int, eph_hex: str) -> bytes:
    """Bytes a hello/ack signature covers: ``nonce`` is the remote's fresh
    challenge (no replay), ``listen_port`` the advertised dial-back port,
    ``eph_hex`` the X25519 ephemeral key (no key substitution)."""
    return b"crowdllama-tpu-hello|" + "|".join(
        [proto, peer_id, f"{ts:.3f}", nonce, str(listen_port), eph_hex]
    ).encode()


StreamHandler = Callable[[Stream], Awaitable[None]]


def _reuse_socket(local_port: int, remote_host: str = ""):
    """A SO_REUSEADDR/SO_REUSEPORT TCP socket bound to ``local_port`` on
    the wildcard address of the family ``remote_host`` implies (IPv6
    literals get an AF_INET6 socket — the relay control stream dials
    through here, and an IPv6 relay must keep working)."""
    v6 = ":" in remote_host
    sock = socket.socket(
        socket.AF_INET6 if v6 else socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if hasattr(socket, "SO_REUSEPORT"):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.setblocking(False)
    sock.bind(("::" if v6 else "0.0.0.0", local_port))
    return sock


async def punch_establish(local_port: int, host: str, port: int,
                          on_established, attempts: int = PUNCH_ATTEMPTS,
                          listen_sock=None):
    """Classic TCP hole punch from ``local_port`` toward ``host:port``:
    LISTEN on the port (SO_REUSEADDR/SO_REUSEPORT — it is already in use
    by the live signaling stream whose NAT mapping we are reusing) while
    repeatedly CONNECTing to the remote endpoint.  The outbound SYNs open
    our NAT's filter toward the remote even when they are themselves
    dropped; the connection that lands first — accepted OR outbound —
    is handed to ``on_established(reader, writer)`` (a SYNC callback —
    spawn tasks, don't block — called for EVERY establishment: crossed
    punches can yield one connection per direction, and only the
    opening-frame exchange decides which one carries the protocol; the
    orphan idles out at the handshake timeout).

    Pure simultaneous open (connect-only on both sides) is NOT workable:
    the SYNs must cross in flight, which loopback and low-latency paths
    essentially never achieve.  Returns when at least one connection
    established, raising after the attempt budget otherwise.

    ``listen_sock``: a pre-bound reuse socket to listen on (the punch
    REQUESTER binds its listener before dialing the relay, so the port
    is conflict-free by construction).  Without one, a wildcard listener
    is attempted on ``local_port`` — and a bind conflict (a TIME_WAIT
    stranger without SO_REUSEPORT can block the share) degrades to
    connect-only, which still succeeds whenever the other side listens.
    """
    loop = asyncio.get_running_loop()
    established = asyncio.Event()

    async def _accepted(reader, writer):
        established.set()
        on_established(reader, writer)

    if listen_sock is not None:
        try:
            server = await asyncio.start_server(_accepted, sock=listen_sock)
        except BaseException:
            listen_sock.close()
            raise
    else:
        try:
            server = await asyncio.start_server(
                _accepted, "::" if ":" in host else "0.0.0.0", local_port,
                reuse_address=True,
                reuse_port=hasattr(socket, "SO_REUSEPORT"))
        except OSError:
            server = None  # connect-only
    last: Exception | None = None
    try:
        for _ in range(attempts):
            sock = _reuse_socket(local_port, host)
            try:
                await asyncio.wait_for(
                    loop.sock_connect(sock, (host, port)),
                    PUNCH_CONNECT_TIMEOUT)
                reader, writer = await asyncio.open_connection(sock=sock)
                established.set()
                on_established(reader, writer)
                return
            except asyncio.CancelledError:
                sock.close()
                raise
            except Exception as e:
                last = e
                sock.close()
            try:
                await asyncio.wait_for(established.wait(), 0.15)
                return  # the listener side landed one
            except asyncio.TimeoutError:
                pass
        if established.is_set():
            return
        # Last chance: a crossed inbound may land moments after our final
        # connect attempt failed — waiting HERE (before deciding failure)
        # means a late establishment becomes success instead of a leaked
        # connection delivered during a raised exception.
        try:
            await asyncio.wait_for(established.wait(), 0.3)
            return
        except asyncio.TimeoutError:
            pass
        raise HandshakeError(f"hole punch to {host}:{port} failed: {last}")
    finally:
        # Served/handed-off connections continue independently.
        if server is not None:
            server.close()


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
    """One listening node; opens/accepts authenticated protocol streams."""

    def __init__(
        self,
        key: Ed25519PrivateKey,
        listen_host: str = "0.0.0.0",
        listen_port: int = 0,
        advertise_host: str | None = None,
    ):
        self.key = key
        self.public_key = key.public_key()
        self.peer_id = peer_id_from_public_key(self.public_key)
        self.listen_host = listen_host
        self.listen_port = listen_port
        self.advertise_host = advertise_host
        # NAT relay state (net/relay.py): when set, .contact advertises the
        # relay address, and hellos advertise listen_port 0 so remote
        # peerstores never learn this node's (unreachable) direct address.
        self.relay_contact: Contact | None = None
        self.hello_dialable = True
        # Connection reversal (REVERSE_PROTOCOL): True once a dialback
        # probe confirmed OUR listen port is publicly reachable — only
        # then do relayed dials ask the target to dial us back directly
        # (None = unknown, False = confirmed NATed; both mean "splice").
        self.reverse_dialable: bool | None = None
        self._reverse_waiters: dict[str, asyncio.Future] = {}
        # peer_id -> monotonic time of last failed reversal: a worker that
        # cannot dial us back (egress-filtered NAT) must not cost every
        # later stream the reversal wait — go straight to the splice for
        # a cooldown instead.
        self._reverse_failed_at: dict[str, float] = {}
        self._punch_failed_at: dict[str, float] = {}
        self._handlers: dict[str, StreamHandler] = {}
        self._server: asyncio.Server | None = None
        # peerstore: peer_id -> Contact learned from hellos / DHT results
        self.peerstore: dict[str, Contact] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        # Connection statistics: stream counts per kind, rejections.
        self.stats: dict[str, int] = {
            "streams_in": 0, "streams_out": 0, "rejected": 0,
            # Cumulative client-side handshake time (signed hello + ECDH),
            # surfaced as crowdllama_host_handshake_seconds_total by
            # obs/http.py: rate(handshake)/rate(streams_out) is the dial
            # overhead a trace's "dial" span attributes per request.
            "handshake_ns": 0,
        }
        self.stats_by_protocol: dict[str, int] = {}
        # Dial-ladder attempts by (rung, outcome) — rungs are the NAT
        # traversal strategies in fallback order (direct, reverse, punch,
        # splice).  Rendered as crowdllama_dial_ladder_attempts_total by
        # obs/http.py; rate(fail)/rate(ok) per rung is the connectivity
        # health an operator reads before blaming the model for latency.
        self.dial_ladder: dict[tuple[str, str], int] = {}
        # DISTINCT inbound peers by address class.  Deduped by peer id —
        # streams are per-RPC, so a
        # raw stream count would explode with every refresh loop.
        self._peers_by_addr_class: dict[str, set[str]] = {}

    @property
    def stats_by_addr_class(self) -> dict[str, int]:
        """Distinct authenticated inbound peers per address class."""
        return {k: len(v) for k, v in self._peers_by_addr_class.items()}

    def _ladder_inc(self, rung: str, outcome: str) -> None:
        key = (rung, outcome)
        self.dial_ladder[key] = self.dial_ladder.get(key, 0) + 1

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.listen_host, self.listen_port
        )
        self.listen_port = self._server.sockets[0].getsockname()[1]
        log.debug("host %s listening on %s:%d", self.peer_id[:8],
                  self.listen_host, self.listen_port)

    async def close(self) -> None:
        # Cancel in-flight connection handlers BEFORE wait_closed(): on
        # Python 3.12 Server.wait_closed() waits for every handler to finish,
        # so a handler parked in a timeout-less read (e.g. a long-lived
        # service loop) would deadlock shutdown if cancelled after.
        if self._server is not None:
            self._server.close()
        while True:
            # A just-accepted handler task may exist but not yet have run its
            # first step (where it registers in _conn_tasks); yield once so it
            # registers, then cancel.  Loop until no handlers remain.
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
        if self.relay_contact is not None:
            return self.relay_contact
        host = self.advertise_host or (
            "127.0.0.1" if self.listen_host in ("0.0.0.0", "::")
            else self.listen_host
        )
        return Contact(peer_id=self.peer_id, host=host, port=self.listen_port)

    @property
    def _hello_port(self) -> int:
        """Port advertised in hellos (0 = not directly dialable)."""
        return self.listen_port if self.hello_dialable else 0

    # -- handlers ----------------------------------------------------------

    def set_stream_handler(self, protocol: str,
                           handler: StreamHandler) -> None:
        self._handlers[protocol] = handler

    # -- outbound ----------------------------------------------------------

    async def new_stream(
        self, target: Contact | str, protocol: str,
        timeout: float = HANDSHAKE_TIMEOUT, reuse_sock: bool = False,
        local_port: int = 0, trace_id: str = "",
    ) -> Stream:
        """Dial a peer and open an authenticated stream for ``protocol``.

        ``target`` may be a Contact (identity verified against its peer_id) or
        a bare "host:port" address (identity learned from the remote hello, as
        when dialing a bootstrap address).

        ``trace_id`` rides the relay ``connect`` control frame when the dial
        falls back to a splice: the relay forwards only sealed ciphertext and
        can never see the envelope's trace fields, so this is the one place
        the id can cross to the relay node for span recording.  The control
        channel is authenticated, and a trace id carries no payload data.

        ``reuse_sock`` dials from a SO_REUSEADDR/SO_REUSEPORT socket:
        hole punching rebinds the LOCAL port of a live signaling stream
        (its NAT mapping is the punch target), which the kernel only
        allows when the original socket carried the reuse options too.
        ``local_port`` pins that socket's local bind (the punch requester
        dials the relay FROM the port its pre-bound listener owns).
        """
        await faults.inject(
            "host.new_stream", protocol=protocol,
            peer=target.peer_id if isinstance(target, Contact) else "")
        if isinstance(target, Contact) and target.relay:
            return await self._new_stream_via_relay(target, protocol, timeout,
                                                    trace_id)
        if isinstance(target, Contact):
            host, port, expect_id = target.host, target.port, target.peer_id
        else:
            host, _, port_s = target.rpartition(":")
            host, port, expect_id = host or "127.0.0.1", int(port_s), None

        if reuse_sock:
            # Resolve BEFORE picking the socket family: an IPv6-only
            # hostname must get an AF_INET6 socket (the plain
            # open_connection path handled this via happy eyeballs; the
            # reuse path constrains the family at socket creation).
            # AI_ADDRCONFIG drops families this host has no address for,
            # and every returned address is tried in order — all under
            # ONE deadline, so this path's budget matches the plain one.
            loop = asyncio.get_running_loop()
            deadline = loop.time() + timeout
            infos = await asyncio.wait_for(
                loop.getaddrinfo(
                    host, port, type=socket.SOCK_STREAM,
                    flags=getattr(socket, "AI_ADDRCONFIG", 0)),
                timeout)
            last_err: Exception | None = None
            reader = writer = None
            for family, _t, _p, _cn, sockaddr in infos:
                if family not in (socket.AF_INET, socket.AF_INET6):
                    continue
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                sock = _reuse_socket(
                    local_port, "::" if family == socket.AF_INET6 else "")
                try:
                    await asyncio.wait_for(
                        loop.sock_connect(sock, sockaddr[:2]), remaining)
                    reader, writer = await asyncio.open_connection(sock=sock)
                    break
                except asyncio.CancelledError:
                    sock.close()
                    raise
                except Exception as e:
                    last_err = e
                    sock.close()
            if writer is None:
                if protocol != RELAY_PROTOCOL:
                    self._ladder_inc("direct", "fail")
                raise last_err or asyncio.TimeoutError(
                    f"dial to {host}:{port} timed out")
        else:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), timeout
                )
            except Exception:
                # Ladder accounting: end-to-end peer dials only — the
                # outer TCP hop to a relay is part of the splice rung.
                if protocol != RELAY_PROTOCOL:
                    self._ladder_inc("direct", "fail")
                raise
        try:
            stream = await self._client_handshake(
                reader, writer, protocol, expect_id, timeout,
                contact=lambda rid: Contact(rid, host, port))
        except Exception:
            writer.close()
            if protocol != RELAY_PROTOCOL:
                self._ladder_inc("direct", "fail")
            raise
        if protocol != RELAY_PROTOCOL:
            self._ladder_inc("direct", "ok")
        return stream

    async def _client_handshake(self, reader, writer, protocol: str,
                                expect_id: str | None, timeout: float,
                                contact) -> Stream:
        """Client side of the signed-hello + AEAD handshake over an open
        byte pipe (a raw TCP connection, or a relay-spliced stream —
        ``contact`` maps the authenticated remote id to the Contact stored
        in the peerstore)."""
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
        lport = self._hello_port
        sig = self.key.sign(
            _hello_signing_bytes(protocol, self.peer_id, ts, server_nonce,
                                 lport, eph_hex)
        )
        await write_json_frame(
            writer,
            {
                "proto": protocol,
                "peer_id": self.peer_id,
                "pubkey": self._pubkey_hex(),
                "ts": ts,
                "sig": sig.hex(),
                "listen_port": lport,
                "eph": eph_hex,
            },
        )
        ack = await read_json_frame(reader, timeout)
        if not ack.get("ok"):
            raise HandshakeError(
                f"remote rejected stream: {ack.get('error', 'unknown')}")
        remote_id, remote_eph = _verify_hello(ack, protocol, my_nonce)
        if expect_id is not None and remote_id != expect_id:
            raise HandshakeError(
                f"peer identity mismatch: expected {expect_id[:8]} "
                f"got {remote_id[:8]}"
            )
        # Encrypt everything after the handshake (we are the client).
        c2s, s2c = derive_keys(
            ecdh(eph, remote_eph), protocol, self.peer_id, remote_id,
            my_nonce, server_nonce)
        remote_contact = contact(remote_id)
        if remote_contact is not None:
            self.peerstore[remote_id] = remote_contact
        self.stats["streams_out"] += 1
        self.stats["handshake_ns"] += time.perf_counter_ns() - t_hs
        return Stream(
            protocol=protocol,
            remote_peer_id=remote_id,
            remote_contact=remote_contact,
            reader=SecureReader(reader, s2c),
            writer=SecureWriter(writer, c2s),
        )

    async def _new_stream_via_relay(self, target: Contact, protocol: str,
                                    timeout: float,
                                    trace_id: str = "") -> Stream:
        """Open ``protocol`` to a NATed peer through its relay: dial the
        relay, ask it to splice us to ``target.peer_id``, then run the
        normal end-to-end handshake through the splice — the relay carries
        only the inner ciphertext.

        When OUR OWN listen port is dialback-confirmed public
        (``reverse_dialable``), try connection reversal first: the relay
        only signals the NATed peer to dial us back, and the data path
        goes direct instead of hairpinning every byte through the relay
        (a direct-connection upgrade).  When reversal
        does not apply (BOTH sides NATed), try a relay-coordinated TCP
        simultaneous open (hole punch): each side redials the other's
        relay-observed endpoint FROM the local port whose NAT mapping the
        relay observed — cone-NAT pairs get a direct data path the splice
        would otherwise hairpin forever.  Any failure falls back to the
        splice."""
        failed_at = self._reverse_failed_at.get(target.peer_id, 0.0)
        if (self.reverse_dialable and self.listen_port
                and time.monotonic() - failed_at > REVERSE_FAIL_COOLDOWN
                and not os.environ.get("CROWDLLAMA_TPU_NO_REVERSE")):
            try:
                stream = await self._new_stream_reversed(target, protocol,
                                                         timeout)
                self._reverse_failed_at.pop(target.peer_id, None)
                self._ladder_inc("reverse", "ok")
                return stream
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._ladder_inc("reverse", "fail")
                self._reverse_failed_at[target.peer_id] = time.monotonic()
                log.debug("reverse connect to %s failed (%s); falling "
                          "back to relay splice for %ds",
                          target.peer_id[:8], e, int(REVERSE_FAIL_COOLDOWN))
        punch_failed_at = self._punch_failed_at.get(target.peer_id, 0.0)
        if (time.monotonic() - punch_failed_at > PUNCH_FAIL_COOLDOWN
                and not os.environ.get("CROWDLLAMA_TPU_NO_PUNCH")):
            try:
                # Bounded: a never-landing punch (symmetric NAT) costs at
                # most PUNCH_TOTAL_BUDGET before the splice fallback, and
                # the per-peer cooldown amortizes it to once a minute.
                stream = await asyncio.wait_for(
                    self._new_stream_punched(target, protocol, timeout),
                    min(PUNCH_TOTAL_BUDGET, timeout / 2))
                self._punch_failed_at.pop(target.peer_id, None)
                self._ladder_inc("punch", "ok")
                return stream
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._ladder_inc("punch", "fail")
                self._punch_failed_at[target.peer_id] = time.monotonic()
                log.debug("hole punch to %s failed (%s); falling back to "
                          "relay splice for %ds",
                          target.peer_id[:8], e, int(PUNCH_FAIL_COOLDOWN))
        try:
            outer = await self.new_stream(f"{target.host}:{target.port}",
                                          RELAY_PROTOCOL, timeout)
        except Exception:
            self._ladder_inc("splice", "fail")
            raise
        try:
            connect = {"op": "connect", "target": target.peer_id}
            if trace_id:
                connect["trace_id"] = trace_id
            await write_json_frame(outer.writer, connect)
            reply = await read_json_frame(outer.reader, timeout)
            if not reply.get("ok"):
                raise HandshakeError(
                    f"relay refused: {reply.get('error', 'unknown')}")
            stream = await self._client_handshake(
                outer.reader, outer.writer, protocol, target.peer_id,
                timeout, contact=lambda rid: target)
            self.stats["streams_relayed_out"] = (
                self.stats.get("streams_relayed_out", 0) + 1)
            self._ladder_inc("splice", "ok")
            return stream
        except Exception:
            self._ladder_inc("splice", "fail")
            outer.close()
            raise

    async def _new_stream_punched(self, target: Contact, protocol: str,
                                  timeout: float) -> Stream:
        """Hole punch: ask the relay for the target's observed endpoint
        (and to signal the target ours), then run a coordinated TCP
        simultaneous open — both sides connect() to each other FROM the
        local ports whose NAT mappings the relay observed, so cone NATs
        route the SYNs without any listener.  We stay the protocol
        client; the target serves the pipe (relay.py RelayClient._punch).
        """
        # Bind the punch listener FIRST (port 0: kernel-assigned,
        # conflict-free by construction), then dial the relay FROM that
        # same port — the relay observes the NAT mapping of the very
        # port we are listening on.
        lsock = _reuse_socket(0, target.host)
        lport = lsock.getsockname()[1]
        try:
            outer = await self.new_stream(f"{target.host}:{target.port}",
                                          RELAY_PROTOCOL, timeout,
                                          reuse_sock=True, local_port=lport)
        except BaseException:
            lsock.close()
            raise
        consumed = False  # punch_establish owns lsock once called
        try:
            # No nonce: the punched connection is authenticated solely by
            # the signed-hello handshake's expect_id (unlike reversal,
            # nothing here needs correlating to a waiter).
            await write_json_frame(outer.writer, {
                "op": "punch", "target": target.peer_id})
            reply = await read_json_frame(outer.reader, timeout)
            if not reply.get("ok"):
                raise HandshakeError(
                    f"relay refused punch: {reply.get('error', 'unknown')}")
            r_host, _, r_port = str(reply.get("addr", "")).rpartition(":")
            if not r_host or not r_port.isdigit():
                raise HandshakeError(f"bad punch endpoint {reply!r}")
            # The outer stream stays open through the punch (its liveness
            # is what keeps aggressive NATs from expiring the mapping).
            # We are the protocol CLIENT: take the first established
            # connection; crossed extras are closed (the target serves
            # every one it sees, so an orphan just idles out there).
            first: asyncio.Future = asyncio.get_running_loop(
            ).create_future()

            def on_est(reader, writer):
                if first.done():
                    writer.close()
                else:
                    first.set_result((reader, writer))

            consumed = True
            await punch_establish(lport, r_host, int(r_port), on_est,
                                  listen_sock=lsock)
            reader, writer = await first
        finally:
            if not consumed:
                lsock.close()
            outer.close()
        try:
            stream = await self._client_handshake(
                reader, writer, protocol, target.peer_id, timeout,
                contact=lambda rid: target)
        except Exception:
            writer.close()
            raise
        self.stats["streams_punched_out"] = (
            self.stats.get("streams_punched_out", 0) + 1)
        return stream

    async def _new_stream_reversed(self, target: Contact, protocol: str,
                                   timeout: float) -> Stream:
        """Connection reversal: ask the relay to have ``target`` dial OUR
        listener directly, then run the normal client handshake over the
        reversed TCP connection (we stay the protocol client even though
        the TCP roles are swapped)."""
        nonce = os.urandom(16).hex()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._reverse_waiters[nonce] = fut
        try:
            outer = await self.new_stream(f"{target.host}:{target.port}",
                                          RELAY_PROTOCOL, timeout)
            try:
                await write_json_frame(outer.writer, {
                    "op": "connect_reverse", "target": target.peer_id,
                    "port": self.listen_port, "nonce": nonce})
                reply = await read_json_frame(outer.reader, timeout)
                if not reply.get("ok"):
                    raise HandshakeError(
                        f"relay refused reversal: {reply.get('error')}")
            finally:
                outer.close()
            # Cap the wait below the stream timeout: a failed reversal
            # must leave room for the splice fallback even when the
            # caller passed a short timeout.
            reader, writer = await asyncio.wait_for(
                fut, min(REVERSE_WAIT, timeout / 2))
        finally:
            self._reverse_waiters.pop(nonce, None)
        try:
            stream = await self._client_handshake(
                reader, writer, protocol, target.peer_id, timeout,
                contact=lambda rid: target)
        except Exception:
            writer.close()
            raise
        self.stats["streams_reversed_out"] = (
            self.stats.get("streams_reversed_out", 0) + 1)
        return stream

    # -- inbound -----------------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        peername = writer.get_extra_info("peername")
        await self._serve_pipe(reader, writer, peername)

    async def _serve_inbound(self, reader, writer, stat_key: str,
                             peername) -> None:
        """Shared bookkeeping for every non-accepted inbound pipe
        (reversed / punched / relay-spliced): task tracking, the
        path-specific stat, then the standard server-side handshake +
        handler dispatch."""
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        self.stats[stat_key] = self.stats.get(stat_key, 0) + 1
        await self._serve_pipe(reader, writer, peername)

    async def serve_reversed(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        """Serve one OUTBOUND TCP connection we opened as a connection
        reversal (net/relay.py RelayClient): after the REVERSE marker
        frame, the remote requester runs the client handshake, so this
        side serves the pipe exactly like an accepted connection."""
        await self._serve_inbound(reader, writer, "streams_reversed_in",
                                  writer.get_extra_info("peername"))

    async def serve_punched(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """Serve one hole-punched connection (we are the punch TARGET):
        the requester runs the client handshake over the punched pipe, so
        this side serves it exactly like an accepted connection."""
        await self._serve_inbound(reader, writer, "streams_punched_in",
                                  writer.get_extra_info("peername"))

    async def serve_relayed(self, outer: Stream) -> None:
        """Serve one inbound stream arriving through a relay splice: run
        the server-side handshake and handler over the already-open pipe
        (the worker side of net/relay.py reverse connections)."""
        await self._serve_inbound(outer.reader, outer.writer,
                                  "streams_relayed_in", None)

    async def _serve_pipe(self, reader, writer, peername) -> None:
        """Server side of the handshake + handler dispatch over any byte
        pipe (direct TCP or relay splice — ``peername`` None for relayed
        pipes: the observed address would be the relay's, not the peer's)."""
        handshaked = False
        handoff = False
        try:
            # Nonce exchange first (see new_stream).
            opening = await read_json_frame(reader, HANDSHAKE_TIMEOUT)
            proto = str(opening.get("proto", ""))
            client_nonce = str(opening.get("nonce", ""))
            if proto == REVERSE_PROTOCOL:
                # A reversed TCP connection we asked for: hand the raw
                # pipe to the waiting dial, which runs the CLIENT
                # handshake over it (_new_stream_reversed).  The nonce
                # traveled to the dialing peer over the encrypted relay
                # control stream, so it cannot be known to bystanders —
                # and a forged claim would still fail the signed-hello
                # identity check that follows.
                fut = self._reverse_waiters.pop(client_nonce, None)
                if fut is not None and not fut.done():
                    handoff = True
                    fut.set_result((reader, writer))
                    return  # ownership transferred: do NOT close
                self.stats["rejected"] += 1
                await write_json_frame(
                    writer, {"error": "unknown reversal nonce"})
                writer.close()
                return
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

            # Learn a dialable contact for the remote: observed source host +
            # its advertised listening port.
            remote_contact: Contact | None = None
            if peername:
                seen = self._peers_by_addr_class.setdefault(
                    _addr_class(peername[0]), set())
                if len(seen) < 50_000:
                    # Bounded: a dialer minting a fresh key per connection
                    # must not grow this without limit (the bootstrap
                    # server runs for weeks).
                    seen.add(remote_id)
            lport = int(hello.get("listen_port", 0))
            if peername and lport > 0:
                remote_contact = Contact(remote_id, peername[0], lport)
                self.peerstore[remote_id] = remote_contact

            eph = X25519PrivateKey.generate()
            eph_hex = eph.public_key().public_bytes_raw().hex()
            ts = time.time()
            my_lport = self._hello_port
            sig = self.key.sign(
                _hello_signing_bytes(proto, self.peer_id, ts, client_nonce,
                                     my_lport, eph_hex)
            )
            await write_json_frame(
                writer,
                {
                    "ok": True,
                    "proto": proto,
                    "peer_id": self.peer_id,
                    "pubkey": self._pubkey_hex(),
                    "ts": ts,
                    "sig": sig.hex(),
                    "listen_port": my_lport,
                    "eph": eph_hex,
                },
            )
            # Encrypt everything after the handshake (we are the server).
            c2s, s2c = derive_keys(
                ecdh(eph, remote_eph), proto, remote_id, self.peer_id,
                client_nonce, my_nonce)
            stream = Stream(
                protocol=proto,
                remote_peer_id=remote_id,
                remote_contact=remote_contact,
                reader=SecureReader(reader, c2s),
                writer=SecureWriter(writer, s2c),
                observed_ip=peername[0] if peername else "",
                observed_port=peername[1] if peername else 0,
            )
            self.stats["streams_in"] += 1
            self.stats_by_protocol[proto] = (
                self.stats_by_protocol.get(proto, 0) + 1)
            handshaked = True
            await handler(stream)
        except (HandshakeError, json.JSONDecodeError,
                asyncio.TimeoutError) as e:
            # Only handshake-phase failures are "rejections"; a stream that
            # authenticated and then errored in its handler was accepted.
            if not handshaked:
                self.stats["rejected"] += 1
            log.debug("inbound stream rejected: %s", e)
        except asyncio.CancelledError:  # host shutting down
            raise
        except Exception:
            log.exception("stream handler error")
        finally:
            if not handoff:
                try:
                    writer.close()
                except Exception:
                    pass

    def _pubkey_hex(self) -> str:
        return self.public_key.public_bytes_raw().hex()


def _verify_hello(hello: dict, proto: str,
                  expected_nonce: str) -> tuple[str, bytes]:
    """Verify a signed hello/ack against our challenge; returns
    (peer ID, ephemeral X25519 public key bytes).  A hello without an
    identity-bound ephemeral key is rejected: there is no plaintext mode."""
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
        pub.verify(
            sig, _hello_signing_bytes(proto, peer_id, ts, expected_nonce,
                                      listen_port, eph_hex)
        )
    except (InvalidSignature, ValueError) as e:
        raise HandshakeError("hello signature verification failed") from e
    if peer_id_from_public_key(pub) != peer_id:
        raise HandshakeError("peer id does not match public key")
    return peer_id, eph_raw
