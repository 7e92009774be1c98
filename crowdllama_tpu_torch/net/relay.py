"""NAT traversal: reverse streams through a public relay node.

Counterpart of ``crowdllama_tpu/net/relay.py``, with the same wire
frames, so port and JAX nodes relay for each other.  A TURN-style relay,
hosted by the bootstrap node (``cli/dht.py``) and by every directly
reachable worker:

- A NATed worker keeps ONE persistent outbound control stream to the
  relay (``register``), heartbeated.  Its advertised Contact carries the
  relay's address with ``relay=True`` (``Host.contact``), and its hellos
  advertise listen_port 0 so no peerstore learns a bogus direct address.
- A dialer that resolves a ``relay=True`` contact connects to the relay
  (``connect``), the relay notifies the worker over the control stream,
  the worker opens a fresh outbound ``accept`` connection, and the relay
  splices the two byte streams.
- The signed hello and AEAD handshake then run END TO END through the
  splice (``Host._client_handshake`` / ``Host.serve_relayed``): the relay
  authenticates who relays but forwards only ciphertext.

``dialback`` probes reachability: the relay tries a plain TCP connect to
the caller's observed IP and advertised port; a worker in
``relay_mode="auto"`` relays only when it fails.

Connection reversal (``connect_reverse``, ``RelayClient._reverse``): when
the DIALING side's own listen port is dial-back confirmed, the relay
forwards one signal and the NATed worker dials the requester back
directly, so the data path skips the relay.  When both sides are NATed,
``punch`` (``RelayClient._punch``, ``host.punch_establish``) hands each
side the other's socket-observed endpoint (the live NAT mapping of the
socket involved) and both connect to each other FROM those same local
ports until one connection lands.  Endpoint-independent-mapping NAT
pairs get a direct path; symmetric NATs fall back to the splice.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from crowdllama_tpu_torch.core.protocol import RELAY_PROTOCOL, REVERSE_PROTOCOL
from crowdllama_tpu_torch.testing import faults
from crowdllama_tpu_torch.net.host import (
    Host,
    Stream,
    punch_establish,
    read_json_frame,
    write_json_frame,
)

log = logging.getLogger("crowdllama.torch.net.relay")

ACCEPT_TIMEOUT = 15.0      # connect waits this long for the worker's accept
DIALBACK_TIMEOUT = 3.0     # TCP connect budget for reachability probes
PING_INTERVAL = 15.0       # worker control-stream heartbeat
CONTROL_IDLE = 3 * PING_INTERVAL
SPLICE_CHUNK = 64 * 1024
MAX_REGISTRATIONS = 10_000
MAX_SPLICES_PER_PEER = 64
# Worker-side cap on concurrent reverse-dial tasks: each is an outbound
# TCP connect to a requester-chosen address, so without a bound a
# flooding requester (or malicious relay) could drive unbounded dial
# work from the NATed worker — the reversal analog of the splice cap.
MAX_REVERSE_DIALS = 32


class _Registration:
    def __init__(self, stream: Stream):
        self.stream = stream
        self.lock = asyncio.Lock()  # serializes relay->worker frames
        self.splices = 0


class RelayService:
    """Relay server: registered on the bootstrap/DHT node's host."""

    def __init__(self, host: Host):
        self.host = host
        self._workers: dict[str, _Registration] = {}
        # conn_id -> future resolved with (worker Stream, done Event)
        self._pending: dict[str, asyncio.Future] = {}
        self._closed = False
        # NodeObs of the hosting Peer (attached by Peer._start_relay_service).
        # When a connect frame carries a trace_id, the splice records a
        # relay_splice span here so the trace collector can stitch the relay
        # hop into the cross-node tree — the spliced bytes themselves are
        # sealed end-to-end and carry nothing the relay can read.
        self.obs = None
        host.set_stream_handler(RELAY_PROTOCOL, self.handle)

    def close(self) -> None:
        """Stop relaying: refuse new ops and drop every registration (their
        control streams close, so workers fail over to another relay)."""
        self._closed = True
        for reg in list(self._workers.values()):
            reg.stream.close()
        self._workers.clear()

    @property
    def registered_count(self) -> int:
        return len(self._workers)

    async def handle(self, stream: Stream) -> None:
        try:
            req = await read_json_frame(stream.reader, ACCEPT_TIMEOUT)
        except Exception:
            stream.close()
            return
        op = str(req.get("op", ""))
        try:
            await faults.inject("relay.op", op=op)
            if self._closed:
                await write_json_frame(stream.writer,
                                       {"ok": False, "error": "relay closed"})
            elif op == "register":
                await self._handle_register(stream)
            elif op == "connect":
                await self._handle_connect(stream, str(req.get("target", "")),
                                           str(req.get("trace_id", "")))
            elif op == "connect_reverse":
                await self._handle_connect_reverse(
                    stream, str(req.get("target", "")),
                    int(req.get("port", 0)), str(req.get("nonce", "")))
            elif op == "punch":
                await self._handle_punch(stream, str(req.get("target", "")))
            elif op == "accept":
                await self._handle_accept(stream, str(req.get("conn_id", "")))
            elif op == "dialback":
                await self._handle_dialback(stream, int(req.get("port", 0)))
            else:
                await write_json_frame(stream.writer,
                                       {"ok": False,
                                        "error": f"unknown op {op!r}"})
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.debug("relay %s failed: %s", op, e)
        finally:
            stream.close()

    # ------------------------------------------------------------- register

    async def _handle_register(self, stream: Stream) -> None:
        peer = stream.remote_peer_id
        if len(self._workers) >= MAX_REGISTRATIONS:
            await write_json_frame(stream.writer,
                                   {"ok": False, "error": "relay full"})
            return
        reg = _Registration(stream)
        old = self._workers.get(peer)
        self._workers[peer] = reg
        if old is not None:
            old.stream.close()  # newest registration wins (worker restarted)
        await write_json_frame(stream.writer, {"ok": True})
        log.info("relay: registered %s (%d total)", peer[:8],
                 len(self._workers))
        try:
            while True:
                frame = await read_json_frame(stream.reader, CONTROL_IDLE)
                if frame.get("op") == "ping":
                    async with reg.lock:
                        await write_json_frame(stream.writer, {"op": "pong"})
        except Exception:
            pass
        finally:
            if self._workers.get(peer) is reg:
                del self._workers[peer]
                log.info("relay: deregistered %s", peer[:8])

    # -------------------------------------------------------------- connect

    async def _handle_connect(self, stream: Stream, target: str,
                              trace_id: str = "") -> None:
        if trace_id and self.obs is not None:
            # The spliced bytes are sealed end-to-end, so this control-frame
            # id is the relay's only chance to join the stitched trace.
            self.obs.trace.begin(trace_id)
        t0 = time.monotonic_ns()
        reg = self._workers.get(target)
        if reg is None:
            await write_json_frame(
                stream.writer,
                {"ok": False, "error": f"peer {target[:8]} not relayed here"})
            return
        if reg.splices >= MAX_SPLICES_PER_PEER:
            await write_json_frame(
                stream.writer, {"ok": False, "error": "relay splice cap"})
            return
        conn_id = os.urandom(8).hex()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[conn_id] = fut
        try:
            async with reg.lock:
                await write_json_frame(reg.stream.writer,
                                       {"op": "incoming", "conn_id": conn_id})
            worker_stream, done = await asyncio.wait_for(fut, ACCEPT_TIMEOUT)
        except (asyncio.TimeoutError, Exception) as e:
            self._pending.pop(conn_id, None)
            try:
                await write_json_frame(
                    stream.writer,
                    {"ok": False, "error": f"worker accept failed: {e}"})
            except Exception:
                pass
            return
        await write_json_frame(stream.writer, {"ok": True})
        reg.splices += 1
        if trace_id and self.obs is not None:
            # Recorded at establishment, not teardown: a pooled stream keeps
            # the splice alive across many requests, and the trace must be
            # fetchable while its request is still the one on the wire.  The
            # span covers the relay's setup work (worker accept round-trip).
            dur = time.monotonic_ns() - t0
            self.obs.trace.record(
                trace_id, "relay_splice", dur,
                **{"from": stream.remote_peer_id[:8], "to": target[:8]})
            self.obs.trace.finish(trace_id, dur)
        try:
            await _splice(stream, worker_stream)
        finally:
            reg.splices -= 1
            done.set()

    async def _handle_connect_reverse(self, stream: Stream, target: str,
                                      port: int, nonce: str) -> None:
        """Connection reversal signaling: tell the
        relayed ``target`` to dial the requester back directly at the
        requester's socket-observed IP + advertised listen port.  The
        relay carries ONE control frame — the data path never touches it.
        The requester falls back to a normal ``connect`` splice if the
        reverse dial doesn't arrive."""
        reg = self._workers.get(target)
        if reg is None:
            await write_json_frame(
                stream.writer,
                {"ok": False, "error": f"peer {target[:8]} not relayed here"})
            return
        ip = stream.observed_ip
        if not ip and stream.remote_contact is not None:
            ip = stream.remote_contact.host
        if not ip or not (0 < port < 65536) or not nonce:
            await write_json_frame(
                stream.writer,
                {"ok": False, "error": "no dialable requester address"})
            return
        async with reg.lock:
            await write_json_frame(reg.stream.writer, {
                "op": "reverse", "addr": f"{ip}:{port}", "nonce": nonce})
        await write_json_frame(stream.writer, {"ok": True})

    async def _handle_punch(self, stream: Stream, target: str) -> None:
        """Hole-punch coordination (TCP simultaneous open) for the
        both-sides-NATed case reversal cannot cover: hand each side the
        OTHER's socket-observed endpoint.  Those observed endpoints ARE
        the live NAT mappings of the sockets involved (requester: this
        stream; target: its control stream), so each side redialing FROM
        the same local port reuses its mapping on cone NATs.  The relay
        carries two signaling frames — the punched data path never
        touches it."""
        reg = self._workers.get(target)
        if reg is None:
            await write_json_frame(
                stream.writer,
                {"ok": False, "error": f"peer {target[:8]} not relayed here"})
            return
        t_ip, t_port = reg.stream.observed_ip, reg.stream.observed_port
        r_ip, r_port = stream.observed_ip, stream.observed_port
        if not (t_ip and t_port and r_ip and r_port):
            await write_json_frame(
                stream.writer,
                {"ok": False, "error": "observed endpoints unavailable"})
            return
        async with reg.lock:
            await write_json_frame(reg.stream.writer, {
                "op": "punch", "addr": f"{r_ip}:{r_port}"})
        await write_json_frame(stream.writer,
                               {"ok": True, "addr": f"{t_ip}:{t_port}"})
        # Park until the requester closes: its NAT mapping for THIS
        # socket is what the target is dialing — dropping our end early
        # could expire it on aggressive NATs mid-punch.
        try:
            await read_json_frame(stream.reader, ACCEPT_TIMEOUT)
        except Exception:
            pass

    async def _handle_accept(self, stream: Stream, conn_id: str) -> None:
        fut = self._pending.pop(conn_id, None)
        if fut is None or fut.done():
            await write_json_frame(
                stream.writer,
                {"ok": False, "error": f"unknown conn {conn_id!r}"})
            return
        done = asyncio.Event()
        fut.set_result((stream, done))
        # Park until the connect side finishes splicing — returning would
        # close this stream (handle()'s finally) mid-splice.
        await done.wait()

    # ------------------------------------------------------------- dialback

    async def _handle_dialback(self, stream: Stream, port: int) -> None:
        """Reachability probe: can WE dial the caller back directly?

        Uses the socket-observed source IP (NOT the hello contact): a
        relaying worker's hello is deliberately non-dialable, and the
        whole point of the auto-mode re-probe is to notice that such a
        worker's port has become reachable."""
        ip = stream.observed_ip
        if not ip and stream.remote_contact is not None:
            ip = stream.remote_contact.host
        reachable = False
        if ip and 0 < port < 65536:
            try:
                _r, w = await asyncio.wait_for(
                    asyncio.open_connection(ip, port), DIALBACK_TIMEOUT)
                w.close()
                reachable = True
            except Exception:
                reachable = False
        await write_json_frame(stream.writer, {
            "ok": True, "reachable": reachable, "observed_ip": ip})


async def _splice(a: Stream, b: Stream) -> None:
    """Bidirectional byte copy until either side closes."""
    try:
        await faults.inject("relay.splice")
    except faults.FaultError:
        # Injected relay death: both legs drop, exactly like the relay
        # process dying mid-splice.
        a.close()
        b.close()
        return

    async def one(src: Stream, dst: Stream) -> None:
        try:
            while True:
                chunk = await src.reader.read(SPLICE_CHUNK)
                if not chunk:
                    break
                dst.writer.write(chunk)
                await dst.writer.drain()
        except Exception:
            pass
        finally:
            dst.close()
            src.close()

    await asyncio.gather(one(a, b), one(b, a))


class RelayClient:
    """Worker-side relay registration: keeps the control stream alive and
    answers ``incoming`` notifications with reverse connections.

    ``candidates`` (a nullary callable returning relay addresses, e.g. the
    peer's view of relay_capable swarm members) enables failover: after two
    consecutive failed registration cycles on the current relay the client
    rotates to the next candidate.
    ``on_relay_change(addr)`` fires after every successful registration so
    the owner can re-advertise the (possibly new) relay contact."""

    def __init__(self, host: Host, relay_addr: str,
                 ping_interval: float = PING_INTERVAL,
                 candidates=None, on_relay_change=None):
        self.host = host
        self.relay_addr = relay_addr
        self.ping_interval = ping_interval
        self.candidates = candidates
        self.on_relay_change = on_relay_change
        self._task: asyncio.Task | None = None
        self._accepts: set[asyncio.Task] = set()
        self._reverse_dials = 0  # in-flight reverse dials (MAX_REVERSE_DIALS)
        self.registered = asyncio.Event()

    def _reverse_done(self, _task: asyncio.Task) -> None:
        self._reverse_dials -= 1

    def _next_candidate(self) -> str:
        """Next failover relay, rotating past the current one."""
        if self.candidates is None:
            return ""
        try:
            cands = [a for a in self.candidates() if a]
        except Exception as e:
            log.debug("relay candidate lookup failed: %s", e)
            return ""
        if self.relay_addr in cands:
            i = cands.index(self.relay_addr)
            cands = cands[i + 1:] + cands[:i]
        return cands[0] if cands else ""

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="relay-client")
        # Surface immediate registration failures (bad relay address) at
        # start; later drops are handled by the reconnect loop.
        await asyncio.wait_for(self.registered.wait(), ACCEPT_TIMEOUT)

    async def stop(self) -> None:
        tasks = [t for t in [self._task, *self._accepts] if t is not None]
        for t in tasks:
            # Re-cancel until the task actually ends: a cancel that races
            # the control stream dying is swallowed inside wait_for
            # (bpo-42130, present on 3.10) and surfaces as a stream error
            # the reconnect loop happily retries — one cancel() is not
            # enough to stop it.
            while not t.done():
                t.cancel()
                await asyncio.wait([t], timeout=0.5)
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._task = None
        self._accepts.clear()

    async def _run(self) -> None:
        backoff = 1.0
        fails = 0
        fast_rotations = 0  # immediate failovers since the last success
        while True:
            control: Stream | None = None
            try:
                # reuse_sock: the control stream's local port is what punch
                # dials rebind (host.new_stream docstring).
                control = await self.host.new_stream(self.relay_addr,
                                                     RELAY_PROTOCOL,
                                                     reuse_sock=True)
                await write_json_frame(control.writer, {"op": "register"})
                reply = await read_json_frame(control.reader, ACCEPT_TIMEOUT)
                if not reply.get("ok"):
                    raise RuntimeError(
                        f"relay refused registration: {reply.get('error')}")
                self.registered.set()
                backoff = 1.0
                fails = 0
                fast_rotations = 0
                if self.on_relay_change is not None:
                    try:
                        self.on_relay_change(self.relay_addr)
                    except Exception:
                        log.exception("on_relay_change failed")
                ping = asyncio.create_task(self._ping_loop(control))
                try:
                    while True:
                        frame = await read_json_frame(control.reader,
                                                      CONTROL_IDLE)
                        if frame.get("op") == "incoming":
                            t = asyncio.create_task(
                                self._accept(str(frame["conn_id"])))
                            self._accepts.add(t)
                            t.add_done_callback(self._accepts.discard)
                        elif frame.get("op") == "reverse":
                            if self._reverse_dials >= MAX_REVERSE_DIALS:
                                log.warning("reverse dial cap reached; "
                                            "dropping request")
                                continue
                            self._reverse_dials += 1
                            t = asyncio.create_task(
                                self._reverse(str(frame.get("addr", "")),
                                              str(frame.get("nonce", ""))))
                            self._accepts.add(t)
                            t.add_done_callback(self._accepts.discard)
                            t.add_done_callback(self._reverse_done)
                        elif frame.get("op") == "punch":
                            # Bounded like reverse dials: each punch is
                            # outbound connect work to a relay-supplied
                            # address.
                            if self._reverse_dials >= MAX_REVERSE_DIALS:
                                log.warning("punch cap reached; dropping")
                                continue
                            self._reverse_dials += 1
                            t = asyncio.create_task(
                                self._punch(str(frame.get("addr", "")),
                                            control))
                            self._accepts.add(t)
                            t.add_done_callback(self._accepts.discard)
                            t.add_done_callback(self._reverse_done)
                finally:
                    ping.cancel()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.registered.clear()
                fails += 1
                nxt = self._next_candidate() if fails >= 2 else ""
                if nxt and nxt != self.relay_addr:
                    log.warning("relay %s unreachable (%s); failing over "
                                "to %s", self.relay_addr, e, nxt)
                    self.relay_addr = nxt
                    fails = 0
                    # One immediate try per candidate; once the whole pool
                    # has failed since the last success, keep rotating but
                    # under the normal exponential backoff — a swarm-wide
                    # outage must not turn into a 1 Hz retry storm.
                    fast_rotations += 1
                    if fast_rotations <= 4:
                        backoff = 1.0
                        continue
                log.warning("relay control stream lost (%s); retrying in "
                            "%.0fs", e, backoff)
            finally:
                if control is not None:
                    control.close()
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 30.0)

    async def _ping_loop(self, control: Stream) -> None:
        while True:
            await asyncio.sleep(self.ping_interval)
            await write_json_frame(control.writer, {"op": "ping"})

    async def _accept(self, conn_id: str) -> None:
        try:
            outer = await self.host.new_stream(self.relay_addr,
                                               RELAY_PROTOCOL)
        except Exception as e:
            log.warning("relay accept dial failed: %s", e)
            return
        try:
            await write_json_frame(outer.writer,
                                   {"op": "accept", "conn_id": conn_id})
            # The spliced client's opening frame follows; serve it like any
            # inbound connection (end-to-end handshake + handler dispatch).
            await self.host.serve_relayed(outer)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.debug("relayed stream failed: %s", e)
        finally:
            outer.close()


    async def _reverse(self, addr: str, nonce: str) -> None:
        """Dial a PUBLIC requester back directly (connection reversal):
        outbound TCP works from behind the NAT, so after the plaintext
        REVERSE marker frame this side simply serves the connection — the
        requester runs the client handshake over it and the relay never
        sees the data."""
        rhost, _, port_s = addr.rpartition(":")
        if not rhost or not nonce:
            return
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(rhost, int(port_s)),
                DIALBACK_TIMEOUT)
        except Exception as e:
            log.debug("reverse dial to %s failed: %s", addr, e)
            return
        try:
            await write_json_frame(writer,
                                   {"proto": REVERSE_PROTOCOL,
                                    "nonce": nonce})
            await self.host.serve_reversed(reader, writer)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.debug("reversed stream failed: %s", e)
            try:
                writer.close()
            except Exception:
                pass


    async def _punch(self, addr: str, control: Stream) -> None:
        """Our half of a coordinated hole punch: listen+connect FROM the
        control stream's local port (the NAT mapping the relay told the
        requester about) toward the requester's observed endpoint.  The
        requester runs the client handshake on the connection of ITS
        choice, so this side SERVES every connection that establishes —
        a crossed orphan never receives an opening frame and idles out."""
        rhost, _, port_s = addr.rpartition(":")
        sockname = control.writer.get_extra_info("sockname")
        if not rhost or not port_s.isdigit() or not sockname:
            log.debug("punch signal with unusable addr %r", addr)
            return

        def on_est(reader, writer):
            t = asyncio.create_task(self.host.serve_punched(reader, writer))
            self._accepts.add(t)
            t.add_done_callback(self._accepts.discard)

        try:
            await punch_establish(int(sockname[1]), rhost, int(port_s),
                                  on_est)
        except Exception as e:
            log.debug("punch dial to %s failed: %s", addr, e)


async def dialback_probe(host: Host, relay_addr: str) -> bool:
    """Ask the relay whether this host's listen port is reachable from it.

    The probe stream advertises our real listen_port (hellos must stay
    dialable during the probe even if we later decide to relay).

    Raises when the remote REFUSES the probe (closed relay, no relay
    support) — callers must be able to tell "the relay says my port is
    unreachable" from "this relay can't answer", or a reachable auto-mode
    worker behind a dead relay would flap into needless relaying."""
    stream = await host.new_stream(relay_addr, RELAY_PROTOCOL)
    try:
        await write_json_frame(stream.writer,
                               {"op": "dialback", "port": host.listen_port})
        reply = await read_json_frame(stream.reader,
                                      DIALBACK_TIMEOUT + ACCEPT_TIMEOUT)
        if not reply.get("ok"):
            raise RuntimeError(
                f"dialback refused: {reply.get('error', 'not ok')}")
        return bool(reply.get("reachable"))
    finally:
        stream.close()
