"""Kademlia-style DHT with provider records.

Counterpart of ``crowdllama_tpu/net/dht.py``: an XOR-metric k-bucket
routing table (native, ``NativeRoutingTable``, when the library is
loaded; ``PyRoutingTable`` otherwise, with the same semantics), iterative lookups (alpha=3, k=20) and TTL'd provider records, with
RPCs as JSON frames on the KAD protocol over pooled ``net/host.py``
streams.  The RPCs (ping, find_node, get_providers, add_provider,
find_peer, metadata) are the JAX node's, so port and JAX nodes share one
DHT.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import random
import time
from dataclasses import dataclass, field

from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.net.host import (
    STREAM_POOL_IDLE_S,
    Contact,
    Host,
    Stream,
    StreamPool,
    read_json_frame,
    write_json_frame,
)
from crowdllama_tpu_torch.utils.aio import run_every
from crowdllama_tpu_torch.utils.keys import peer_id_to_dht_id

KAD_PROTOCOL = "/crowdllama-tpu/kad/1.0.0"
K = 20  # bucket size / lookup width
ALPHA = 3  # lookup concurrency
RPC_TIMEOUT = 5.0
PROVIDER_TTL = 30 * 60.0  # peers re-provide every few seconds; 30 min is ample
ID_BITS = 256

log = logging.getLogger("crowdllama.torch.net.dht")


def _xor_int(a: bytes, b: bytes) -> int:
    return int.from_bytes(a, "big") ^ int.from_bytes(b, "big")


class PyRoutingTable:
    """256 k-buckets over XOR distance, least-recently-seen eviction."""

    def __init__(self, self_id: bytes, k: int = K):
        self.self_id = self_id
        self.k = k
        self.buckets: list[list[tuple[bytes, Contact]]] = [[] for _ in range(ID_BITS)]

    def _bucket_index(self, node_id: bytes) -> int:
        d = _xor_int(self.self_id, node_id)
        if d == 0:
            return 0
        return max(0, d.bit_length() - 1)

    def update(self, contact: Contact) -> None:
        node_id = peer_id_to_dht_id(contact.peer_id)
        if node_id == self.self_id:
            return
        bucket = self.buckets[self._bucket_index(node_id)]
        for i, (nid, _) in enumerate(bucket):
            if nid == node_id:
                bucket.pop(i)
                bucket.append((node_id, contact))
                return
        if len(bucket) >= self.k:
            bucket.pop(0)  # drop least-recently-seen
        bucket.append((node_id, contact))

    def remove(self, peer_id: str) -> None:
        node_id = peer_id_to_dht_id(peer_id)
        bucket = self.buckets[self._bucket_index(node_id)]
        bucket[:] = [(nid, c) for nid, c in bucket if nid != node_id]

    def closest(self, target: bytes, k: int | None = None) -> list[Contact]:
        k = k or self.k
        all_contacts = [(nid, c) for bucket in self.buckets for nid, c in bucket]
        all_contacts.sort(key=lambda nc: _xor_int(nc[0], target))
        return [c for _, c in all_contacts[:k]]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)

    def contacts(self) -> list[Contact]:
        return [c for bucket in self.buckets for _, c in bucket]


class NativeRoutingTable:
    """The C++ routing table (``native/_src``) with the semantics of
    :class:`PyRoutingTable`: ids live in the native table, Contacts in a
    side dict kept in step through the eviction it reports."""

    def __init__(self, self_id: bytes, k: int = K, lib=None):
        self._lib = lib if lib is not None else native.load()
        assert self._lib is not None
        self.self_id = self_id
        self.k = k
        self._h = self._lib.cl_rt_new(self_id, k)
        self._contacts: dict[bytes, Contact] = {}

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.cl_rt_free(self._h)
                self._h = None
        except Exception:
            pass

    def update(self, contact: Contact) -> None:
        node_id = peer_id_to_dht_id(contact.peer_id)
        evicted_buf = (ctypes.c_uint8 * 32)()
        evicted = ctypes.c_int(0)
        if self._lib.cl_rt_upsert(self._h, node_id, evicted_buf,
                                  ctypes.byref(evicted)):
            self._contacts[node_id] = contact
            if evicted.value:
                self._contacts.pop(bytes(evicted_buf), None)

    def remove(self, peer_id: str) -> None:
        node_id = peer_id_to_dht_id(peer_id)
        if self._lib.cl_rt_remove(self._h, node_id):
            self._contacts.pop(node_id, None)

    def closest(self, target: bytes, k: int | None = None) -> list[Contact]:
        k = k or self.k
        out = (ctypes.c_uint8 * (32 * k))()
        n = self._lib.cl_rt_closest(self._h, target, k, out)
        raw = bytes(out)
        return [self._contacts[raw[i * 32:(i + 1) * 32]] for i in range(n)]

    def __len__(self) -> int:
        return int(self._lib.cl_rt_size(self._h))

    def contacts(self) -> list[Contact]:
        # Mutation is single-threaded (asyncio) and every native insert,
        # evict and remove mirrors into _contacts in the same call, so the
        # native count always equals len(_contacts).
        cap = len(self._contacts)
        out = (ctypes.c_uint8 * (32 * cap))()
        n = self._lib.cl_rt_dump(self._h, out, cap)
        assert n == cap, f"native table out of sync: {n} != {cap}"
        raw = bytes(out)
        return [self._contacts[raw[i * 32:(i + 1) * 32]] for i in range(n)]


def RoutingTable(self_id: bytes, k: int = K):
    """The native table when the library is loaded, else the Python one
    (same interface and semantics)."""
    lib = native.load()
    if lib is not None:
        return NativeRoutingTable(self_id, k, lib=lib)
    return PyRoutingTable(self_id, k)


@dataclass
class _ProviderRecord:
    contact: Contact
    expires_at: float
    last_verified: float
    failed_probes: int = 0


class ProviderStore:
    """TTL'd provider records (libp2p providers-store analog), with
    peer-keyed eviction so dead peers can be dropped the moment any layer
    learns they are gone (a per-RPC transport has no TCP FIN to watch)."""

    def __init__(self, ttl: float = PROVIDER_TTL):
        self.ttl = ttl
        self._records: dict[bytes, dict[str, _ProviderRecord]] = {}

    def add(self, key: bytes, contact: Contact) -> None:
        now = time.time()
        self._records.setdefault(key, {})[contact.peer_id] = _ProviderRecord(
            contact=contact, expires_at=now + self.ttl, last_verified=now
        )

    def get(self, key: bytes) -> list[Contact]:
        now = time.time()
        recs = self._records.get(key, {})
        live = {pid: r for pid, r in recs.items() if r.expires_at > now}
        if len(live) != len(recs):
            if live:
                self._records[key] = live
            else:
                self._records.pop(key, None)
        return [r.contact for r in live.values()]

    def remove_peer(self, peer_id: str) -> int:
        """Drop every record advertised by ``peer_id``; returns the count."""
        n = 0
        for key in list(self._records):
            recs = self._records[key]
            if recs.pop(peer_id, None) is not None:
                n += 1
            if not recs:
                del self._records[key]
        return n

    def stale_providers(self, older_than: float) -> list[Contact]:
        """Distinct live providers not verified within ``older_than`` s."""
        now = time.time()
        out: dict[str, Contact] = {}
        for recs in self._records.values():
            for pid, r in recs.items():
                if r.expires_at > now and now - r.last_verified > older_than:
                    out[pid] = r.contact
        return list(out.values())

    def mark_verified(self, peer_id: str) -> None:
        """Record a successful liveness probe.  Does NOT extend expires_at:
        the TTL is the deregistration mechanism for providers that stopped
        re-announcing (a live-but-departed peer must still age out); only
        add() — i.e. a real re-announce — renews it."""
        now = time.time()
        for recs in self._records.values():
            r = recs.get(peer_id)
            if r is not None:
                r.last_verified = now
                r.failed_probes = 0

    def mark_probe_failed(self, peer_id: str,
                          threshold: int = 2) -> bool:
        """Count a failed liveness probe; True once the peer crossed
        ``threshold`` consecutive failures (probe cadence gives a busy
        worker a second chance before delisting, cf. the health machine's
        3-strikes)."""
        tripped = False
        for recs in self._records.values():
            r = recs.get(peer_id)
            if r is not None:
                r.failed_probes += 1
                if r.failed_probes >= threshold:
                    tripped = True
        return tripped

    def sweep_expired(self) -> None:
        now = time.time()
        for key in list(self._records):
            live = {p: r for p, r in self._records[key].items()
                    if r.expires_at > now}
            if live:
                self._records[key] = live
            else:
                del self._records[key]

    def __len__(self) -> int:
        return sum(len(r) for r in self._records.values())


@dataclass
class _LookupState:
    target: bytes
    shortlist: dict[str, Contact] = field(default_factory=dict)
    queried: set[str] = field(default_factory=set)


class DHTNode:
    """DHT node in server mode (every peer stores and serves records)."""

    def __init__(self, host: Host, server_mode: bool = True):
        self.host = host
        self.node_id = peer_id_to_dht_id(host.peer_id)
        self.table = RoutingTable(self.node_id)
        self.providers = ProviderStore()
        self.server_mode = server_mode
        self.bootstrap_addrs: list[str] = []
        self._maintenance: list[asyncio.Task] = []
        # provide() rate-limit memo: key -> (t, fingerprint, accepted).
        self._last_provide: dict[bytes, tuple] = {}
        #: Max alpha-wide RPC rounds per find_providers call.
        self._PROVIDER_ROUNDS = 4
        # KAD RPC stream pool, keyed by peer_id (Contact) or addr string
        # (rationale on StreamPool).  The server-side
        # serve loop holds its read open past the pool idle window so a
        # pooled hit is rarely stale.
        self._rpc_pool = StreamPool()
        # Peer-installed hook: current Resource JSON bytes for the pooled
        # "metadata" op (health probes ride the RPC pool; the legacy
        # read-to-EOF METADATA_PROTOCOL stays served as the fallback).
        self.metadata_provider = None
        # Peer-installed liveness hook (peer_manager.mark_seen): every
        # served RPC proves the caller alive — the superset of the legacy
        # metadata handler's mark_seen, needed because pooled streams
        # replace those per-probe stream opens.
        self.peer_seen = None
        host.set_stream_handler(KAD_PROTOCOL, self._handle_stream)

    # ------------------------------------------------------------- liveness

    def evict_peer(self, peer_id: str) -> None:
        """Drop a peer from the routing table AND its provider records.

        The transport is per-RPC (no persistent connection to watch for a
        FIN), so eviction is driven by whoever learns of the death first:
        a failed RPC here, the health machine (peermanager), or the
        maintenance liveness probe below."""
        self.table.remove(peer_id)
        self._rpc_pool.close_key(peer_id)
        n = self.providers.remove_peer(peer_id)
        if n:
            log.info("evicted dead peer %s (%d provider records)",
                     peer_id[:8], n)

    async def _probe_stale_providers(self, older_than: float,
                                     max_probes: int = 8) -> None:
        """Ping providers not verified recently; evict the unresponsive.

        This bounds how long a crashed worker stays in find_providers
        results to ~the probe interval instead of the full record TTL."""
        stale = self.providers.stale_providers(older_than)[:max_probes]
        if not stale:
            return
        results = await asyncio.gather(
            *(self._rpc(c, {"op": "ping"}) for c in stale))
        for contact, resp in zip(stale, results):
            if resp and resp.get("ok"):
                self.providers.mark_verified(contact.peer_id)
            elif self.providers.mark_probe_failed(contact.peer_id):
                # Two consecutive failed probes: presumed dead (one missed
                # ping from a briefly-saturated worker is forgiven).
                self.evict_peer(contact.peer_id)
        self.providers.sweep_expired()

    async def _refresh_buckets(self) -> None:
        """Random-target lookup + self-lookup to keep buckets populated
        (classic Kademlia bucket refresh; libp2p does this every 10 min)."""
        await self.lookup(os.urandom(32))
        await self.lookup(self.node_id)

    def start_maintenance(self, *, provider_check: float = 60.0,
                          bucket_refresh: float = 600.0) -> None:
        """Start background liveness/refresh loops (idempotent)."""
        if self._maintenance:
            return
        self._maintenance = [
            asyncio.create_task(
                run_every(provider_check,
                          lambda: self._probe_stale_providers(provider_check),
                          log, logging.DEBUG),
                name="dht-provider-liveness"),
            asyncio.create_task(
                run_every(bucket_refresh, self._refresh_buckets, log,
                          logging.DEBUG),
                name="dht-bucket-refresh"),
        ]

    async def stop_maintenance(self) -> None:
        # Cancel the loops BEFORE closing the pool: an RPC completing in
        # the gap would otherwise repopulate it with a leaked stream (the
        # pool's closed-flag also guards late puts).
        for t in self._maintenance:
            t.cancel()
        for t in self._maintenance:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._maintenance = []
        self.close_pool()

    # ------------------------------------------------------------------ RPC

    async def _handle_stream(self, stream: Stream) -> None:
        """Serve RPCs on one stream until the client closes or idles out
        (streams are connections, so reuse happens at this layer)."""
        if stream.remote_contact is not None:
            self.table.update(stream.remote_contact)
        while await self._serve_one_rpc(stream):
            pass

    async def _serve_one_rpc(self, stream: Stream) -> bool:
        try:
            # Idle window outlasts the client pool's (plus slack) so a
            # pooled stream the client still considers fresh is never
            # already dead on this side.
            req = await read_json_frame(stream.reader,
                                        STREAM_POOL_IDLE_S + 5.0)
        except Exception:
            return False
        op = req.get("op")
        resp: dict = {"ok": True}
        try:
            if op == "ping":
                pass
            elif op == "find_node":
                target = bytes.fromhex(req["target"])
                resp["contacts"] = [c.to_dict() for c in self.table.closest(target)]
            elif op == "get_providers":
                key = bytes.fromhex(req["key"])
                resp["providers"] = [c.to_dict() for c in self.providers.get(key)]
                resp["contacts"] = [c.to_dict() for c in self.table.closest(key)]
            elif op == "add_provider":
                if not self.server_mode:
                    raise ValueError("not a DHT server")
                key = bytes.fromhex(req["key"])
                contact = Contact.from_dict(req["provider"])
                # Only accept the caller as provider for itself (no spoofing
                # third parties), but trust its advertised address.
                if contact.peer_id != stream.remote_peer_id:
                    raise ValueError("provider record must be for the calling peer")
                self.providers.add(key, contact)
            elif op == "find_peer":
                pid = str(req["peer_id"])
                found = self.host.peerstore.get(pid)
                resp["contact"] = found.to_dict() if found else None
                resp["contacts"] = [
                    c.to_dict() for c in self.table.closest(peer_id_to_dht_id(pid))
                ]
            elif op == "metadata":
                if self.metadata_provider is None:
                    raise ValueError("no metadata served here")
                data = self.metadata_provider()
                resp["metadata"] = (data.decode()
                                    if isinstance(data, bytes) else data)
                # CURRENT advertised contact: a pooled probe stream can
                # outlive the dial path it was opened through (e.g. the
                # peer failed over to another relay), so the prober needs
                # the fresh contact to refresh its peerstore — otherwise
                # liveness-over-a-zombie-stream pins a stale address
                # forever.
                resp["contact"] = self.host.contact.to_dict()
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:
            resp = {"ok": False, "error": str(e)}
        try:
            await write_json_frame(stream.writer, resp)
        except Exception:
            return False  # writer dead: end the stream's serve loop
        if self.peer_seen is not None and stream.remote_peer_id:
            self.peer_seen(stream.remote_peer_id)
        return True

    def _pool_key(self, contact: Contact | str) -> str:
        return contact.peer_id if isinstance(contact, Contact) else contact

    def close_pool(self) -> None:
        self._rpc_pool.close()

    async def _rpc(self, contact: Contact | str, payload: dict) -> dict | None:
        """One request/reply over a pooled (or fresh) kad stream.

        A stale pooled stream (remote idled it out or restarted) must not
        count as peer death: the exchange retries once on a fresh dial,
        and only the FRESH-stream failure drops the routing entry."""
        key = self._pool_key(contact)
        s = self._rpc_pool.get(key)
        if s is not None:
            try:
                await write_json_frame(s.writer, payload)
                resp = await read_json_frame(s.reader, RPC_TIMEOUT)
                if s.remote_contact is not None:
                    # Successful exchanges refresh the routing entry on
                    # the pooled path too — a wiped table must repopulate
                    # from live traffic exactly as per-dial RPCs did.
                    self.table.update(s.remote_contact)
                self._rpc_pool.put(key, s)
                return resp
            except asyncio.CancelledError:
                s.close()
                raise
            except Exception as e:
                s.close()
                log.debug("pooled rpc to %s stale (%s); redialing",
                          key[:8], e)
        stream = None
        try:
            stream = await self.host.new_stream(contact, KAD_PROTOCOL, timeout=RPC_TIMEOUT)
            await write_json_frame(stream.writer, payload)
            resp = await read_json_frame(stream.reader, RPC_TIMEOUT)
            if stream.remote_contact is not None:
                self.table.update(stream.remote_contact)
            self._rpc_pool.put(key, stream)
            return resp
        except asyncio.CancelledError:
            # stop_maintenance cancels loops mid-RPC: the fresh dial must
            # close on the way out exactly like the pooled branch.
            if stream is not None:
                stream.close()
            raise
        except Exception as e:
            if stream is not None:
                stream.close()
            if isinstance(contact, Contact):
                # One failed RPC drops the routing entry (cheap to re-learn)
                # but NOT provider records — delisting a worker needs the
                # liveness probe's consecutive-failure threshold or the
                # health machine's 3 strikes (see evict_peer callers).
                self.table.remove(contact.peer_id)
            log.debug("rpc %s to %s failed: %s", payload.get("op"), contact, e)
            return None

    async def request_metadata(self, contact: Contact) -> str | None:
        """The peer's Resource JSON via the pooled RPC path; None on any
        failure or when the remote serves no metadata op (caller falls
        back to the legacy read-to-EOF metadata stream).

        The response's self-reported CURRENT contact refreshes our
        peerstore: the pooled stream this rides may have been opened
        through a dial path that no longer works (relay failover), and
        find_peer prefers the peerstore — without the refresh, a live
        peer's address would stay stale for as long as the zombie stream
        survives.  Same trust model as hellos advertising listen_port
        (the stream is authenticated to exactly this peer)."""
        resp = await self._rpc(contact, {"op": "metadata"})
        if not resp or not resp.get("ok") or not resp.get("metadata"):
            return None
        fresh = resp.get("contact")
        if fresh:
            try:
                c = Contact.from_dict(fresh)
                if c.peer_id == contact.peer_id and c.port:
                    self.host.peerstore[c.peer_id] = c
            except (KeyError, ValueError, TypeError):
                pass
        return str(resp["metadata"])

    # ------------------------------------------------------------- lookups

    async def bootstrap(self, addrs: list[str]) -> int:
        """Ping each bootstrap address, then run a self-lookup to fill the
        buckets.  Returns the number of bootstrap peers contacted."""
        self.bootstrap_addrs = list(addrs) or self.bootstrap_addrs
        ok = 0
        for addr in self.bootstrap_addrs:
            resp = await self._rpc(addr, {"op": "ping"})
            if resp and resp.get("ok"):
                ok += 1
        if ok:
            await self.lookup(self.node_id)
        return ok

    def is_connected(self) -> bool:
        """Routing-table-non-empty check."""
        return len(self.table) > 0

    async def reconnect_if_needed(self) -> None:
        """Re-bootstrap when the routing table went empty."""
        if not self.is_connected() and self.bootstrap_addrs:
            log.info("routing table empty; re-bootstrapping")
            await self.bootstrap(self.bootstrap_addrs)

    def _unqueried_in_top_k(self, state: _LookupState) -> list[Contact]:
        """Unqueried candidates among the K closest known — Kademlia's
        termination rule is 'the K closest seen have all been queried'."""
        top_k = sorted(
            state.shortlist.values(),
            key=lambda c: _xor_int(peer_id_to_dht_id(c.peer_id), state.target),
        )[:K]
        return [c for c in top_k if c.peer_id not in state.queried]

    async def lookup(self, target: bytes) -> list[Contact]:
        """Iterative FIND_NODE: returns up to K closest contacts to target."""
        state = _LookupState(target=target)
        for c in self.table.closest(target):
            state.shortlist[c.peer_id] = c

        while True:
            candidates = self._unqueried_in_top_k(state)[:ALPHA]
            if not candidates:
                break
            for c in candidates:
                state.queried.add(c.peer_id)
            results = await asyncio.gather(
                *(self._rpc(c, {"op": "find_node", "target": target.hex()}) for c in candidates)
            )
            for resp in results:
                if not resp or not resp.get("ok"):
                    continue
                for d in resp.get("contacts", []):
                    try:
                        contact = Contact.from_dict(d)
                    except (KeyError, ValueError):
                        continue
                    if contact.peer_id == self.host.peer_id:
                        continue
                    state.shortlist.setdefault(contact.peer_id, contact)

        out = sorted(
            state.shortlist.values(),
            key=lambda c: _xor_int(peer_id_to_dht_id(c.peer_id), target),
        )[:K]
        return out

    async def provide(self, key: bytes, min_interval: float = 0.0) -> int:
        """Advertise self as provider for key on the K closest nodes.

        Also stores locally so single-node and two-node topologies resolve.  Returns the
        number of remote nodes that accepted the record.

        ``min_interval`` rate-limits the NETWORK side: a re-provide of the
        same key is skipped while the last one is younger than this AND
        nothing that invalidates the published record changed (our own
        contact — relay failover/upgrade changes it — or the routing-table
        size, i.e. membership): a literal provide per advertise tick is
        O(N x K) streams per second swarm-wide against a 30-minute TTL."""
        me = self.host.contact
        if self.server_mode:
            self.providers.add(key, me)
        fingerprint = (me.host, me.port, me.relay, len(self.table))
        if min_interval:
            prev = self._last_provide.get(key)
            age = time.monotonic() - prev[0] if prev is not None else 1e9
            if (prev is not None and prev[1] == fingerprint
                    and age < min_interval):
                return prev[2]
            if prev is not None and age < min_interval / 20:
                # Churn floor: during swarm growth every join changes the
                # table size, which would otherwise invalidate the
                # fingerprint on every tick and turn N joins into an
                # O(N^2 x K) re-provide storm.  One re-provide per
                # min_interval/20 propagates changes promptly without the
                # storm.
                return prev[2]
        targets = await self.lookup(key)
        payload = {"op": "add_provider", "key": key.hex(), "provider": me.to_dict()}
        results = await asyncio.gather(*(self._rpc(c, payload) for c in targets))
        accepted = sum(1 for r in results if r and r.get("ok"))
        if accepted or not targets:
            # Don't memoize a rejected-everywhere provide (dialable nodes
            # that answered ok=false keep the fingerprint unchanged): the
            # record exists on no remote node, so the next tick must retry
            # instead of serving the cached zero for min_interval.
            self._last_provide[key] = (time.monotonic(), fingerprint,
                                       accepted)
        return accepted

    async def find_providers(self, key: bytes, limit: int = 10,
                             skip: set[str] | None = None) -> list[Contact]:
        """Iterative GET_PROVIDERS.

        ``skip`` filters records BEFORE the limit applies, so the cap
        bounds NEW providers: a caller that skips its already-known peers
        (discovery's steady state) can keep a small limit without
        starving joiner discovery once known peers outnumber it.  The
        query work stays bounded either way: at most ``_PROVIDER_ROUNDS``
        alpha-wide RPC rounds (provider records replicate to the K nodes
        closest to the key, so a couple of navigation rounds reach holders
        — a steady-state round with nothing new must NOT degenerate into a
        full-table sweep every discovery tick)."""
        skip = skip or set()
        found: dict[str, Contact] = {}
        for c in self.providers.get(key):
            if c.peer_id != self.host.peer_id and c.peer_id not in skip:
                found[c.peer_id] = c
        state = _LookupState(target=key)
        for c in self.table.closest(key):
            state.shortlist[c.peer_id] = c

        rounds = 0
        while len(found) < limit and rounds < self._PROVIDER_ROUNDS:
            rounds += 1
            candidates = self._unqueried_in_top_k(state)[:ALPHA]
            if not candidates:
                break
            for c in candidates:
                state.queried.add(c.peer_id)
            results = await asyncio.gather(
                *(self._rpc(c, {"op": "get_providers", "key": key.hex()}) for c in candidates)
            )
            progressed = False
            any_ok = False
            for resp in results:
                if not resp or not resp.get("ok"):
                    continue
                any_ok = True
                for d in resp.get("providers", []):
                    try:
                        contact = Contact.from_dict(d)
                    except (KeyError, ValueError):
                        continue
                    if (contact.peer_id != self.host.peer_id
                            and contact.peer_id not in skip):
                        if contact.peer_id not in found:
                            progressed = True
                        # Always (re)assign: a remote record may carry a
                        # fresher address than our local store's (worker
                        # restarted on a new port).
                        found[contact.peer_id] = contact
                for d in resp.get("contacts", []):
                    try:
                        contact = Contact.from_dict(d)
                    except (KeyError, ValueError):
                        continue
                    if (
                        contact.peer_id != self.host.peer_id
                        and contact.peer_id not in state.shortlist
                    ):
                        state.shortlist[contact.peer_id] = contact
                        progressed = True
            if any_ok and not progressed:
                # A SUCCESSFUL round surfaced no new record and no closer
                # node — steady state (everything known/skipped): end the
                # lookup after one alpha-wide round instead of sweeping.
                # An all-failed round is NOT steady state (crashed
                # closest peers): keep walking toward live holders.
                break
        out = list(found.values())
        if len(out) > limit:
            # More providers than the per-round cap: return a random subset
            # so repeated discovery rounds cover the whole swarm instead of
            # re-learning the same ``limit`` peers forever (a 16-worker
            # swarm would otherwise plateau at 10 discovered).
            random.shuffle(out)
        return out[:limit]

    async def find_peer(self, peer_id: str) -> Contact | None:
        """Resolve a peer ID to a dialable contact."""
        local = self.host.peerstore.get(peer_id)
        if local is not None:
            return local
        target = peer_id_to_dht_id(peer_id)
        for c in await self.lookup(target):
            if c.peer_id == peer_id:
                return c
        # Ask the closest nodes' peerstores directly.
        for c in self.table.closest(target, ALPHA):
            resp = await self._rpc(c, {"op": "find_peer", "peer_id": peer_id})
            if resp and resp.get("ok") and resp.get("contact"):
                try:
                    return Contact.from_dict(resp["contact"])
                except (KeyError, ValueError):
                    continue
        return None
