"""Replicated gateway plane: gossip-shared routing state and tenant quotas.

Counterpart of ``crowdllama_tpu/swarm/gossip.py``.  N gateway replicas
serve one swarm with no coordinator.  Each replica's :class:`GossipNode`
keeps a last-writer-wins map of the routing state:

- ``aff/<conversation-hash>`` -> worker id: prefix-affinity pins and
  KV-donor hints, so any replica routes a returning conversation to the
  worker holding its KV (or names that worker as the chosen worker's
  donor);
- ``quar/<worker-id>`` -> reason: drain quarantines, so one replica's
  observation of a drain quarantines the worker on every replica within
  an anti-entropy round;
- ``tune/<model>`` -> an autopilot operating point
  (``engine/autotune.py encode_point``, the JAX package's JSON): a
  tuner publishes the point it keeps, and a fresh worker's tuner
  warm-starts from it.

Entries are versioned by a hybrid clock (``max(wall_ms, prev + 1)``), so
versions compare across processes and survive restarts; ties break on
``(version, origin, value)``; deletes travel as tombstones.  Every round
is a bidirectional full-state exchange over the authenticated p2p plane
(a ``GossipFrame`` on the inference stream protocol), so dropped,
delayed or partitioned frames cost only convergence time.

Tenant fairness rides the same plane: each replica gossips a monotonic
per-tenant admitted count, and :class:`TenantQuotas` charges its token
buckets with the admits of every replica, so a hot tenant is shed
whichever replica it hits.  On shutdown the map is snapshotted to JSON
(the JAX package's format: a snapshot written by either package loads
in the other) and rehydrated through the LWW merge on restart.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field

from crowdllama_tpu_torch.testing import faults

log = logging.getLogger("crowdllama.torch.gossip")

AFFINITY_PREFIX = "aff/"
QUARANTINE_PREFIX = "quar/"
TUNE_PREFIX = "tune/"

# Tombstones and quarantines older than this are pruned (from the map and
# from snapshots): past the horizon every replica has seen the delete or
# restarted past it.
TOMBSTONE_TTL_S = 3600.0

# A usage digest older than this stops counting toward a tenant's
# cluster-wide admits: the replica that wrote it is gone.
USAGE_TTL_S = 60.0


def hybrid_clock(prev: int = 0) -> int:
    """Wall-clock milliseconds, forced monotonic past ``prev``."""
    return max(int(time.time() * 1000), prev + 1)


@dataclass
class Entry:
    """One versioned LWW map entry (the GossipEntry wire shape)."""

    key: str
    value: str
    version: int
    tombstone: bool = False
    origin: str = ""

    def to_dict(self) -> dict:
        return {"key": self.key, "value": self.value,
                "version": self.version, "tombstone": self.tombstone,
                "origin": self.origin}

    @classmethod
    def from_dict(cls, d) -> "Entry":
        """From a plain dict or a decoded GossipEntry."""
        get = (d.get if isinstance(d, dict)
               else lambda k, default=None: getattr(d, k, default))
        return cls(key=str(get("key", "")), value=str(get("value", "")),
                   version=int(get("version", 0)),
                   tombstone=bool(get("tombstone", False)),
                   origin=str(get("origin", "")))


class LWWMap:
    """Last-writer-wins map with tombstones and a hybrid-clock version.
    ``apply`` is commutative, associative and idempotent: replicas that
    have seen the same set of entries hold the same map."""

    def __init__(self, node_id: str = ""):
        self.node_id = node_id
        self.entries: dict[str, Entry] = {}
        self.clock = 0
        self.applied = 0   # remote entries that won
        self.stale = 0     # remote entries that lost

    def __len__(self) -> int:
        return sum(1 for e in self.entries.values() if not e.tombstone)

    @staticmethod
    def _wins(new: Entry, old: Entry | None) -> bool:
        if old is None:
            return True
        return ((new.version, new.origin, new.value)
                > (old.version, old.origin, old.value))

    def set(self, key: str, value: str, tombstone: bool = False) -> Entry:
        """A local write: bump the clock and install."""
        self.clock = hybrid_clock(self.clock)
        e = Entry(key=key, value=value, version=self.clock,
                  tombstone=tombstone, origin=self.node_id)
        self.entries[key] = e
        return e

    def delete(self, key: str) -> Entry | None:
        if key not in self.entries:
            return None
        return self.set(key, "", tombstone=True)

    def get(self, key: str) -> Entry | None:
        e = self.entries.get(key)
        return None if e is None or e.tombstone else e

    def apply(self, entry: Entry) -> bool:
        """Merge one remote entry; True when it won."""
        old = self.entries.get(entry.key)
        if not self._wins(entry, old):
            self.stale += 1
            return False
        self.entries[entry.key] = entry
        self.clock = max(self.clock, entry.version)
        self.applied += 1
        return True

    def snapshot(self) -> list[Entry]:
        return list(self.entries.values())

    def prune(self, now_ms: int | None = None) -> int:
        """Drop tombstones and quarantines past the TTL horizon."""
        now_ms = hybrid_clock() if now_ms is None else now_ms
        horizon = now_ms - int(TOMBSTONE_TTL_S * 1000)
        dead = [k for k, e in self.entries.items()
                if e.version < horizon
                and (e.tombstone or k.startswith(QUARANTINE_PREFIX))]
        for k in dead:
            del self.entries[k]
        return len(dead)

    def digest(self) -> dict[str, tuple]:
        """key -> (version, origin, value, tombstone): equal digests are
        equal maps."""
        return {k: (e.version, e.origin, e.value, e.tombstone)
                for k, e in self.entries.items()}


# --------------------------------------------------------------- tenants


def parse_tenant_quotas(spec: str) -> dict[str, float]:
    """``"default=20,acme=100"`` -> {tenant: requests/s}; ``*`` names
    ``default``, the bucket unknown tenants charge."""
    quotas: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, rate_s = part.partition("=")
        name = name.strip() or "default"
        if name == "*":
            name = "default"
        try:
            rate = float(rate_s)
        except ValueError:
            raise ValueError(
                f"bad tenant quota {part!r} (want name=requests_per_sec)")
        if rate <= 0:
            raise ValueError(f"tenant quota must be positive: {part!r}")
        quotas[name] = rate
    return quotas


@dataclass
class _Bucket:
    rate: float                 # tokens (requests) per second
    tokens: float               # current balance
    burst: float                # balance ceiling
    last: float = field(default_factory=time.monotonic)


class TenantQuotas:
    """Per-tenant token buckets and weighted-fair admission, held
    consistent across replicas by gossiped usage digests.

    A bucket refills at its tenant's quota and is charged one token per
    admitted request: local admits at once, remote admits when their
    digest arrives (the increase since the last seen count), so the rate a
    tenant sustains across the cluster converges to its quota, not quota
    times replicas.  ``fair_share`` is the weighted share of a gateway's
    inflight cap a tenant may hold while the cap is under pressure."""

    def __init__(self, quotas: dict[str, float], node_id: str = ""):
        if not quotas:
            raise ValueError("TenantQuotas needs at least one quota")
        self.node_id = node_id
        self.quotas = dict(quotas)
        self._buckets: dict[str, _Bucket] = {}
        # Monotonic local admits per tenant (the digest gossiped).
        self.local_admitted: dict[str, int] = {}
        self.usage_version = 0
        # (origin, tenant) -> (count, version, wall_s) of remote digests.
        self._remote: dict[tuple[str, str], tuple[int, int, float]] = {}
        self.admitted_total = 0
        self.shed_total = 0

    def _rate(self, tenant: str) -> float:
        return self.quotas.get(tenant, self.quotas.get("default", 0.0))

    def _bucket(self, tenant: str) -> _Bucket:
        b = self._buckets.get(tenant)
        if b is None:
            rate = self._rate(tenant)
            # One second of quota, at least 1 so a light tenant's first
            # request has a token.
            b = _Bucket(rate=rate, tokens=max(1.0, rate),
                        burst=max(1.0, rate))
            self._buckets[tenant] = b
        return b

    def _refill(self, b: _Bucket, now: float) -> None:
        # A clock behind the bucket's birth must not drain it.
        b.tokens = min(b.burst, b.tokens + b.rate * max(0.0, now - b.last))
        b.last = now

    def try_admit(self, tenant: str, now: float | None = None) -> bool:
        """Charge one request to ``tenant``'s bucket; False = shed (also
        for a tenant with no quota when there is no default)."""
        tenant = tenant or "default"
        if self._rate(tenant) <= 0:
            self.shed_total += 1
            return False
        now = time.monotonic() if now is None else now
        b = self._bucket(tenant)
        self._refill(b, now)
        if b.tokens < 1.0:
            self.shed_total += 1
            return False
        b.tokens -= 1.0
        self.admitted_total += 1
        self.local_admitted[tenant] = self.local_admitted.get(tenant, 0) + 1
        self.usage_version = hybrid_clock(self.usage_version)
        return True

    def fair_share(self, tenant: str, cap: int,
                   active_tenants: set[str]) -> float:
        """Weighted share of ``cap`` for ``tenant`` among the tenants
        holding inflight requests (and itself)."""
        tenant = tenant or "default"
        names = set(active_tenants) | {tenant}
        total = sum(self._rate(n) for n in names) or 1.0
        return cap * self._rate(tenant) / total

    def usage_digest(self) -> list[dict]:
        """This replica's monotonic admit counts (TenantUsage shape)."""
        return [{"origin": self.node_id, "tenant": t, "admitted": c,
                 "version": self.usage_version}
                for t, c in self.local_admitted.items()]

    def apply_usage(self, usage) -> int:
        """Merge remote digests and charge the buckets with the new admits
        each reports; returns the remote admits charged."""
        charged = 0
        now = time.monotonic()
        for u in usage:
            get = (u.get if isinstance(u, dict)
                   else lambda k, default=None: getattr(u, k, default))
            origin = str(get("origin", ""))
            tenant = str(get("tenant", ""))
            count = int(get("admitted", 0))
            version = int(get("version", 0))
            if not origin or origin == self.node_id or not tenant:
                continue
            key = (origin, tenant)
            prev_count, prev_version, _ = self._remote.get(key, (0, 0, 0.0))
            if version <= prev_version and count <= prev_count:
                continue
            delta = max(0, count - prev_count)
            self._remote[key] = (count, max(version, prev_version),
                                 time.time())
            if delta and self._rate(tenant) > 0:
                b = self._bucket(tenant)
                self._refill(b, now)
                # Floored at one negative burst: a flood cannot dig a hole
                # that outlives the burst window.
                b.tokens = max(-b.burst, b.tokens - delta)
                charged += delta
        return charged

    def cluster_admitted(self, tenant: str) -> int:
        """Admits of ``tenant`` across the cluster: local and fresh
        remote digests."""
        horizon = time.time() - USAGE_TTL_S
        total = self.local_admitted.get(tenant, 0)
        for (_, t), (count, _, seen) in self._remote.items():
            if t == tenant and seen >= horizon:
                total += count
        return total


# ----------------------------------------------------------- gossip node


class GossipNode:
    """One gateway replica's membership in the gossip plane: the LWW map
    and usage digests, a full-state exchange with every peer each
    ``interval`` seconds (and once at start, the join sync), and the
    inbound frames the peer's serve loop hands over.  ``peers`` are the
    other replicas' p2p listeners as "host:port"; their identity comes
    from the authenticated hello.  A worker that tunes joins too: its
    autopilot reads and writes ``tune/<model>`` through
    ``record_operating_point`` / ``lookup_operating_point``."""

    def __init__(self, peer, peers=(), interval: float = 2.0,
                 snapshot_path: str = "", quotas: TenantQuotas | None = None,
                 metrics=None):
        self.peer = peer
        self.peers = [str(p) for p in peers if str(p).strip()]
        self.interval = max(0.05, float(interval))
        self.snapshot_path = snapshot_path
        self.quotas = quotas
        self.metrics = metrics  # NodeMetrics (obs/metrics.py) or None
        self.state = LWWMap(node_id=getattr(peer, "peer_id", "") or "")
        # Called with each remote entry that won (the gateway applies
        # quarantines through it).
        self.on_entry = None
        self._task: asyncio.Task | None = None
        self._streams: dict[str, object] = {}
        self.rounds = 0

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        if not self.state.node_id:
            self.state.node_id = getattr(self.peer, "peer_id", "") or ""
        if self.quotas is not None and not self.quotas.node_id:
            self.quotas.node_id = self.state.node_id
        if self.snapshot_path:
            self.load_snapshot()
        self.peer.gossip_node = self  # the serve loop hands frames here
        if self.peers:
            self._task = asyncio.create_task(self._loop())

    async def stop(self, save: bool = True) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        for s in self._streams.values():
            try:
                s.close()
            except Exception:
                pass
        self._streams.clear()
        if getattr(self.peer, "gossip_node", None) is self:
            self.peer.gossip_node = None
        if save and self.snapshot_path:
            self.save_snapshot()

    # -- the routing state the gateway reads and writes ------------------

    def record_affinity(self, akey: str, worker_id: str) -> None:
        cur = self.state.get(AFFINITY_PREFIX + akey)
        if cur is not None and cur.value == worker_id:
            return  # an unchanged pin bumps no version
        self.state.set(AFFINITY_PREFIX + akey, worker_id)
        self._gauge()

    def lookup_affinity(self, akey: str, max_age_s: float = 0.0):
        """(worker_id, version) of a gossiped pin, or None; ``max_age_s``
        expires entries by their hybrid-clock write time."""
        e = self.state.get(AFFINITY_PREFIX + akey)
        if e is None or not e.value:
            return None
        if max_age_s and (time.time() * 1000 - e.version
                          > max_age_s * 1000):
            return None
        return e.value, e.version

    def drop_affinity(self, akey: str) -> None:
        self.state.delete(AFFINITY_PREFIX + akey)
        self._gauge()

    def record_operating_point(self, model_id: str, point: dict) -> None:
        """Publish a tuner's kept dial point for ``model_id``; an
        unchanged point bumps no version."""
        from crowdllama_tpu_torch.engine.autotune import encode_point

        value = encode_point(point)
        cur = self.state.get(TUNE_PREFIX + model_id)
        if cur is not None and cur.value == value:
            return
        self.state.set(TUNE_PREFIX + model_id, value)
        self._gauge()

    def lookup_operating_point(self, model_id: str,
                               max_age_s: float = 0.0) -> dict:
        """The gossiped dial dict for ``model_id``; {} when absent,
        older than ``max_age_s`` (by its hybrid-clock write time) or
        invalid."""
        from crowdllama_tpu_torch.engine.autotune import decode_point

        e = self.state.get(TUNE_PREFIX + model_id)
        if e is None or not e.value:
            return {}
        if max_age_s and (time.time() * 1000 - e.version
                          > max_age_s * 1000):
            return {}
        return decode_point(e.value)

    def record_quarantine(self, worker_id: str, reason: str = "drain") -> None:
        cur = self.state.get(QUARANTINE_PREFIX + worker_id)
        if cur is None or cur.value != reason:
            self.state.set(QUARANTINE_PREFIX + worker_id, reason)
            self._gauge()

    def quarantined(self) -> list[str]:
        return [e.key[len(QUARANTINE_PREFIX):]
                for e in self.state.entries.values()
                if e.key.startswith(QUARANTINE_PREFIX) and not e.tombstone]

    # -- wire -----------------------------------------------------------

    def _frame(self, sync: bool):
        from crowdllama_tpu_torch.core.messages import gossip_frame_msg

        usage = (self.quotas.usage_digest()
                 if self.quotas is not None else ())
        return gossip_frame_msg(
            origin=self.state.node_id,
            entries=[e.to_dict() for e in self.state.snapshot()],
            usage=usage, sync=sync, clock=self.state.clock)

    def apply_frame(self, frame) -> int:
        """Merge a GossipFrame's entries and usage; returns entries won."""
        won = 0
        for ge in frame.entries:
            e = Entry.from_dict(ge)
            if self.state.apply(e):
                won += 1
                if self.on_entry is not None:
                    try:
                        self.on_entry(e)
                    except Exception:
                        log.exception("gossip on_entry callback failed")
        if self.quotas is not None and frame.usage:
            self.quotas.apply_usage(frame.usage)
        if won:
            self._gauge()
        return won

    async def handle_frame(self, msg):
        """Receiver side (from the peer's serve loop): merge the frame and
        answer with our own full frame when the sender asks to sync.
        Returns the reply message or None."""
        frame = msg.gossip_frame
        await faults.inject("gossip.recv", src=frame.origin,
                            dst=self.state.node_id)
        won = self.apply_frame(frame)
        m = self.metrics
        if m is not None:
            m.gossip_inc("frames_received")
            m.gossip_inc("entries_applied", won)
            m.gossip_inc("entries_stale", len(frame.entries) - won)
        if not frame.sync:
            return None
        if m is not None:
            m.gossip_inc("full_syncs")
        return self._frame(sync=False)

    async def _exchange(self, addr: str) -> None:
        """One bidirectional anti-entropy exchange with ``addr``."""
        from crowdllama_tpu_torch.core import wire
        from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL

        await faults.inject("gossip.send", src=self.state.node_id, dst=addr)
        s = self._streams.get(addr)
        fresh = s is None
        if fresh:
            s = await self.peer.host.new_stream(addr, INFERENCE_PROTOCOL)
        try:
            await wire.write_length_prefixed_pb(s.writer, self._frame(True))
            reply = await wire.read_length_prefixed_pb(
                s.reader, timeout=self.interval * 5)
        except Exception:
            self._streams.pop(addr, None)
            try:
                s.close()
            except Exception:
                pass
            if fresh:
                raise
            # The pooled stream was stale (the peer restarted or idled
            # out): one fresh dial before reporting failure.
            s = await self.peer.host.new_stream(addr, INFERENCE_PROTOCOL)
            await wire.write_length_prefixed_pb(s.writer, self._frame(True))
            reply = await wire.read_length_prefixed_pb(
                s.reader, timeout=self.interval * 5)
        self._streams[addr] = s
        if self.metrics is not None:
            self.metrics.gossip_inc("frames_sent")
        if reply.WhichOneof("message") == "gossip_frame":
            won = self.apply_frame(reply.gossip_frame)
            if self.metrics is not None:
                self.metrics.gossip_inc("frames_received")
                self.metrics.gossip_inc("entries_applied", won)

    async def run_round(self) -> int:
        """One exchange with every peer; returns how many succeeded.  A
        failure is per peer and heals on a later round."""
        ok = 0
        for addr in self.peers:
            try:
                await self._exchange(addr)
                ok += 1
            except Exception as e:
                if self.metrics is not None:
                    self.metrics.gossip_inc("send_failures")
                log.debug("gossip exchange with %s failed: %s", addr, e)
        self.rounds += 1
        return ok

    async def _loop(self) -> None:
        # The join sync at once: a (re)started replica converges before
        # its first interval.
        try:
            await self.run_round()
            while True:
                await asyncio.sleep(self.interval)
                await self.run_round()
                if self.rounds % 60 == 0:
                    self.state.prune()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("gossip loop crashed")

    # -- snapshot ---------------------------------------------------------

    def save_snapshot(self, path: str = "") -> str:
        path = path or self.snapshot_path
        if not path:
            return ""
        self.state.prune()
        data = {"node_id": self.state.node_id, "clock": self.state.clock,
                "entries": [e.to_dict() for e in self.state.snapshot()]}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)  # a crash mid-write keeps the old file
        if self.metrics is not None:
            self.metrics.gossip_inc("snapshot_saves")
        log.info("gossip snapshot: %d entries -> %s",
                 len(data["entries"]), path)
        return path

    def load_snapshot(self, path: str = "") -> int:
        """Rehydrate through the LWW merge (anything newer from live
        gossip wins over a stale snapshot)."""
        path = path or self.snapshot_path
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return 0
        except (OSError, ValueError) as e:
            log.warning("gossip snapshot %s unreadable: %s", path, e)
            return 0
        loaded = 0
        for d in data.get("entries", ()):
            if self.state.apply(Entry.from_dict(d)):
                loaded += 1
        self.state.clock = max(self.state.clock, int(data.get("clock", 0)))
        self.state.prune()
        self._gauge()
        if self.metrics is not None:
            self.metrics.gossip["snapshot_entries_loaded"] = loaded
        log.info("gossip snapshot: rehydrated %d entries from %s",
                 loaded, path)
        return loaded

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gossip["map_entries"] = len(self.state)
