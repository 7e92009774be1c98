"""Peer manager: peer table, health state machine, worker scheduler.

Counterpart of ``crowdllama_tpu/peermanager/manager.py``:

- PeerInfo records with failure counts;
- add/update/remove with a ``recently_removed`` quarantine against
  flapping re-adds;
- worker/consumer filters;
- the scheduler: filter by supported model, maximize
  throughput / (1 + load), over a cached per-model routing snapshot
  rebuilt only when the routing epoch moves (metadata/health events), so
  a request costs O(eligible) and not a table scan; only complete shard
  groups are routable;
- background loops: discovery (with idle backoff), health probing with
  3 strikes and linear backoff, stale cleanup; intervals from
  ``config.Intervals``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from crowdllama_tpu_torch.config import Intervals
from crowdllama_tpu_torch.core.resource import Resource
from crowdllama_tpu_torch.utils.aio import run_every

log = logging.getLogger("crowdllama.torch.peermanager")

# Async callback fetching fresh metadata for a peer id; raises on failure.
MetadataFetcher = Callable[[str], Awaitable[Resource]]
# Async callback running one discovery round, returning found resources.
DiscoveryFunc = Callable[[set[str]], Awaitable[list[Resource]]]


@dataclass
class PeerHealthConfig:
    """Health-machine thresholds, via Intervals."""

    intervals: Intervals = field(default_factory=Intervals.default)

    @property
    def stale_after(self) -> float:
        return self.intervals.stale_after

    @property
    def max_failed_attempts(self) -> int:
        return self.intervals.max_failed_attempts

    @property
    def backoff_base(self) -> float:
        return self.intervals.backoff_base


@dataclass
class PeerInfo:
    """One row of the peer table."""

    peer_id: str
    resource: Resource
    last_seen: float = field(default_factory=time.monotonic)
    failed_attempts: int = 0
    is_healthy: bool = True
    next_check_at: float = 0.0

    @property
    def is_worker(self) -> bool:
        return self.resource.worker_mode


@dataclass
class _RouteSnapshot:
    """Cached routing view for one model: every worker a request for the
    model may be sent to RIGHT NOW, with its throughput/(1+load) score
    precomputed.  Valid while the manager's routing epoch is unchanged;
    entries hold live PeerInfo references, so a worker that dies between
    the triggering event and the epoch-check (or through a path that
    forgot to bump) is still skipped by the scan's is_healthy guard."""

    epoch: int
    entries: list[tuple[PeerInfo, float]]
    ids: frozenset[str]


class PeerManager:
    def __init__(
        self,
        self_peer_id: str = "",
        config: PeerHealthConfig | None = None,
        metadata_fetcher: MetadataFetcher | None = None,
        discovery: DiscoveryFunc | None = None,
        on_peer_removed: Callable[[str], None] | None = None,
        on_draining: Callable[[str], None] | None = None,
    ):
        self.self_peer_id = self_peer_id
        self.config = config or PeerHealthConfig()
        self.metadata_fetcher = metadata_fetcher
        self.discovery = discovery
        # Fired on eviction so other layers (e.g. the local DHT's provider
        # store, net/dht.py evict_peer) drop the dead peer immediately.
        self.on_peer_removed = on_peer_removed
        # Fired on a FIRST mark_draining so the replicated-gateway gossip
        # plane (swarm/gossip.py) can publish the quarantine to the other
        # replicas; one replica observing a MigrateFrame stops ALL
        # replicas routing to the drained worker within a gossip round.
        self.on_draining = on_draining
        self.peers: dict[str, PeerInfo] = {}
        self.recently_removed: dict[str, float] = {}  # peer_id -> removed_at
        self._tasks: list[asyncio.Task] = []
        # Routing-snapshot state (see module docstring): epoch bumps on
        # every event that can change routability or scores; snapshots are
        # lazily rebuilt per model on the first request after a bump.
        self._route_epoch = 0
        self._route_cache: dict[str, _RouteSnapshot] = {}
        self.route_snapshot_rebuilds = 0  # stat: rebuilds (not lookups)
        # Discovery idle backoff: consecutive rounds that found nothing
        # stretch the discovery cadence (capped), so a settled swarm stops
        # paying per-interval provider lookups that cannot find anyone new.
        self._discovery_idle_rounds = 0

    # ------------------------------------------------------------- mutation

    @property
    def routing_epoch(self) -> int:
        """Monotonic counter of routing-relevant events (metadata updates,
        peer add/remove, health flips).  Snapshots built at an older epoch
        are stale; equal epochs guarantee an identical eligible set."""
        return self._route_epoch

    def _bump_routing_epoch(self) -> None:
        self._route_epoch += 1

    def add_or_update_peer(self, resource: Resource) -> None:
        pid = resource.peer_id
        if not pid or pid == self.self_peer_id:
            return
        if pid in self.recently_removed:
            # Quarantined: rejects flap re-adds unless genuinely fresh.
            if resource.age_seconds > self.config.intervals.metadata_max_age:
                return
            del self.recently_removed[pid]
        info = self.peers.get(pid)
        if info is None:
            self.peers[pid] = PeerInfo(peer_id=pid, resource=resource)
        else:
            info.resource = resource
            info.last_seen = time.monotonic()
            info.failed_attempts = 0
            info.is_healthy = True
        # Metadata carries the load/throughput the scores derive from:
        # every accepted update is a routing event.
        self._bump_routing_epoch()

    # Quarantine-map hard cap: a long-lived gateway under heavy churn must
    # not grow recently_removed without bound (entries only veto re-adds;
    # beyond the cap the OLDEST vetoes are the least useful, so those are
    # dropped first).  perform_cleanup() sweeps expired entries on its
    # normal cadence; this cap is the backstop between sweeps.
    _QUARANTINE_MAX = 4096

    def remove_peer(self, peer_id: str, quarantine: bool = True) -> None:
        if self.peers.pop(peer_id, None) is not None:
            if quarantine:
                self.recently_removed[peer_id] = time.monotonic()
                if len(self.recently_removed) > self._QUARANTINE_MAX:
                    excess = (len(self.recently_removed)
                              - self._QUARANTINE_MAX)
                    for pid in sorted(self.recently_removed,
                                      key=self.recently_removed.get
                                      )[:excess]:
                        del self.recently_removed[pid]
            self._bump_routing_epoch()
            # A shrinking table should search for replacements promptly.
            self._discovery_idle_rounds = 0
            if self.on_peer_removed is not None:
                try:
                    self.on_peer_removed(peer_id)
                except Exception:
                    log.debug("on_peer_removed callback failed", exc_info=True)

    def mark_seen(self, peer_id: str) -> None:
        info = self.peers.get(peer_id)
        if info is not None:
            info.last_seen = time.monotonic()

    def mark_draining(self, peer_id: str, reason: str = "drain") -> bool:
        """Quarantine ``peer_id`` from routing IMMEDIATELY (epoch bump).

        Called by the gateway the moment it sees a MigrateFrame or a
        ``draining`` reject — metadata propagation (the drained worker's
        final publish + our next health probe) confirms it within an
        interval, but new requests must stop landing on the worker NOW,
        not a probe later.  The peer stays in the table (healthy, still a
        KV donor); only the routing snapshot excludes it.

        ``reason`` records WHY the quarantine happened: ``"drain"`` for
        an announced graceful handoff, ``"wedged"`` when the gateway's
        per-stream progress watchdog caught a gray failure — a worker
        that still answers health probes but stopped making token
        progress, which the ordinary probe plane would never evict
        (docs/ROBUSTNESS.md)."""
        info = self.peers.get(peer_id)
        if info is None or getattr(info.resource, "draining", False):
            return False
        info.resource.draining = True
        info.resource.draining_reason = reason
        self._bump_routing_epoch()
        if self.on_draining is not None:
            try:
                self.on_draining(peer_id)
            except Exception:
                log.debug("on_draining callback failed", exc_info=True)
        return True

    # -------------------------------------------------------------- queries

    def get_peer(self, peer_id: str) -> PeerInfo | None:
        return self.peers.get(peer_id)

    def get_healthy_peers(self) -> list[PeerInfo]:
        return [p for p in self.peers.values() if p.is_healthy]

    def get_workers(self) -> list[PeerInfo]:
        return [p for p in self.peers.values() if p.is_worker]

    def get_consumers(self) -> list[PeerInfo]:
        return [p for p in self.peers.values() if not p.is_worker]

    def is_peer_unhealthy(self, peer_id: str) -> bool:
        info = self.peers.get(peer_id)
        return info is not None and not info.is_healthy

    def skip_set(self) -> set[str]:
        """Peers discovery should skip: EVERY known peer plus the
        quarantine set.

        Known-healthy peers are skipped too because their metadata is
        already refreshed by the health loop (health_check_peer's live
        fetch) — re-fetching it each discovery round made steady-state
        control-plane streams O(N x providers) per round and was the
        dominant chatter term in the 16-worker scaling cliff.  Discovery's
        job here is finding NEW providers only."""
        return set(self.peers) | set(self.recently_removed)

    # ------------------------------------------------------------ scheduler

    def _routing_snapshot(self, model: str) -> _RouteSnapshot:
        """The cached eligible-worker snapshot for ``model``, rebuilt only
        when the routing epoch moved since the last build.  The rebuild is
        the ONLY full-table scan on the request path; between events it is
        a dict lookup plus an int compare."""
        snap = self._route_cache.get(model)
        if snap is not None and snap.epoch == self._route_epoch:
            return snap
        groups = self._complete_groups(model)
        entries: list[tuple[PeerInfo, float]] = []
        for p in self.peers.values():
            if not p.is_healthy or not p.is_worker:
                continue
            r = p.resource
            # Draining workers are quarantined from NEW work but stay in
            # the table: they keep serving KV fetches for the streams that
            # migrated off them (docs/ROBUSTNESS.md).
            if getattr(r, "draining", False):
                continue
            if model and model not in r.supported_models:
                continue
            sg = r.shard_group
            if sg is not None and (sg.group_id not in groups
                                   or sg.shard_index != 0):
                continue
            entries.append((p, r.tokens_throughput / (1.0 + max(r.load, 0.0))))
        snap = _RouteSnapshot(epoch=self._route_epoch, entries=entries,
                              ids=frozenset(p.peer_id for p, _ in entries))
        if len(self._route_cache) >= 64:
            # Requests for arbitrary unknown model names must not grow the
            # cache without bound; real deployments serve a handful.
            self._route_cache.clear()
        self._route_cache[model] = snap
        self.route_snapshot_rebuilds += 1
        return snap

    def is_routable(self, peer_id: str, model: str) -> "PeerInfo | None":
        """The PeerInfo for ``peer_id`` iff requests for ``model`` may be
        sent to it RIGHT NOW — the same predicate find_best_worker scores
        over (healthy worker, serves the model, complete shard group,
        group leader).  Used by affinity-style callers that want to pin a
        specific worker without bypassing routability; answered from the
        routing snapshot, so it costs a set lookup per call."""
        p = self.peers.get(peer_id)
        if p is None or not p.is_healthy:
            return None
        if peer_id not in self._routing_snapshot(model).ids:
            return None
        return p

    def find_best_worker(
        self, model: str, exclude: set[str] = frozenset(),
        require_embeddings: bool = False,
    ) -> PeerInfo | None:
        """Model-filtered best worker by throughput/(1+load), served from
        the routing snapshot: one O(eligible) pass over precomputed scores, no per-call re-filter of
        the full peer table.  Workers in an incomplete shard group are not
        routable (multi-worker models need the full group); ``exclude``
        lets callers fail over past workers that just errored.

        Ties (fresh swarms advertising identical capability) break by
        power-of-two-choices: reservoir-sample TWO of the tied workers and
        send the request to the less loaded — the classic P2C result gives
        near-best-of-N load balance at O(1) extra cost, without the
        thundering-herd of always picking the first tied entry."""
        best: PeerInfo | None = None
        runner_up: PeerInfo | None = None
        best_score, n_tied = -1.0, 0
        for p, score in self._routing_snapshot(model).entries:
            if score < best_score:
                continue
            # Stale-snapshot guard: entries reference live PeerInfo rows,
            # so a worker that died since the rebuild is skipped here even
            # before any epoch bump lands.
            if not p.is_healthy or p.peer_id in exclude:
                continue
            if require_embeddings and not p.resource.embeddings:
                continue
            if score > best_score:
                best, runner_up, best_score, n_tied = p, None, score, 1
            else:  # tie: size-2 reservoir sample over the tied set
                n_tied += 1
                if runner_up is None:
                    runner_up = p
                else:
                    j = random.randrange(n_tied)
                    if j == 0:
                        best = p
                    elif j == 1:
                        runner_up = p
        if runner_up is not None:
            # P2C: of the two sampled tied workers, prefer the one whose
            # live load is lower (loads can drift apart between the
            # identical-score snapshot build and now).
            la = max(best.resource.load, 0.0)
            lb = max(runner_up.resource.load, 0.0)
            if lb < la or (lb == la and random.random() < 0.5):
                best = runner_up
        return best

    def group_members(self, group_id: str) -> list[PeerInfo]:
        return sorted(
            (p for p in self.get_healthy_peers()
             if p.resource.shard_group is not None
             and p.resource.shard_group.group_id == group_id),
            key=lambda p: p.resource.shard_group.shard_index,
        )

    def _complete_groups(self, model: str) -> set[str]:
        seen: dict[str, set[int]] = {}
        want: dict[str, int] = {}
        for p in self.get_healthy_peers():
            sg = p.resource.shard_group
            if sg is None or (model and sg.model != model):
                continue
            seen.setdefault(sg.group_id, set()).add(sg.shard_index)
            want[sg.group_id] = sg.shard_count
        return {
            gid for gid, idxs in seen.items()
            if len(idxs) == want[gid] and idxs == set(range(want[gid]))
        }

    # ------------------------------------------------------- health machine

    async def health_check_peer(self, info: PeerInfo) -> bool:
        """Active probe: live metadata fetch with timeout.  3 strikes ->
        unhealthy; linear backoff failed_attempts x backoff_base."""
        if self.metadata_fetcher is None:
            return info.is_healthy
        try:
            resource = await asyncio.wait_for(
                self.metadata_fetcher(info.peer_id),
                self.config.intervals.metadata_timeout,
            )
            info.resource = resource
            info.last_seen = time.monotonic()
            info.failed_attempts = 0
            info.is_healthy = True
            # Fresh metadata = fresh load/throughput: scores must rebuild.
            self._bump_routing_epoch()
            return True
        except Exception as e:
            was_healthy = info.is_healthy
            info.failed_attempts += 1
            info.next_check_at = (
                time.monotonic() + info.failed_attempts * self.config.backoff_base
            )
            if info.failed_attempts >= self.config.max_failed_attempts:
                info.is_healthy = False
                if was_healthy:
                    self._bump_routing_epoch()
            log.debug("health probe failed for %s (%d/%d): %s",
                      info.peer_id[:8], info.failed_attempts,
                      self.config.max_failed_attempts, e)
            return False

    #: Concurrent health probes per tick: each probe is a full
    #: handshake-priced stream; an uncapped gather over a 16-peer table
    #: bursts them all at once and spikes event-loop lag on small hosts.
    _HEALTH_CONCURRENCY = 4
    #: Probes per tick: the most-due peers only.  A 16-peer table probed
    #: in full every tick makes background AEAD/handshake cost scale with
    #: swarm size; capping amortizes it per INTERVAL (each peer is still
    #: probed well inside stale_after: 16 peers / 8 per tick = 2 ticks).
    _HEALTH_BATCH = 8

    async def perform_health_checks(self) -> None:
        now = time.monotonic()
        sem = asyncio.Semaphore(self._HEALTH_CONCURRENCY)

        async def probe(p):
            async with sem:
                await self.health_check_peer(p)

        due = [p for p in self.peers.values() if p.next_check_at <= now]
        if len(due) > self._HEALTH_BATCH:
            due.sort(key=lambda p: p.next_check_at)
            due = due[:self._HEALTH_BATCH]
        await asyncio.gather(*(probe(p) for p in due))

    def perform_cleanup(self) -> None:
        """Evict peers unseen past stale_after; purge old quarantine
        entries."""
        now = time.monotonic()
        for pid, info in list(self.peers.items()):
            if now - info.last_seen > self.config.stale_after:
                log.info("evicting stale peer %s", pid[:8])
                self.remove_peer(pid)
        cutoff = now - self.config.intervals.quarantine
        # Rebuild the quarantine map only when something actually expired
        # (steady state: nothing does — don't churn a dict every tick).
        if any(t <= cutoff for t in self.recently_removed.values()):
            self.recently_removed = {
                pid: t for pid, t in self.recently_removed.items()
                if t > cutoff
            }

    #: Discovery idle-backoff cap: after enough empty rounds the cadence
    #: stretches to idle_factor x intervals.discovery and stays there.
    _DISCOVERY_IDLE_MAX_FACTOR = 8

    async def run_discovery_once(self) -> None:
        if self.discovery is None:
            return
        try:
            found = await self.discovery(self.skip_set())
        except Exception as e:
            log.debug("discovery round failed: %s", e)
            return
        new = 0
        for resource in found:
            before = len(self.peers)
            self.add_or_update_peer(resource)
            new += len(self.peers) - before
        # Only genuinely NEW peers reset the idle backoff: the skip set
        # already filters known peers, so steady-state rounds return [].
        self._discovery_idle_rounds = (
            0 if new else self._discovery_idle_rounds + 1)

    def discovery_interval(self) -> float:
        """Current discovery cadence: the configured interval stretched by
        the idle backoff (2x per consecutive empty round, capped).  A
        settled 16-worker swarm converges to 1/8th the provider-lookup
        chatter; any membership change snaps it back to the base rate."""
        factor = min(2 ** self._discovery_idle_rounds,
                     self._DISCOVERY_IDLE_MAX_FACTOR)
        return self.config.intervals.discovery * factor

    async def _discovery_loop(self) -> None:
        """run_every with an adaptive interval (utils/aio.run_every takes a
        fixed one): jittered like every other background loop so swarm-wide
        ticks do not synchronize into handshake bursts."""
        iv = self.config.intervals
        await asyncio.sleep(random.random() * iv.discovery * 0.25)
        while True:
            try:
                await self.run_discovery_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.error("background loop error (run_discovery_once)",
                          exc_info=True)
            sleep = self.discovery_interval()
            sleep *= 1 + 0.25 * (2 * random.random() - 1)
            await asyncio.sleep(sleep)

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        iv = self.config.intervals
        self._tasks = [
            asyncio.create_task(self._discovery_loop(), name="pm-discovery"),
            asyncio.create_task(run_every(iv.health_check, self.perform_health_checks, log),
                                name="pm-health"),
            asyncio.create_task(run_every(iv.cleanup, self.perform_cleanup, log),
                                name="pm-cleanup"),
        ]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []
