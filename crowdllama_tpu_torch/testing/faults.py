"""Deterministic fault injection for chaos tests.

Counterpart of ``crowdllama_tpu/testing/faults.py``.  Production code
calls ``await faults.inject("<site>", **attrs)`` at named choke points;
with no plan installed the call is a no-op costing one module-global
read.  A test installs a :class:`FaultPlan`, a seeded list of
:class:`FaultRule`\\ s, and every rule fires at a deterministic pass
index (the seed drives only delay jitter).

Actions: ``"error"`` raises :class:`FaultError`; ``"kill_stream"``
raises :class:`KillStream` (the worker's serve loop drops the transport
with no error frame: a crashed worker as the gateway sees it);
``"delay"`` / ``"slow_stream"`` sleep ``delay_s`` plus seeded jitter;
``"drain"`` raises :class:`DrainRequested` (at ``engine.stream_chunk``
the worker starts its own graceful drain and keeps streaming until the
request migrates); ``"stall_stream"`` raises :class:`StallStream` (the
serve loop holds the transport open and never writes again).
"""

from __future__ import annotations

import asyncio
import random
from contextlib import contextmanager
from dataclasses import dataclass, field

# The choke points the port instruments, with where they are.
FAULT_SITES: dict[str, str] = {
    "engine.request": "non-streamed inference entry (engine/engine.py)",
    "engine.stream_chunk": "before the worker yields chunk N of a stream",
    "scheduler.ragged_chunk": "before a unified ragged prefill-chunk step",
    "host.new_stream": "before a dial + handshake (net/host.py)",
    "relay.op": "relay service op dispatch (net/relay.py)",
    "relay.splice": "before a relay starts its bidirectional copy loop",
    "kv.fetch": "before a worker dials a KV-page donor",
    "kv.serve": "donor side, before a KvFetchRequest is served",
    "gossip.send": "before a gateway replica pushes an anti-entropy frame",
    "gossip.recv": "before an inbound gossip frame is merged",
    "obs.scrape": "before the gateway fetches one worker's metric snapshot",
    "spec.draft_chunk": "after the worker reads a DraftChunk off a "
                        "remote-draft stream (peer/peer.py)",
    "spec.verify": "before a VerifyResult frame is written (the engine's "
                   "verify answer, or the peer's nack of a DraftChunk)",
}


class FaultError(RuntimeError):
    """An injected failure (generic: dial failed, request failed, ...)."""


class KillStream(FaultError):
    """Injected hard death: drop the transport with no error frame."""


class DrainRequested(FaultError):
    """Injected graceful drain: the worker starts its own drain and keeps
    streaming until the scheduler migrates the request."""


class StallStream(FaultError):
    """Injected gray failure: hold the transport open, write nothing."""


_ACTIONS = ("error", "kill_stream", "delay", "drain", "stall_stream",
            "slow_stream")


@dataclass
class FaultRule:
    """Fires at pass index >= ``after`` through ``site`` (counting only
    passes whose attrs satisfy ``match``), at most ``times`` times (0 =
    unlimited)."""

    site: str
    action: str = "error"
    match: dict = field(default_factory=dict)
    after: int = 0
    times: int = 1
    delay_s: float = 0.0
    jitter_s: float = 0.0
    message: str = "injected fault"
    passes: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}: registered sites are "
                f"{', '.join(sorted(FAULT_SITES))}")
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")


class FaultPlan:
    """A seeded, replayable set of rules; ``log`` records every fired
    event as ``(site, attrs, action)`` in firing order."""

    def __init__(self, seed: int = 0, rules: list[FaultRule] | None = None):
        self.seed = seed
        self.rules: list[FaultRule] = list(rules or [])
        self._rng = random.Random(seed)
        self.log: list[tuple[str, dict, str]] = []

    def reset(self) -> None:
        self._rng = random.Random(self.seed)
        self.log.clear()
        for rule in self.rules:
            rule.passes = 0
            rule.fired = 0

    async def inject(self, site: str, **attrs) -> None:
        for rule in self.rules:
            if rule.site != site:
                continue
            if any(attrs.get(k) != v for k, v in rule.match.items()):
                continue
            idx = rule.passes
            rule.passes += 1
            if idx < rule.after:
                continue
            if rule.times and rule.fired >= rule.times:
                continue
            rule.fired += 1
            self.log.append((site, dict(attrs), rule.action))
            if rule.action in ("delay", "slow_stream"):
                jitter = (self._rng.uniform(0, rule.jitter_s)
                          if rule.jitter_s else 0.0)
                await asyncio.sleep(rule.delay_s + jitter)
            elif rule.action == "kill_stream":
                raise KillStream(f"{rule.message} @ {site}")
            elif rule.action == "drain":
                raise DrainRequested(f"{rule.message} @ {site}")
            elif rule.action == "stall_stream":
                raise StallStream(f"{rule.message} @ {site}")
            else:
                raise FaultError(f"{rule.message} @ {site}")


_active: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    global _active
    _active = plan
    return plan


def clear() -> None:
    global _active
    _active = None


def active() -> FaultPlan | None:
    return _active


@contextmanager
def installed(plan: FaultPlan):
    """Install ``plan`` for the block and always clear it after."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


async def inject(site: str, **attrs) -> None:
    """The production-side hook: a no-op unless a plan is installed."""
    plan = _active
    if plan is not None:
        await plan.inject(site, **attrs)
