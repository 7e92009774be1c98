"""Elastic drain/scale loop: hysteresis over the swarm's load gauges.

Counterpart of ``crowdllama_tpu/swarm/autoscale.py``.  The drain path
(``Peer.drain()`` / ``POST /drain``) makes removing a worker cheap:
in-flight streams migrate and the node lingers drained.  This module
closes the loop: a pure-logic controller watches the gauges every node
already exposes (the scheduler's ``pending_depth``, ``batch_occupancy``
and the gateway's shed counter) and emits ``drain`` / ``undrain``
decisions with hysteresis, so an operator sidecar (or a test harness) can
drive ``POST /drain`` against the right worker.

Dependency-free and synchronous: the controller holds no sockets and
spawns no tasks.  Feed it one :class:`Sample` per tick (built from
scraped ``/metrics`` text with :func:`parse_gauges`, or synthetically)
and act on the returned :class:`Decision`.

Hysteresis shape (dual watermark with cooldown):

- HOT when mean batch occupancy >= ``high_occupancy``, mean pending depth
  >= ``high_pending``, or any requests were shed since the last tick.
  ``up_ticks`` consecutive hot samples -> ``undrain`` (add capacity).
- COLD when occupancy <= ``low_occupancy`` AND pending ~ 0 AND no shed.
  ``down_ticks`` consecutive cold samples -> ``drain`` (remove capacity).
  Down is slower than up on purpose: under-capacity sheds traffic,
  over-capacity only wastes watts.
- After any action the controller holds for ``cooldown_ticks`` so the
  gauges can settle (a drain shifts load to the survivors and briefly
  LOOKS hot).

``simulate()`` runs the controller against a deterministic queueing model
through a 4x load swing and returns a tick-by-tick record; ``main``
writes it as JSON.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field

__all__ = [
    "AutoscaleConfig",
    "AutoscaleController",
    "Decision",
    "Sample",
    "parse_gauges",
    "pick_drain_candidate",
    "simulate",
]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Watermarks + pacing for the drain/undrain hysteresis."""

    high_occupancy: float = 0.75   # mean batch fullness that reads as hot
    low_occupancy: float = 0.35    # ... and as cold (~3x headroom)
    high_pending: float = 4.0      # mean queued requests per worker
    up_ticks: int = 2              # consecutive hot samples before undrain
    down_ticks: int = 4            # consecutive cold samples before drain
    cooldown_ticks: int = 5        # hold after any action
    min_workers: int = 1
    max_workers: int = 16


@dataclass(frozen=True)
class Sample:
    """One tick's aggregate view of the serving pool."""

    workers: int               # currently serving (non-draining) workers
    pending_depth: float       # mean scheduler pending depth per worker
    batch_occupancy: float     # mean decode-batch fullness, 0..1
    shed: float = 0.0          # requests shed since the previous sample


@dataclass(frozen=True)
class Decision:
    action: str                # "hold" | "drain" | "undrain"
    reason: str


class AutoscaleController:
    """Dual-watermark hysteresis over :class:`Sample` ticks.

    Stateful but tiny: two run-length counters and a cooldown.  The
    caller owns actuation — mapping ``undrain`` to booting/undraining a
    worker and ``drain`` to ``POST /drain`` on a victim (see
    :func:`pick_drain_candidate`).
    """

    def __init__(self, config: AutoscaleConfig | None = None) -> None:
        self.config = config or AutoscaleConfig()
        self._hot = 0
        self._cold = 0
        self._cooldown = 0

    def observe(self, sample: Sample) -> Decision:
        cfg = self.config
        if self._cooldown > 0:
            # Gauges are still settling from the last action; counting
            # them would double-trigger off the transient.
            self._cooldown -= 1
            self._hot = self._cold = 0
            return Decision("hold", f"cooldown ({self._cooldown} left)")
        hot = (sample.batch_occupancy >= cfg.high_occupancy
               or sample.pending_depth >= cfg.high_pending
               or sample.shed > 0)
        cold = (sample.batch_occupancy <= cfg.low_occupancy
                and sample.pending_depth < 1.0
                and sample.shed == 0)
        if hot:
            self._hot += 1
            self._cold = 0
            if self._hot >= cfg.up_ticks:
                if sample.workers >= cfg.max_workers:
                    return Decision("hold", "hot but at max_workers")
                self._hot = 0
                self._cooldown = cfg.cooldown_ticks
                return Decision(
                    "undrain",
                    f"hot x{cfg.up_ticks}: occupancy="
                    f"{sample.batch_occupancy:.2f} pending="
                    f"{sample.pending_depth:.1f} shed={sample.shed:.0f}")
            return Decision("hold", f"hot {self._hot}/{cfg.up_ticks}")
        if cold:
            self._cold += 1
            self._hot = 0
            if self._cold >= cfg.down_ticks:
                if sample.workers <= cfg.min_workers:
                    return Decision("hold", "cold but at min_workers")
                self._cold = 0
                self._cooldown = cfg.cooldown_ticks
                return Decision(
                    "drain",
                    f"cold x{cfg.down_ticks}: occupancy="
                    f"{sample.batch_occupancy:.2f}")
            return Decision("hold", f"cold {self._cold}/{cfg.down_ticks}")
        self._hot = self._cold = 0
        return Decision("hold", "in band")


def pick_drain_candidate(gauges_by_worker: dict[str, dict]) -> str:
    """The least-disruptive worker to drain: fewest queued + running
    requests, ties broken by id for determinism.  Input maps worker id ->
    its gauge dict (the ``parse_gauges`` shape)."""
    if not gauges_by_worker:
        return ""
    def cost(item):
        wid, g = item
        return (float(g.get("pending_depth", 0.0))
                + float(g.get("batch_occupancy", 0.0)), wid)
    return min(gauges_by_worker.items(), key=cost)[0]


_GAUGE_RE = re.compile(
    r"^crowdllama_engine_(pending_depth|batch_occupancy)\s+"
    r"([0-9.eE+-]+)\s*$", re.MULTILINE)
_SHED_RE = re.compile(
    r"^crowdllama_gateway_shed_total\s+([0-9.eE+-]+)\s*$", re.MULTILINE)
_BURN_RE = re.compile(
    r"^crowdllama_slo_burn_rate\{[^}]*\}\s+([0-9.eE+-]+)\s*$",
    re.MULTILINE)


def parse_gauges(metrics_text: str) -> dict:
    """Pull the controller's inputs out of one node's ``/metrics`` text.

    Returns ``{"pending_depth": float, "batch_occupancy": float,
    "shed_total": float}`` with absent families as 0 — a worker exposes
    the engine gauges, the gateway the shed counter.  With SLO
    objectives configured the gateway also exposes burn gauges,
    surfaced as ``slo_burn_rate`` (key present only then): the WORST
    series across objectives and windows, because an autoscaler reacting
    to any burning window beats one averaging a fast burn away."""
    out = {"pending_depth": 0.0, "batch_occupancy": 0.0, "shed_total": 0.0}
    for name, val in _GAUGE_RE.findall(metrics_text):
        out[name] = float(val)
    m = _SHED_RE.search(metrics_text)
    if m:
        out["shed_total"] = float(m.group(1))
    burns = [float(v) for v in _BURN_RE.findall(metrics_text)]
    if burns:
        out["slo_burn_rate"] = max(burns)
    return out


# ---------------------------------------------------------------- simulation


@dataclass
class _SimWorker:
    capacity: float            # requests it can finish per tick
    draining: bool = False
    backlog: float = 0.0       # in-flight + queued work at this worker


@dataclass
class SimResult:
    ticks: list[dict] = field(default_factory=list)
    summary: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"ticks": self.ticks, "summary": self.summary},
                          indent=2, sort_keys=True)


def _load_profile(n_ticks: int, base: float, peak: float) -> list[float]:
    """Deterministic 4x swing: low plateau, linear ramp up, high plateau,
    ramp down, low plateau — each phase a fifth of the run."""
    fifth = n_ticks // 5
    out: list[float] = []
    for t in range(n_ticks):
        if t < fifth:
            out.append(base)
        elif t < 2 * fifth:
            f = (t - fifth) / max(1, fifth)
            out.append(base + f * (peak - base))
        elif t < 3 * fifth:
            out.append(peak)
        elif t < 4 * fifth:
            f = (t - 3 * fifth) / max(1, fifth)
            out.append(peak - f * (peak - base))
        else:
            out.append(base)
    return out


def simulate(n_ticks: int = 120, total_workers: int = 8,
             start_active: int = 4, per_worker_capacity: float = 4.0,
             base_load: float = 8.0, peak_load: float = 32.0,
             config: AutoscaleConfig | None = None) -> SimResult:
    """Drive the controller through a queueing model of the swarm.

    The pool holds ``total_workers`` engines of which ``start_active``
    serve; ``drain`` moves one serving worker to draining (its backlog
    migrates to the survivors — the whole point of live migration) and
    ``undrain`` brings one back.  Load swings ``base_load`` ->
    ``peak_load`` (default 4x) and back.  Everything is deterministic:
    same inputs, same artifact bytes."""
    cfg = config or AutoscaleConfig(
        min_workers=1, max_workers=total_workers)
    ctl = AutoscaleController(cfg)
    workers = [_SimWorker(per_worker_capacity)
               for _ in range(total_workers)]
    for w in workers[start_active:]:
        w.draining = True
    loads = _load_profile(n_ticks, base_load, peak_load)
    result = SimResult()
    total_shed = 0.0
    total_served = 0.0
    total_migrated = 0.0
    peak_active = start_active
    # Shed when a worker's backlog would exceed this many ticks of work —
    # mirrors the scheduler's pending-depth admission cap.
    queue_cap_ticks = 3.0
    for t, load in enumerate(loads):
        active = [w for w in workers if not w.draining]
        # Even spread (the gateway's scoring approximates this at scale).
        per = load / max(1, len(active))
        shed = 0.0
        for w in active:
            room = w.capacity * queue_cap_ticks - w.backlog
            admitted = min(per, max(0.0, room))
            shed += per - admitted
            w.backlog += admitted
        served = 0.0
        for w in active:
            done = min(w.backlog, w.capacity)
            w.backlog -= done
            served += done
        occupancy = (min(1.0, (load / (len(active) * per_worker_capacity)))
                     if active else 1.0)
        pending = (sum(max(0.0, w.backlog - w.capacity) for w in active)
                   / max(1, len(active)))
        decision = ctl.observe(Sample(
            workers=len(active), pending_depth=pending,
            batch_occupancy=occupancy, shed=shed))
        migrated = 0.0
        if decision.action == "drain" and len(active) > cfg.min_workers:
            victim = max(range(len(workers)),
                         key=lambda i: (not workers[i].draining,
                                        -workers[i].backlog, -i))
            moved = workers[victim].backlog
            workers[victim].backlog = 0.0
            workers[victim].draining = True
            survivors = [w for w in workers if not w.draining]
            for w in survivors:       # KV handoff: backlog migrates whole
                w.backlog += moved / max(1, len(survivors))
            migrated = moved
        elif decision.action == "undrain":
            for w in workers:
                if w.draining:
                    w.draining = False
                    break
        n_active = sum(1 for w in workers if not w.draining)
        peak_active = max(peak_active, n_active)
        total_shed += shed
        total_served += served
        total_migrated += migrated
        result.ticks.append({
            "tick": t, "load": round(load, 3),
            "active_workers": n_active,
            "batch_occupancy": round(occupancy, 4),
            "pending_depth": round(pending, 4),
            "shed": round(shed, 3), "served": round(served, 3),
            "migrated_backlog": round(migrated, 3),
            "action": decision.action, "reason": decision.reason,
        })
    result.summary = {
        "config": asdict(cfg),
        "n_ticks": n_ticks,
        "load_swing": round(peak_load / base_load, 2),
        "start_active": start_active,
        "peak_active": peak_active,
        "final_active": sum(1 for w in workers if not w.draining),
        "total_offered": round(sum(loads), 3),
        "total_served": round(total_served, 3),
        "total_shed": round(total_shed, 3),
        "total_migrated_backlog": round(total_migrated, 3),
        "drains": sum(1 for r in result.ticks if r["action"] == "drain"),
        "undrains": sum(
            1 for r in result.ticks if r["action"] == "undrain"),
    }
    return result


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Run the deterministic autoscale simulation and write "
                    "its JSON artifact.")
    p.add_argument("--out", default="-",
                   help="output path ('-' = stdout)")
    p.add_argument("--ticks", type=int, default=120)
    args = p.parse_args(argv)
    res = simulate(n_ticks=args.ticks)
    text = res.to_json() + "\n"
    if args.out == "-":
        print(text, end="")
    else:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
