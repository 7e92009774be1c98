"""The closed-loop performance autopilot.

Counterpart of ``crowdllama_tpu/engine/autotune.py``, with the same
arithmetic: the same window sequence makes the same moves, reverts and
back-offs.  The engine carries five hand-set dials, megastep K, the
adaptive draft-length cap, the ragged ``step_token_budget``, the prefill
chunk and the remote-draft pipeline depth, and the scheduler's flight
plane measures what they buy (the duty cycle per dispatch class and the
tokens each flight emitted).  :class:`AutoTuner` runs coordinate descent
over the dials, one measurement phase per ``interval`` retire windows:

1. a **baseline** phase on the current operating point,
2. ONE dial moved one grid step, and a **trial** phase,
3. the move kept when the trial scores ``min_gain`` over the baseline,
   else reverted,
4. a hard back-off to the last known-good point on a fast-burn edge of
   its per-token latency burn (:class:`~crowdllama_tpu_torch.obs.slo.
   WindowBurn`), recorded in the process-wide :data:`BACKOFF_LOG`, which
   the gateway's flight recorder captures as ``autotune_backoff``.

The score is ``duty_cycle x tokens_per_dispatch x 1 / (1 + burn)``.

A dial changes how many tokens ride one dispatch or how a prompt is
chunked, never which tokens are sampled, and the scheduler calls
:meth:`AutoTuner.on_window` from its retire path, between dispatches, so
a move never touches a flight in progress.

On the card each megastep K is a CUDA graph (``engine/graphs.py``):
the first flight at a new K captures it mid-serve, and a revert to a K
that already has a graph replays it with no new capture (the
``GraphCache.captures`` count is the witness that a revert is free).  A
failed capture raises as it does without the tuner; nothing here falls
back to eager.  Where the serving plan refuses megastep (tp ranks on
distinct devices, ``engine/plan.py check_megastep``) the K grid holds 0
only, so the tuner never switches on what the plan refused.

Learned operating points travel in the gossip map under ``tune/<model>``
keys (``swarm/gossip.py``, :func:`encode_point`, the JAX package's
format), so a fresh worker warm-starts from the swarm's point.
"""

from __future__ import annotations

import json
import logging
import threading

from crowdllama_tpu_torch.obs.slo import WindowBurn

log = logging.getLogger("crowdllama.torch.autotune")

# The coordinate order; gauge children keep these names
# (``crowdllama_autotune_dial{dial="..."}``).
DIALS = ("megastep_k", "draft_k", "step_token_budget", "prefill_chunk",
         "pipeline_depth")

# The exposition families the gauges below render as.
METRIC_FAMILIES = (
    "crowdllama_autotune_dial",
    "crowdllama_autotune_score",
    "crowdllama_autotune_moves_total",
    "crowdllama_autotune_reverts_total",
    "crowdllama_autotune_backoffs_total",
)

# Dial ceilings (the ``--autotune-*-max`` flags override).
DEFAULT_BOUNDS = {
    "megastep_k": 16,
    "draft_k": 8,
    "step_token_budget": 4096,
    "prefill_chunk": 1024,
    "pipeline_depth": 32,
}

# A trial is kept only when it beats the baseline by this margin.
MIN_GAIN = 0.02
# Without a configured decode objective the first phase sets one: this
# multiple of its mean per-token latency.
AUTO_OBJECTIVE_MULT = 5.0
# Phases to sit still after a back-off.
COOLDOWN_PHASES = 2


class _BackoffLog:
    """The process-wide back-off record: tuners record, the gateway's
    flight recorder reads the edge."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.total = 0
        self.last: dict | None = None

    def record(self, event: dict) -> None:
        with self._lock:
            self.total += 1
            self.last = dict(event)

    def snapshot(self) -> tuple[int, dict | None]:
        with self._lock:
            return self.total, dict(self.last) if self.last else None


BACKOFF_LOG = _BackoffLog()


class AutoTuner:
    """Coordinate descent over one scheduler's dials.

    Every entry point runs on the scheduler's event loop, and dial writes
    land between dispatches (the caller is the retire path)."""

    def __init__(self, scheduler, model_id: str = "",
                 interval: int = 32, bounds: dict | None = None,
                 decode_ms: float = 0.0, gossip=None,
                 min_gain: float = MIN_GAIN,
                 burn_short: int = 8, burn_long: int = 32) -> None:
        self.sched = scheduler
        self.model_id = model_id or "default"
        self.interval = max(1, int(interval))
        self.bounds = dict(DEFAULT_BOUNDS)
        self.bounds.update(bounds or {})
        self.min_gain = float(min_gain)
        self.gossip = gossip
        # Per-token latency of each window against the decode objective
        # (configured, or derived after the first phase).
        self.burn = WindowBurn(objective_ms=decode_ms,
                               short=burn_short, long=burn_long)
        self._in_episode = False
        # name -> (ascending candidates, current index)
        self._grids: dict[str, tuple[tuple, int]] = {}
        self._dir: dict[str, int] = {}
        self._build_grids()
        self._order = [d for d in DIALS if d in self._grids]
        self._next_dial = 0
        self._last_good = self._snapshot()
        self._n = 0
        self._duty_sum = 0.0
        self._tokens_sum = 0.0
        self._ms_sum = 0.0
        # The trial move in progress ({"dial", "frm", "to"}), or None.
        self._pending: dict | None = None
        self._cooldown = 0
        self._best_score = 0.0
        self.score = 0.0
        self.moves = 0
        self.reverts = 0
        self.backoffs = 0
        self.warm_starts = 0
        self._warm_pending = gossip is not None
        log.info("autotune up: model=%s dials=%s interval=%d windows",
                 self.model_id, self._order, self.interval)

    # ------------------------------------------------------------- dials

    def _build_grids(self) -> None:
        """One ascending grid per dial the runner supports; a dial
        without one is skipped and its gauge reads its value."""
        from crowdllama_tpu_torch.engine.plan import megastep_allowed

        sched, r = self.sched, self.sched.runner
        if getattr(r, "supports_megastep", False):
            if megastep_allowed(getattr(r, "devices", None)):
                vals = sorted({k for k in (0, 1, 2, 4, 8, 16, 32)
                               if k <= self.bounds["megastep_k"]}
                              | {max(0, sched.megastep_k)})
            else:
                vals = [0]  # the plan refuses megastep here
            self._grids["megastep_k"] = (
                tuple(vals), vals.index(max(0, sched.megastep_k)))
        if getattr(sched, "_spec_adaptive", False):
            hi = max(1, int(self.bounds["draft_k"]))
            vals = tuple(range(1, hi + 1))
            cur = min(max(1, sched.spec_draft_max), hi)
            self._grids["draft_k"] = (vals, vals.index(cur))
        page = int(getattr(r, "page_size", 0) or 0)
        if (page > 0 and getattr(r, "supports_ragged", False)
                and getattr(r, "step_token_budget", 0)):
            lo = r.max_slots + page
            hi = max(lo, int(self.bounds["step_token_budget"]))
            vals = sorted(set(range(lo, hi + 1, 2 * page))
                          | {int(r.step_token_budget)})
            self._grids["step_token_budget"] = (
                tuple(vals), vals.index(int(r.step_token_budget)))
        chunk = int(getattr(r, "prefill_chunk", 0) or 0)
        if chunk > 0:
            vals = sorted({c for c in (64, 128, 256, 512, 1024, 2048)
                           if c <= self.bounds["prefill_chunk"]} | {chunk})
            self._grids["prefill_chunk"] = (tuple(vals), vals.index(chunk))
        if (getattr(r, "supports_remote_draft", False)
                and hasattr(sched, "spec_pipeline_depth")):
            # The depth hint advertised on VerifyResult frames: it caps
            # the gateway's credit backlog, whose own controller takes the
            # min of its estimate and this.
            cur = max(1, int(sched.spec_pipeline_depth))
            hi = max(1, int(self.bounds["pipeline_depth"]))
            vals = sorted({d for d in (1, 2, 4, 8, 16, 32)
                           if d <= hi} | {min(cur, hi)})
            self._grids["pipeline_depth"] = (
                tuple(vals), vals.index(min(cur, hi)))
        for name in self._grids:
            self._dir[name] = 1

    def _read(self, name: str) -> int:
        sched, r = self.sched, self.sched.runner
        if name == "megastep_k":
            return int(sched.megastep_k)
        if name == "draft_k":
            return int(sched.spec_draft_max)
        if name == "step_token_budget":
            return int(getattr(r, "step_token_budget", 0) or 0)
        if name == "prefill_chunk":
            return int(getattr(r, "prefill_chunk", 0) or 0)
        if name == "pipeline_depth":
            return int(getattr(sched, "spec_pipeline_depth", 0) or 0)
        return 0

    def _recompute_ragged(self, r) -> None:
        """The page-aligned ragged chunk of the current (budget, prefill
        chunk) pair, as the paged runner derives it at construction."""
        page = int(getattr(r, "page_size", 0) or 0)
        if page <= 0 or not hasattr(r, "ragged_chunk"):
            return
        budget = int(r.step_token_budget)
        c = min(int(r.prefill_chunk), max(budget - r.max_slots, page))
        r.ragged_chunk = max(page, (c // page) * page)

    def _apply(self, name: str, value: int) -> None:
        """Write one dial, between dispatches: the next dispatch takes
        the new shape."""
        sched, r = self.sched, self.sched.runner
        if name == "megastep_k":
            sched.megastep_k = max(0, int(value))
            sched._megastep = (sched.megastep_k > 0
                               and getattr(r, "supports_megastep", False))
        elif name == "draft_k":
            sched.spec_draft_max = max(1, int(value))
            if getattr(r, "draft_len", 0) > sched.spec_draft_max:
                # The live draft under the new cap; the adaptive
                # controller keeps retuning inside [0, cap].
                r.set_draft_len(sched.spec_draft_max)
        elif name == "step_token_budget":
            r.step_token_budget = int(value)
            self._recompute_ragged(r)
        elif name == "prefill_chunk":
            r.prefill_chunk = int(value)
            if getattr(r, "step_token_budget", 0):
                self._recompute_ragged(r)
        elif name == "pipeline_depth":
            sched.spec_pipeline_depth = max(1, int(value))

    def _snapshot(self) -> dict:
        return {name: self._read(name) for name in self._grids}

    def _restore(self, point: dict) -> None:
        for name, value in point.items():
            if name not in self._grids:
                continue
            vals, _ = self._grids[name]
            if value in vals:
                self._grids[name] = (vals, vals.index(value))
            self._apply(name, value)

    # ------------------------------------------------------------ gossip

    def set_gossip(self, gossip) -> None:
        """Late gossip wiring: warm-start from the swarm's point at the
        next window, unless local moves already happened."""
        self.gossip = gossip
        if gossip is not None and self.moves == 0:
            self._warm_pending = True

    def _apply_warm(self) -> None:
        self._warm_pending = False
        if self.gossip is None or self.moves:
            return
        try:
            point = self.gossip.lookup_operating_point(self.model_id)
        except Exception as e:
            log.debug("autotune warm-start lookup failed: %s", e)
            return
        if not point:
            return
        # Each value to the nearest point of this runner's grid.
        warmed = {}
        for name, value in point.items():
            if name not in self._grids:
                continue
            vals, _ = self._grids[name]
            warmed[name] = min(vals, key=lambda v: abs(v - int(value)))
        if not warmed or warmed == self._snapshot():
            return
        self._restore(warmed)
        self._last_good = self._snapshot()
        self.warm_starts += 1
        self._reset_phase()
        log.info("autotune warm start for %s from gossip: %s",
                 self.model_id, warmed)

    def _publish(self) -> None:
        if self.gossip is None:
            return
        try:
            self.gossip.record_operating_point(self.model_id,
                                               self._last_good)
        except Exception as e:
            log.debug("autotune publish failed: %s", e)

    # ------------------------------------------------------------- loop

    def on_window(self, cls: str, duty: float, emitted: int,
                  dt: float) -> None:
        """Fold one retired flight into the phase (and maybe move a
        dial): called from the scheduler's retire path."""
        if self._warm_pending:
            self._apply_warm()
        ms = dt * 1000.0 / max(1, emitted)
        self.burn.observe(ms)
        if self._check_backoff():
            return
        self._n += 1
        self._duty_sum += float(duty)
        self._tokens_sum += float(emitted)
        self._ms_sum += ms
        if self._n >= self.interval:
            self._phase_end()

    def _reset_phase(self) -> None:
        self._n = 0
        self._duty_sum = 0.0
        self._tokens_sum = 0.0
        self._ms_sum = 0.0

    def _phase_score(self) -> float:
        n = max(1, self._n)
        penalty = 1.0 / (1.0 + self.burn.burn())
        return (self._duty_sum / n) * (self._tokens_sum / n) * penalty

    def _phase_end(self) -> None:
        score = self._phase_score()
        mean_ms = self._ms_sum / max(1, self._n)
        self.score = score
        self._reset_phase()
        if self.burn.objective_ms <= 0.0 and mean_ms > 0.0:
            self.burn.objective_ms = AUTO_OBJECTIVE_MULT * mean_ms
            log.info("autotune derived decode objective: %.2f ms/token",
                     self.burn.objective_ms)
        if self._cooldown > 0:
            self._cooldown -= 1
            self._best_score = max(self._best_score, score)
            return
        if self._pending is None:
            # Baseline phase: refresh the reference, propose a move.
            self._best_score = score
            self._propose()
            return
        move = self._pending
        self._pending = None
        if score >= self._best_score * (1.0 + self.min_gain):
            self._best_score = score
            self._last_good = self._snapshot()
            self._publish()
            log.info("autotune keep: %s %d -> %d (score %.3f)",
                     move["dial"], move["frm"], move["to"], score)
        else:
            # The prior value's graph (a megastep K) is still cached: the
            # revert replays it with no new capture.
            name = move["dial"]
            vals, _ = self._grids[name]
            self._grids[name] = (vals, vals.index(move["frm"]))
            self._apply(name, move["frm"])
            self._dir[name] = -self._dir[name]
            self.reverts += 1
            log.info("autotune revert: %s %d -> %d (score %.3f < %.3f)",
                     name, move["to"], move["frm"], score,
                     self._best_score)

    def _propose(self) -> None:
        """Step the next movable dial (round-robin) one grid position in
        its direction, flipped at an edge and after a revert."""
        for _ in range(len(self._order) or 1):
            if not self._order:
                return
            name = self._order[self._next_dial % len(self._order)]
            self._next_dial += 1
            vals, idx = self._grids[name]
            if len(vals) < 2:
                continue
            d = self._dir[name]
            if not 0 <= idx + d < len(vals):
                d = -d
                self._dir[name] = d
            if not 0 <= idx + d < len(vals):
                continue
            frm, to = vals[idx], vals[idx + d]
            self._grids[name] = (vals, idx + d)
            self._apply(name, to)
            self._pending = {"dial": name, "frm": frm, "to": to}
            self.moves += 1
            log.info("autotune move: %s %d -> %d", name, frm, to)
            return

    def _check_backoff(self) -> bool:
        """On a fast-burn edge, back to the last known-good point, once
        per episode, then ``COOLDOWN_PHASES`` phases without probing."""
        burning = self.burn.in_fast_burn()
        edge = burning and not self._in_episode
        self._in_episode = burning
        if not edge:
            return False
        move = self._pending or {"dial": "", "frm": 0, "to": 0}
        self._pending = None
        self._restore(self._last_good)
        self.backoffs += 1
        self._cooldown = COOLDOWN_PHASES
        self._reset_phase()
        event = {"model": self.model_id, "dial": move["dial"],
                 "frm": move["frm"], "to": move["to"],
                 "restored": dict(self._last_good),
                 "burn": round(self.burn.burn(), 3)}
        BACKOFF_LOG.record(event)
        log.warning("autotune fast-burn backoff: %s", event)
        return True

    # -------------------------------------------------------- telemetry

    def gauges(self) -> dict:
        """Merged into ``Scheduler.telemetry_gauges()``; ``autotune_*``
        keys render as the ``crowdllama_autotune_*`` families."""
        g = {
            "autotune_score": float(self.score),
            "autotune_moves_total": float(self.moves),
            "autotune_reverts_total": float(self.reverts),
            "autotune_backoffs_total": float(self.backoffs),
        }
        for name in DIALS:
            g[f"autotune_dial|dial={name}"] = float(self._read(name))
        return g

    def describe(self) -> dict:
        return {
            "dials": self._snapshot(),
            "score": round(self.score, 4),
            "moves": self.moves,
            "reverts": self.reverts,
            "backoffs": self.backoffs,
            "warm_starts": self.warm_starts,
            "objective_ms": round(self.burn.objective_ms, 3),
        }


def encode_point(point: dict) -> str:
    """The gossip value of a ``tune/<model>`` key: canonical JSON."""
    return json.dumps({k: int(v) for k, v in sorted(point.items())},
                      separators=(",", ":"))


def decode_point(value: str) -> dict:
    try:
        raw = json.loads(value or "")
    except (ValueError, TypeError):
        return {}
    if not isinstance(raw, dict):
        return {}
    out = {}
    for k, v in raw.items():
        if k in DIALS:
            try:
                out[k] = int(v)
            except (TypeError, ValueError):
                continue
    return out
