"""The gateway's SLO burn-rate plane.

Counterpart of ``crowdllama_tpu/obs/slo.py``: multi-window burn-rate
tracking over the gateway's two latency objectives, TTFT
(``--slo-ttft-ms``, admission to the worker's first token frame) and the
decode step (``--slo-decode-ms``, the gap between streamed frames).  Each
observation is good or bad against its objective; the burn rate over a
window is ``bad_fraction / error_budget``.  A 5 m and a 1 h window both
at or above ``FAST_BURN`` is *fast burn*, an edge-triggered episode the
flight recorder captures.  Host-side arithmetic over bucketed rolling
counters with an injectable clock.  :class:`WindowBurn` is the same
burn-rate arithmetic over the autopilot's retire windows
(``engine/autotune.py``) in place of wall-clock cells.
"""

from __future__ import annotations

import collections
import threading
import time

# Rolling windows (label, seconds): the short one triggers, the long one
# confirms it is not a blip.
WINDOWS = (("5m", 300.0), ("1h", 3600.0))
# One (good, bad) cell per this many seconds: 360 cells for the 1 h window.
BUCKET_S = 10.0
# The share of requests allowed to breach the objective.
DEFAULT_BUDGET = 0.05
# Both windows at or above this burn rate: fast burn.
FAST_BURN = 14.0


class BurnRateTracker:
    """Good/bad classification and the multi-window burn rates of ONE
    objective.  Thread-safe."""

    def __init__(self, name: str, objective_ms: float,
                 budget: float = DEFAULT_BUDGET,
                 clock=time.monotonic) -> None:
        self.name = name
        self.objective_ms = float(objective_ms)
        self.budget = min(1.0, max(1e-6, float(budget)))
        self._clock = clock
        self._lock = threading.Lock()
        self._cells: dict[float, list[int]] = {}  # bucket -> [good, bad]
        self.good_total = 0
        self.bad_total = 0

    def observe(self, seconds: float) -> bool:
        """Record one observation; True when it breached."""
        bad = seconds * 1000.0 > self.objective_ms
        now = self._clock()
        bucket = now - (now % BUCKET_S)
        horizon = now - max(w for _, w in WINDOWS) - BUCKET_S
        with self._lock:
            cell = self._cells.setdefault(bucket, [0, 0])
            cell[1 if bad else 0] += 1
            if bad:
                self.bad_total += 1
            else:
                self.good_total += 1
            for b in [b for b in self._cells if b < horizon]:
                del self._cells[b]
        return bad

    def burn_rates(self) -> dict[str, float]:
        """{window label: burn rate}, 0.0 for an idle window."""
        now = self._clock()
        out: dict[str, float] = {}
        with self._lock:
            for label, span in WINDOWS:
                good = bad = 0
                for b, (g, n) in self._cells.items():
                    if b >= now - span:
                        good += g
                        bad += n
                total = good + bad
                out[label] = (bad / total / self.budget) if total else 0.0
        return out

    def in_fast_burn(self) -> bool:
        return all(r >= FAST_BURN for r in self.burn_rates().values())


class WindowBurn:
    """Burn-rate arithmetic over the last N retire windows: the
    autopilot's worker-local SLO signal.  The scheduler retires a window
    every few milliseconds under load and none when idle, so wall-clock
    cells would read empty just when a bad dial move stalls the loop.
    Each observation is one window's per-token latency against
    ``objective_ms``; burn over a deque is ``bad_fraction / budget``;
    *fast burn* needs the short deque full and both deques at or above
    ``FAST_BURN``."""

    def __init__(self, objective_ms: float = 0.0, short: int = 8,
                 long: int = 32, budget: float = DEFAULT_BUDGET) -> None:
        self.objective_ms = float(objective_ms)
        self.budget = min(1.0, max(1e-6, float(budget)))
        self._short: collections.deque = collections.deque(
            maxlen=max(1, int(short)))
        self._long: collections.deque = collections.deque(
            maxlen=max(1, int(long)))
        self.breaches_total = 0

    def observe(self, ms: float) -> bool:
        """Record one window's per-token latency; True when it breached.
        With no objective yet every window counts good (the autopilot
        derives one from its first phase)."""
        bad = self.objective_ms > 0.0 and ms > self.objective_ms
        self._short.append(1 if bad else 0)
        self._long.append(1 if bad else 0)
        if bad:
            self.breaches_total += 1
        return bad

    def _rate(self, dq) -> float:
        return (sum(dq) / len(dq) / self.budget) if dq else 0.0

    def burn(self) -> float:
        """The long deque's burn rate (the autopilot's score penalty)."""
        return self._rate(self._long)

    def in_fast_burn(self) -> bool:
        return (len(self._short) == self._short.maxlen
                and self._rate(self._short) >= FAST_BURN
                and self._rate(self._long) >= FAST_BURN)


class SloEngine:
    """The gateway's objectives and the edge-triggered fast-burn episode
    flag; an objective of 0 is off (no tracker, no gauges)."""

    def __init__(self, ttft_ms: float = 0.0, decode_ms: float = 0.0,
                 budget: float = DEFAULT_BUDGET,
                 clock=time.monotonic) -> None:
        self.trackers: dict[str, BurnRateTracker] = {}
        if ttft_ms > 0:
            self.trackers["ttft"] = BurnRateTracker(
                "ttft", ttft_ms, budget, clock)
        if decode_ms > 0:
            self.trackers["decode"] = BurnRateTracker(
                "decode", decode_ms, budget, clock)
        self._in_episode = False
        self.fast_burn_episodes_total = 0

    @property
    def enabled(self) -> bool:
        return bool(self.trackers)

    def observe_ttft(self, seconds: float) -> bool:
        t = self.trackers.get("ttft")
        return t.observe(seconds) if t is not None else False

    def observe_decode(self, seconds: float) -> bool:
        t = self.trackers.get("decode")
        return t.observe(seconds) if t is not None else False

    def fast_burn(self) -> bool:
        """Level signal: any objective fast-burning on both windows.  Also
        advances the edge-triggered episode counter."""
        burning = any(t.in_fast_burn() for t in self.trackers.values())
        if burning and not self._in_episode:
            self.fast_burn_episodes_total += 1
        self._in_episode = burning
        return burning

    def expose(self) -> list[str]:
        """The ``crowdllama_slo_*`` families of the gateway's /metrics."""
        if not self.enabled:
            return []
        items = sorted(self.trackers.items())
        lines = ["# TYPE crowdllama_slo_objective_ms gauge"]
        for name, t in items:
            lines.append(f'crowdllama_slo_objective_ms{{objective="{name}"}} '
                         f"{t.objective_ms:g}")
        lines.append("# TYPE crowdllama_slo_requests_total counter")
        for name, t in items:
            for verdict, n in (("good", t.good_total), ("bad", t.bad_total)):
                lines.append(f'crowdllama_slo_requests_total{{objective='
                             f'"{name}",verdict="{verdict}"}} {n}')
        lines.append("# TYPE crowdllama_slo_burn_rate gauge")
        for name, t in items:
            for label, rate in t.burn_rates().items():
                lines.append(f'crowdllama_slo_burn_rate{{objective="{name}",'
                             f'window="{label}"}} {rate:.4f}')
        lines.append("# TYPE crowdllama_slo_fast_burn gauge")
        lines.append(
            f"crowdllama_slo_fast_burn {1 if self.fast_burn() else 0}")
        lines.append("# TYPE crowdllama_slo_fast_burn_episodes_total counter")
        lines.append(f"crowdllama_slo_fast_burn_episodes_total "
                     f"{self.fast_burn_episodes_total}")
        return lines
