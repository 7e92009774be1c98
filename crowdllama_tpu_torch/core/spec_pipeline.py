"""Gateway-drafted speculative pipeline primitives.

Counterpart of ``crowdllama_tpu/core/spec_pipeline.py``, the port's own
copy, written without any framework: the peer's chunk reader, the
scheduler and the gateway's pump all use it.

``DraftFeed`` is the per-stream credit queue between the peer's
DraftChunk reader task and the scheduler's paced dispatch: every chunk the
gateway sends (drafts or a pure ack) is one pipeline credit, and the
scheduler consumes exactly one credit per verify round, so the gateway's
outstanding-chunk window is the worker's dispatch pacing.  The scheduler
duck-types the feed: ``chunks``/``closed``/``free_run``/``stalled_at``
are read inline on the dispatch path.

``PipelineDepthController`` sizes the gateway's window so the verify
pipeline stays full over one RTT of in-flight chunks, discounted by the
measured acceptance rate (rejected chunks are wasted flight) and bounded
by ``max_depth``; when acceptance collapses it pauses drafting (chunks
become pure ack credits) and probes with one k=1 chunk every
``probe_interval`` paused rounds.
"""

from __future__ import annotations

import math
from collections import deque


class DraftFeed:
    """Credit/draft queue for ONE remote-draft generation stream.

    ``push``/``close`` run on the peer's chunk-reader task, consumption on
    the scheduler's decode loop — same event loop, so a plain deque and a
    waker callback are the whole synchronization story.  ``free_run`` is
    the pacing release valve: once set (credit stall, mixed batch, ragged
    prefill) the scheduler decodes the stream at full speed and simply
    stops consuming credits — a perf downgrade, never a correctness one.
    """

    __slots__ = ("chunks", "closed", "free_run", "stalled_at", "_waker")

    def __init__(self) -> None:
        # (chunk_id, position, tokens) triples; tokens == [] is a pure
        # ack credit (worker-draft pacing), non-empty a hosted verify.
        self.chunks: deque[tuple[int, int, list[int]]] = deque()
        self.closed = False
        self.free_run = False
        self.stalled_at = 0.0  # scheduler bookkeeping: creditless since
        self._waker = None     # scheduler wires its wake event here

    def push(self, chunk_id: int, position: int, tokens) -> None:
        self.chunks.append(
            (int(chunk_id), int(position), [int(t) for t in tokens]))
        if self._waker is not None:
            self._waker()

    def close(self) -> None:
        self.closed = True
        if self._waker is not None:
            self._waker()


class PipelineDepthController:
    """RTT-aware pipeline depth for the gateway's draft pump.

    depth = clamp(1 + ceil(rtt / step × max(accept, floor)), 1, max_depth)

    — enough chunks in flight to cover one round trip of verify steps, on
    the optimistic assumption that ``accept`` of them survive; the floor
    keeps a cold/collapsed estimate from pinning depth at 1 forever (one
    probe chunk per RTT still flows).  When acceptance collapses below
    ``low_accept`` the controller PAUSES drafting entirely — ``draft_k``
    returns 0 and chunks degrade to pure ack credits, the cross-wire
    analogue of the scheduler's k=0 spec pause — and resumes when the
    decayed window recovers.
    """

    def __init__(self, max_depth: int = 8, accept_floor: float = 0.125,
                 low_accept: float = 0.05, resume_accept: float = 0.2,
                 rtt_alpha: float = 0.3, step_alpha: float = 0.3,
                 accept_alpha: float = 0.3) -> None:
        self.max_depth = max(1, int(max_depth))
        self.accept_floor = accept_floor
        self.low_accept = low_accept
        self.resume_accept = resume_accept
        self._rtt_a = rtt_alpha
        self._step_a = step_alpha
        self._acc_a = accept_alpha
        self.rtt_ewma = 0.0   # seconds, chunk send -> verify reply
        self.step_ewma = 0.0  # seconds per verify round at the worker
        self.accept_ewma = 1.0  # fraction of offered drafts accepted
        self.paused = False
        # Paused probing (the cross-wire analogue of the scheduler's
        # spec_probe_interval): a paused pump drafts one k=1 probe chunk
        # every this many rounds so the acceptance window can recover —
        # without it, pure-ack rounds never feed observe_accept and the
        # pause would be absorbing.
        self.probe_interval = 32
        self._paused_rounds = 0

    # ------------------------------------------------------------ observe

    def observe_rtt(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        self.rtt_ewma = (s if self.rtt_ewma == 0.0
                         else (1 - self._rtt_a) * self.rtt_ewma
                         + self._rtt_a * s)

    def observe_step(self, seconds: float) -> None:
        """Fold one verify-arrival gap into the worker round-time estimate.

        Gap samples are only honest when the pipe is saturated: at low
        depth, arrivals bunch into RTT-spaced bursts and the boundary
        gaps measure the wire, not the worker.  An EWMA over such a mix
        pins the estimate near the RTT and depth never grows (the
        estimator's own output gates the saturation that would fix it).
        The true round time is the FLOOR of the gap distribution —
        back-to-back arrivals within a burst — so track a decayed min:
        drop to any smaller sample immediately, creep up a few % per
        sample so a genuinely slower worker (bigger batch, spec retune)
        still raises the estimate."""
        s = float(seconds)
        if s <= 1e-4:
            return  # coalesced arrivals: not a round-time sample
        if self.step_ewma == 0.0 or s < self.step_ewma:
            self.step_ewma = s
        else:
            self.step_ewma = min(s, self.step_ewma * (1.0 + self._step_a / 6))

    def observe_accept(self, accepted: int, offered: int) -> None:
        if offered <= 0:
            return
        rate = min(1.0, max(0.0, accepted / offered))
        self.accept_ewma = ((1 - self._acc_a) * self.accept_ewma
                            + self._acc_a * rate)
        if self.accept_ewma < self.low_accept:
            self.paused = True
        elif self.paused and self.accept_ewma >= self.resume_accept:
            self.paused = False

    # ------------------------------------------------------------- decide

    def depth(self) -> int:
        """Chunks to keep in flight.  With no RTT estimate yet (or a
        same-host wire), one outstanding chunk is the stop-and-wait
        baseline every arm starts from."""
        if self.rtt_ewma <= 0.0 or self.step_ewma <= 0.0:
            return 1
        acc = max(self.accept_ewma, self.accept_floor)
        d = 1 + math.ceil(self.rtt_ewma / self.step_ewma * acc)
        return max(1, min(self.max_depth, d))

    def draft_k(self, advertised_k: int) -> int:
        """Tokens to draft per chunk: the worker's advertised k, 0 while
        paused (chunks degrade to pure ack credits), and a single-token
        probe every ``probe_interval`` paused rounds so a recovered
        workload can lift the acceptance window back out of the pause."""
        if self.paused:
            self._paused_rounds += 1
            if self._paused_rounds >= self.probe_interval:
                self._paused_rounds = 0
                return min(1, max(0, int(advertised_k)))
            return 0
        self._paused_rounds = 0
        return max(0, int(advertised_k))
