"""Continuous batching scheduler.

Counterpart of ``crowdllama_tpu/engine/scheduler.py`` (the one-device
serving core): admit pending requests into free batch slots, run the
shared decode loop while any slot is active, stream each new token to its
request's queue, retire slots on EOS / max-tokens / context exhaustion.
Long prompts are admitted chunk by chunk, one such prompt at a time
(later long prompts wait in a FIFO of deferred requests while short ones
keep admitting): through the paged runner's unified ragged step, where the
prompt prefills in fixed chunks INSIDE the decode dispatches, or, when the
runner has no ragged step or ``ragged`` is off, through the legacy chunked
admission (``prefill_begin`` / ``prefill_step`` / ``prefill_finish``), one
prefill chunk per loop iteration between decode dispatches.

Sampling keys are threefry pairs (``engine/prng.py``) derived exactly as
the JAX scheduler derives them, so a seeded request samples the same
tokens on both packages.

Every runner call runs on one dedicated executor thread, never on the
event loop, so device state is mutated by one call at a time and the loop
keeps serving while a dispatch runs.  Decode is double-buffered: chunk k+1
is dispatched before chunk k is read back; each chunk carries a snapshot of
the slots it was dispatched for, and emission checks slot identity against
it, so a slot retired (or retired-and-readmitted) between dispatch and
readback never receives another chunk's tokens.

Megastep (``megastep_k > 0``, runners with ``supports_megastep``): a
full-size decode chunk dispatches K steps as one ``decode_megastep``
flight, and a full-size chunk with a ragged prefill parked as one
``ragged_megastep`` flight, each returning per-slot done-flags beside the
tokens (limits from ``_mega_limits``: each slot's EOS id and remaining
budget).  Smaller chunks keep the per-step path.

The flight plane: each flight is read back in one host transfer (tokens
and done-flags together) and accounted per dispatch class (``plain``,
``megastep``, ``ragged``, ``ragged_mega``): the host gap before it, an
EWMA of its duty cycle and of its duration, the prefill chunks it
carried (``crowdllama_prefill_chunk_seconds``) and its useful and padding
tokens; ``step_token_budget_used`` is set at dispatch.  The self-watchdog
(``wedge_multiplier > 0``) judges the flight in progress against its
class's duration EWMA from a task of its own and, past the threshold,
fails every request with a typed ``error: wedged: ...`` reason and
self-drains once.

Graceful shutdown: ``drain`` rejects new submissions and waits for the
work in flight; ``migrate`` retires every request (active slots, the
chunked admission in progress, deferred and pending requests) with the
terminal reason ``"migrate"`` at the loop's next safe point, between
dispatches, so the gateway re-routes each stream.  Released slots return
their pages through the runner's prefix cache.

The speculation plane (runners of ``engine/spec.py``): a speculative
flight returns the packed ``[K, 2+J, B]`` block (the ``spec`` dispatch
class); retire emits each step's counted tokens, splits the accepted
drafts by source (prompt echo or generative) and feeds the adaptive
controller (``spec_draft_max > 0``): ``_spec_retune`` moves
``draft_len`` between dispatches from a windowed acceptance rate (k = 0
pauses speculation, and after ``spec_probe_interval`` plain steps one
k = 1 probe of one step re-samples acceptance).  A megastep flight runs
only at ``draft_len == 0``; speculative flights run eagerly.  The
gateway-drafted pipeline: a request with a ``DraftFeed``
(``core/spec_pipeline.py``) paces decode on its credits when every live
slot is paced (``_dispatch_paced``: the hosted verify over the gateway's
drafts, or one round of the runner's own program for pure-ack credits),
answers each consumed credit with a ``VERIFY`` payload, nacks stale
chunks without a verify, and releases the stream to full speed after
``spec_pipeline_stall_s`` without credit, a mixed batch or a ragged
prefill.

KV shipping: a request carrying ``kv_import`` (a donor's pages, fetched
by the engine before submit) seeds the runner's prefix index at
admission, before the monolithic / chunked / ragged decision, so imported
pages steer admission exactly as a local prefix hit does; a failed import
falls back to plain prefill.  ``run_exclusive`` runs a donor's export on
the dispatch thread between dispatches.

The autopilot (``engine/autotune.py``): an attached ``AutoTuner`` gets
one ``on_window(cls, duty, emitted, dt)`` sample per retired flight that
emitted tokens, at the end of ``_retire_inflight``, between dispatches,
and moves its dials there; its gauges join ``telemetry_gauges``.  The
``scheduler.ragged_chunk`` fault site fires before each ragged dispatch
(``delay`` stalls it; ``drain`` starts a drain through
``drain_requested_cb``, else ``migrate``, while the chunking goes on).
"""

from __future__ import annotations

import asyncio
import collections
import functools
import logging
import random
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from crowdllama_tpu_torch.engine import prng
from crowdllama_tpu_torch.obs.metrics import ENGINE_TELEMETRY
from crowdllama_tpu_torch.testing import faults

log = logging.getLogger("crowdllama.torch.scheduler")

_DONE = object()
# Remote-draft verify payload marker on a request's out queue: the paired
# value is a dict the engine turns into a VerifyResult frame interleaved
# with the stream's text frames.
_VERIFY = object()
# Slot sentinel: reserved for an in-progress chunked admission — occupied
# (skipped by _free_slot) but carrying no request yet.
_RESERVED = object()


class OverloadedError(RuntimeError):
    """Admission rejected: pending depth crossed the configured threshold.
    The message starts with "overloaded" (the gateway maps it to HTTP 503)."""


class WedgedError(RuntimeError):
    """The dispatch self-watchdog declared the engine wedged: a flight
    stayed in flight far past its dispatch class's duration EWMA.
    Requests failed under it carry a reason starting ``"error: wedged"``,
    which the engine re-raises as this type."""


@dataclass(eq=False)  # identity semantics (slot tracking)
class GenRequest:
    prompt_ids: list[int]
    max_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    repeat_penalty: float = 1.0  # 1 = off
    eos_id: int = -1
    # 0 = unseeded (scheduler RNG); non-zero makes sampling reproducible.
    seed: int = 0
    # queue of (token_id | DONE sentinel, finish_reason)
    out: asyncio.Queue = field(default_factory=asyncio.Queue)
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    cancelled: bool = False  # client went away: drop at admission / free slot
    finished: bool = False
    # Gateway-drafted speculation: the request rides a paced remote-draft
    # stream and ``feed`` is its DraftFeed (one credit consumed per verify
    # round, one VERIFY payload queued back per credit).
    remote_draft: bool = False
    feed: object | None = None
    # A donor's fetched pages (``TorchEngine._fetch_kv_payload``), seeded
    # into the prefix index right before this request's admission.
    kv_import: dict | None = None

    def finish(self, reason: str) -> bool:
        """Claim this request's terminal: exactly one ``(DONE, reason)`` is
        ever queued, whichever path gets here first.  True when this call
        claimed it."""
        if self.finished:
            return False
        self.finished = True
        self.out.put_nowait((_DONE, reason))
        return True


@dataclass
class _SlotInfo:
    req: GenRequest
    prompt_len: int = 0
    generated: int = 0


@dataclass
class _InFlightChunk:
    """A dispatched-but-not-yet-read-back decode chunk."""

    tokens_dev: torch.Tensor            # [K, B] on the device
    snapshot: list                      # slot infos at dispatch time
    dispatched_at: float
    # Prefill chunks that rode this flight (0 = no ragged prefill).
    ragged_steps: int = 0
    # Megastep flights: the per-slot done-flags [K, B] on the device.
    done_dev: torch.Tensor | None = None
    # Paced flights: the (slot, chunk_id) credits consumed; retire answers
    # each with a VERIFY payload of the tokens the slot emitted.
    verify_meta: list | None = None


class Scheduler:
    def __init__(self, runner, max_queue: int = 256, decode_chunk: int = 8,
                 admission_pending_max: int = 0, spec_draft_max: int = 0,
                 ragged: bool = True, megastep_k: int = 0,
                 wedge_multiplier: float = 0.0, clock=time.monotonic):
        self.runner = runner
        self.decode_chunk = max(1, decode_chunk)
        # K steps per megastep flight; 0 (or a runner without
        # supports_megastep) keeps the per-step-chunk path.
        self.megastep_k = max(0, megastep_k)
        self._megastep = (self.megastep_k > 0
                          and getattr(runner, "supports_megastep", False))
        self.admission_pending_max = max(0, admission_pending_max)
        self.slots: list = [None] * runner.max_slots
        self.pending: asyncio.Queue[GenRequest] = asyncio.Queue(max_queue)
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._exec: ThreadPoolExecutor | None = None
        self.state = None
        self._rng = random.Random(time.time_ns())
        self._inflight: _InFlightChunk | None = None
        self._last_retire_at = 0.0
        self._admitting = 0  # popped from pending, not yet in a slot
        # In-progress chunked admission: (req, slot, job), the job a
        # RaggedPrefillJob (``ragged`` marker) or a legacy PrefillJob.
        self._chunking: tuple[GenRequest, int, object] | None = None
        # Long prompts popped while another chunked admission runs (FIFO,
        # ahead of pending).
        self._deferred: collections.deque[GenRequest] = collections.deque()
        self._ragged = ragged and getattr(runner, "supports_ragged", False)
        self.tokens_generated = 0
        self.throughput_ema = 0.0  # tokens/sec across the batch
        self.ragged_chunks = 0  # prefill chunks dispatched unified
        self.host_dispatches = 0  # decode / ragged programs dispatched
        self._tokens_per_dispatch = 0  # tokens the last retired flight emitted
        # Tokens of work the last dispatched step carried (live decode
        # slots + prefill-chunk tokens per step).
        self._step_budget_used = 0.0
        # Per dispatch class: EWMAs of the duty cycle (device window over
        # window + host gap) and of the flight's duration (the watchdog's
        # baseline).
        self._duty: dict[str, float] = {}
        self._flight_ewma: dict[str, float] = {}
        # Self-watchdog: a flight older than wedge_multiplier x its class's
        # duration EWMA (at least wedge_floor_s) marks the engine wedged.
        self.wedge_multiplier = max(0.0, float(wedge_multiplier))
        self._clock = clock
        self.wedge_floor_s = 5.0
        self.wedge_check_interval_s = 0.25
        self.wedged = False
        self.wedged_events = 0
        self._wedge_drain_fired = False
        self._watchdog_task: asyncio.Task | None = None
        # Called once when the watchdog trips (the engine points it at the
        # peer's drain, else its own migrate).
        self.drain_requested_cb = None
        self.prefill_chunks = 0  # legacy chunked-admission chunks run
        self._draining = False  # submissions are refused
        # Set by migrate(): the loop retires everything at its next safe
        # point and resolves the future with the count moved.
        self._migrating: asyncio.Future | None = None
        self._embeds = 0  # embedding forwards in flight (drain waits)
        # Submitted requests whose output queue a consumer may still be
        # reading (drain waits for them to empty).
        self._tracked: weakref.WeakSet[GenRequest] = weakref.WeakSet()
        # run_exclusive calls waiting for the loop's next safe point:
        # (fn, future) pairs.
        self._exclusive: list[tuple] = []
        # Slots retired in _emit whose release waits for the dispatch
        # thread (a runner with ``defer_release``: a multi-process release
        # is a broadcast, which must not leave the event loop's thread
        # while that thread may be broadcasting).
        self._to_release: list[int] = []
        # Steps dispatched per class (a plain flight of K steps counts K),
        # counted at dispatch: the kernels a flight launches are too.
        self.class_steps: dict[str, int] = {}
        # Speculation: verify steps retired (x live slots), tokens they
        # emitted, and the accepted drafts by source.
        self.spec_steps = 0
        self.spec_emitted = 0
        self.spec_accept_echo = 0
        self.spec_accept_gen = 0
        # The acceptance-adaptive draft length (runners with
        # supports_adaptive_draft, spec_draft_max > 0).
        self.spec_draft_max = max(0, spec_draft_max)
        self._spec_adaptive = (
            self.spec_draft_max > 0
            and getattr(runner, "supports_adaptive_draft", False)
            and getattr(runner, "draft_len", 0) > 0)
        self.spec_retunes = 0
        self.spec_probes = 0
        self.spec_shrink_rate = 0.25   # window rate at/below: shrink
        self.spec_grow_rate = 0.8      # window rate at/above: grow
        self.spec_probe_interval = 64  # plain steps between paused probes
        self._accept_acc = 0
        self._accept_off = 0
        self._plain_since_probe = 0
        self._spec_probing = False
        # Gateway-drafted pipeline: the depth hint advertised on every
        # VerifyResult, the stall budget before a creditless stream runs
        # free, and the plane's counters.
        self.spec_pipeline_depth = 8
        self.spec_pipeline_stall_s = 2.0
        self.spec_verifies = 0
        self.spec_stale_chunks = 0
        self.spec_pipeline_freeruns = 0
        # The autopilot (None = off): fed and moved from the retire path.
        self._autotune = None

    # ---------------------------------------------------------------- public

    def attach_autotuner(self, tuner) -> None:
        """Attach the autopilot (``engine/autotune.py``): each retired
        flight that emitted tokens becomes one of its samples, and it
        moves its dials there, between dispatches."""
        self._autotune = tuner

    def _new_executor(self) -> ThreadPoolExecutor:
        dev = self.runner.device

        def _bind():
            # The dispatch thread launches on its own current stream of
            # the runner's device.
            if dev.type == "cuda":
                torch.cuda.set_device(dev)

        return ThreadPoolExecutor(max_workers=1, initializer=_bind,
                                  thread_name_prefix="torch-dispatch")

    def start(self) -> None:
        self._draining = False
        self.wedged = False
        self._wedge_drain_fired = False
        if self._exec is None:
            self._exec = self._new_executor()
        if self.state is None:
            self.state = self.runner.init_state()
        if self._task is None:
            self._task = asyncio.create_task(self._loop(), name="decode-loop")
        if self.wedge_multiplier > 0 and self._watchdog_task is None:
            self._watchdog_task = asyncio.create_task(
                self._watchdog_loop(), name="wedge-watchdog")

    async def stop(self) -> None:
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except asyncio.CancelledError:
                pass
            self._watchdog_task = None
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        while self._exclusive:  # their safe point never comes
            _fn, fut = self._exclusive.pop(0)
            if not fut.done():
                fut.set_exception(RuntimeError("scheduler stopped"))
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None

    async def submit(self, req: GenRequest) -> None:
        if self._draining:
            # Shutting down: reject so the gateway fails over to another
            # worker instead of queueing work this one will not serve.
            raise RuntimeError("worker is draining for shutdown")
        if len(req.prompt_ids) >= self.runner.max_seq:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens exceeds max context "
                f"{self.runner.max_seq}")
        if self.admission_pending_max:
            depth = (self.pending.qsize() + len(self._deferred)
                     + self._admitting)
            if depth >= self.admission_pending_max:
                raise OverloadedError(
                    f"overloaded: {depth} requests pending (admission "
                    f"threshold {self.admission_pending_max})")
        if req.feed is not None:
            # Credits the peer's chunk reader pushes wake a parked loop.
            req.feed._waker = self._wake.set
        await self.pending.put(req)
        self._tracked.add(req)
        self._wake.set()

    def cancel(self, req: GenRequest) -> None:
        """Stop generating for a request whose client went away.  Only
        marks: the loop frees the slot at its next safe point (only the
        loop touches device state)."""
        req.cancelled = True
        self._wake.set()

    @property
    def draining(self) -> bool:
        return self._draining

    async def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new submissions and wait for every admitted and pending
        request to finish; True when drained, False on timeout.  Covers
        the popped-but-not-placed window (``_admitting``), the last
        dispatched chunk, embedding forwards, and output queues a consumer
        is still reading (those of cancelled requests have none)."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while True:
            if (all(s is None for s in self.slots) and self.pending.empty()
                    and self._admitting == 0 and not self._deferred
                    and self._inflight is None and self._embeds == 0
                    and all(r.out.empty() or r.cancelled
                            for r in list(self._tracked))):
                return True
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(0.1)

    async def migrate(self) -> int:
        """Refuse new submissions and retire every request (active slots,
        the chunked admission in progress, deferred and pending requests)
        with ``"migrate"`` at the loop's next safe point; returns how many
        were moved.  A slot whose last token was already emitted keeps its
        own terminal (it was served, not moved).  A wedged engine moves
        nothing: its loop may never reach a safe point, and the watchdog
        already failed every request."""
        self._draining = True
        if self.wedged:
            return 0
        if self._task is None:
            return await self._retire_all("migrate")
        if self._migrating is None:
            self._migrating = asyncio.get_running_loop().create_future()
            self._wake.set()
        return await asyncio.shield(self._migrating)

    async def embed(self, prompts: list[list[int]],
                    batch: int) -> list[list[float]]:
        """The runner's embeddings of ``prompts`` on the dispatch thread,
        one submission per ``batch`` prompts so decode chunks interleave
        with a bulk embed; ``drain`` waits for it."""
        out: list[list[float]] = []
        self._embeds += 1
        try:
            for i in range(0, len(prompts), batch):
                vecs = await self._run(self.runner.embed_prompts,
                                       prompts[i:i + batch])
                out.extend(vecs.tolist())
        finally:
            self._embeds -= 1
        return out

    async def on_dispatch_thread(self, fn, *args):
        """``fn(*args)`` on the dispatch thread, between two of the loop's
        device calls (that thread launches every kernel of this
        scheduler)."""
        if self._exec is None:
            raise RuntimeError("scheduler not started")
        return await self._run(fn, *args)

    async def run_exclusive(self, fn):
        """``fn(state) -> result`` on the dispatch thread at the decode
        loop's next safe point, between two dispatches (at once when the
        loop is not running).  ``fn`` treats the state as read-only: KV
        export (device->host gathers and allocator bookkeeping) qualifies.
        A failing ``fn`` fails its caller, never the loop."""
        if self._task is None:
            return await self._run(fn, self.state)
        fut = asyncio.get_running_loop().create_future()
        self._exclusive.append((fn, fut))
        self._wake.set()
        return await fut

    async def _run_exclusive_fns(self) -> None:
        while self._exclusive:
            fn, fut = self._exclusive.pop(0)
            try:
                res = await self._run(fn, self.state)
            except BaseException as e:
                if not fut.done():
                    fut.set_exception(e)
                if not isinstance(e, Exception):
                    raise
            else:
                if not fut.done():
                    fut.set_result(res)

    async def _apply_kv_import(self, req: GenRequest) -> None:
        """Seed a request's fetched donor pages into the runner's prefix
        index right before its admission.  A failure costs speed, not
        correctness: the request continues with a plain prefill."""
        payload, req.kv_import = req.kv_import, None
        imp = getattr(self.runner, "import_pages", None)
        if payload is None or imp is None:
            return
        try:
            self.state, n = await self._run(imp, self.state, payload)
            if n:
                log.info("kv import: seeded %d fetched pages", n)
        except Exception as e:
            log.warning("kv import failed (%s); falling back to plain "
                        "prefill", e)

    @property
    def load(self) -> float:
        busy = sum(1 for s in self.slots if s is not None)
        return busy / max(1, len(self.slots))

    def telemetry_gauges(self) -> dict:
        """Scheduler gauges for the metrics exposition, under the JAX
        scheduler's keys: queue depth, batch occupancy, KV-cache
        utilization (paged: the page pool's occupancy, cached prefix pages
        included; contiguous: tokens held over capacity), the chunked
        admission in progress, the token budget the last dispatched step
        carried, dispatches and the tokens of the last retired flight, the
        duty cycle per dispatch class, the self-watchdog's level and
        trips, the remote-draft pipeline's plane, and on a speculative
        runner the verify steps, emitted and accepted tokens and the live
        draft length; the autopilot's when one is attached (the engine
        zero-fills them otherwise)."""
        active = sum(1 for s in self.slots if isinstance(s, _SlotInfo))
        total = max(1, len(self.slots))
        r = self.runner
        free_pages = getattr(r, "_free_pages", None)
        if getattr(r, "total_pages", 0) and free_pages is not None:
            util = 1.0 - len(free_pages) / r.total_pages
        else:
            used = sum(s.prompt_len + s.generated for s in self.slots
                       if isinstance(s, _SlotInfo))
            util = used / (total * max(1, r.max_seq))
        g = {
            "pending_depth": float(self.pending.qsize() + len(self._deferred)
                                   + self._admitting),
            "active_slots": float(active),
            "batch_occupancy": active / total,
            "kv_cache_utilization": util,
            "prefill_chunk_slots": 1.0 if self._chunking is not None else 0.0,
            "step_token_budget_used": float(self._step_budget_used),
            "host_dispatches_total": float(self.host_dispatches),
            "tokens_per_dispatch": float(self._tokens_per_dispatch),
            "wedged": 1.0 if self.wedged else 0.0,
            "wedged_events_total": float(self.wedged_events),
            "spec_pipeline_depth": float(self.spec_pipeline_depth),
            "spec_pipeline_verifies": float(self.spec_verifies),
            "spec_pipeline_stale": float(self.spec_stale_chunks),
            "spec_pipeline_freeruns": float(self.spec_pipeline_freeruns),
        }
        for cls in ("plain", "megastep", "ragged", "ragged_mega", "spec"):
            g[f"duty_cycle|dispatch={cls}"] = float(self._duty.get(cls, 0.0))
        if self._autotune is not None:
            g.update(self._autotune.gauges())
        if hasattr(r, "draft_len"):
            g.update(spec_steps=float(self.spec_steps),
                     spec_emitted=float(self.spec_emitted),
                     spec_accept_echo=float(self.spec_accept_echo),
                     spec_accept_gen=float(self.spec_accept_gen),
                     spec_draft_len=float(r.draft_len))
        return g

    # --------------------------------------------- dispatch self-watchdog

    @staticmethod
    def _flight_class(fl: _InFlightChunk) -> str:
        """Dispatch class of a flight, from host-side metadata only (the
        watchdog must not touch the device a hung flight holds)."""
        if fl.done_dev is not None:
            return "ragged_mega" if fl.ragged_steps else "megastep"
        if fl.ragged_steps:
            return "ragged"
        return "spec" if getattr(fl.tokens_dev, "ndim", 2) == 3 else "plain"

    def check_wedged(self, now: float | None = None) -> bool:
        """One watchdog probe: has the flight in progress outlived its
        class's threshold, ``max(wedge_floor_s, wedge_multiplier x the
        class's flight-duration EWMA)``?  Pure host arithmetic on the
        injected clock.  A class with no retired flight is never judged
        (its first flight holds the megastep graph's capture).
        Idempotent once tripped."""
        if self.wedged:
            return True
        fl = self._inflight
        if self.wedge_multiplier <= 0 or fl is None:
            return False
        cls = self._flight_class(fl)
        ewma = self._flight_ewma.get(cls)
        if ewma is None:
            return False
        if now is None:
            now = self._clock()
        age = now - fl.dispatched_at
        threshold = max(self.wedge_floor_s, self.wedge_multiplier * ewma)
        if age <= threshold:
            return False
        self._declare_wedged(cls, age, threshold)
        return True

    def _declare_wedged(self, cls: str, age: float,
                        threshold: float) -> None:
        """Fail every request a terminal can still reach with the typed
        ``error: wedged`` reason, refuse new submissions, resolve a waiting
        ``migrate`` with 0, and start one self-drain through
        ``drain_requested_cb``.  Touches no device state: the dispatch
        thread may be stuck in the hung flight."""
        self.wedged = True
        self.wedged_events += 1
        self._draining = True
        reason = (f"error: wedged: {cls} flight stuck for {age:.1f}s "
                  f"(threshold {threshold:.1f}s = "
                  f"{self.wedge_multiplier:g}x class EWMA)")
        log.error("dispatch self-watchdog: %s; failing in-flight requests "
                  "and self-draining", reason[len("error: "):])
        if self._chunking is not None:
            self._chunking[0].finish(reason)
        for info in self.slots:
            if isinstance(info, _SlotInfo):
                info.req.finish(reason)
        while self._deferred:
            self._deferred.popleft().finish(reason)
        while not self.pending.empty():
            self.pending.get_nowait().finish(reason)
        if self._migrating is not None:
            fut, self._migrating = self._migrating, None
            if not fut.done():
                fut.set_result(0)
        if self.drain_requested_cb is not None \
                and not self._wedge_drain_fired:
            self._wedge_drain_fired = True
            try:
                self.drain_requested_cb()
            except Exception:
                log.exception("wedge self-drain callback failed")

    async def _watchdog_loop(self) -> None:
        """A task apart from the decode loop: a wedged flight parks the
        loop in its executor await, so only another task still runs."""
        while not self.wedged:
            await asyncio.sleep(self.wedge_check_interval_s)
            try:
                self.check_wedged()
            except Exception:
                log.exception("wedge watchdog probe failed")

    # ------------------------------------------------------------------ loop

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _req_key(self, req: GenRequest, lane: int) -> np.ndarray:
        """Threefry key [2] uint32 for one sampling lane of a request (0 =
        the prompt's first token, 1 = the slot's decode stream).  A seed
        reduces to uint64; its low 31 bits make the key and the words
        above fold in, then the lane folds in, as the JAX scheduler does,
        so a seeded request draws the same tokens on both packages.
        Unseeded requests draw from the scheduler's host RNG."""
        if req.seed:
            seed = req.seed & 0xFFFFFFFFFFFFFFFF
            key = prng.PRNGKey(seed & 0x7FFFFFFF)
            hi = seed >> 31
            if hi:
                key = prng.fold_in(key, hi & 0xFFFFFFFF)
                if hi >> 32:
                    key = prng.fold_in(key, hi >> 32)
            return prng.fold_in(key, lane)
        return np.array([self._rng.getrandbits(32), self._rng.getrandbits(32)],
                        np.uint32)

    async def _run(self, fn, *args, **kwargs):
        return await asyncio.get_running_loop().run_in_executor(
            self._exec, functools.partial(fn, *args, **kwargs))

    async def _admit_one(self, req: GenRequest, slot: int) -> None:
        req.admitted_at = time.monotonic()
        first, ks, vs, plen = await self._run(
            self.runner.prefill, req.prompt_ids, req.temperature, req.top_p,
            self._req_key(req, 0), state=self.state, top_k=req.top_k,
            repeat_penalty=req.repeat_penalty)
        await self._insert_place(req, slot, ks, vs, plen, first)

    async def _insert_place(self, req: GenRequest, slot: int, ks, vs,
                            plen: int, first: int) -> None:
        """Insert a prefilled request into its slot and emit its first
        token (monolithic and legacy chunked admission)."""
        self.state = await self._run(
            self.runner.insert, self.state, slot, ks, vs, plen, first,
            req.temperature, req.top_p, prompt_tokens=req.prompt_ids,
            slot_key=self._req_key(req, 1), top_k=req.top_k,
            repeat_penalty=req.repeat_penalty)
        self._place(req, slot, plen, first)
        await self._flush_releases()

    def _place(self, req: GenRequest, slot: int, plen: int,
               first: int) -> None:
        info = _SlotInfo(req=req, prompt_len=plen)
        self.slots[slot] = info
        req.first_token_at = time.monotonic()
        self._emit(req, first, info)

    def _emit(self, req: GenRequest, token: int, info: _SlotInfo) -> None:
        info.generated += 1
        self.tokens_generated += 1
        req.out.put_nowait((token, ""))
        # Retire on EOS, request budget, or context exhaustion (the slot is
        # full; decoding further would overwrite the last position).
        out_of_context = (info.prompt_len + info.generated
                          >= self.runner.max_seq - 1)
        if (token == req.eos_id or info.generated >= req.max_tokens
                or out_of_context):
            req.finish("stop" if token == req.eos_id else "length")
            slot = self.slots.index(info)
            self.slots[slot] = None
            if getattr(self.runner, "defer_release", False):
                # Every emit site flushes before the slot can be reused.
                self._to_release.append(slot)
            else:
                # Runs between dispatches on the loop; the release is host
                # bookkeeping plus tiny device writes queued in order.
                self.state = self.runner.release(self.state, slot)

    def _chunk_size(self) -> int:
        """Steps per dispatch: 1 while an admittable request waits
        (admission latency beats amortization) or a paused speculation
        probes, else decode_chunk."""
        if self._spec_probing:
            return 1
        if self._free_slot() is None:
            return self.decode_chunk
        if not self.pending.empty() or self._deferred:
            return 1
        return self.decode_chunk

    def _mega_limits(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-slot EOS ids and remaining token budgets [B] int32 for a
        megastep flight, from host bookkeeping: the flags fire where
        ``_emit`` would retire the slot (the same EOS compare; the budget
        is the lesser of the request's and the context's headroom)."""
        b = len(self.slots)
        eos = np.full((b,), -1, np.int32)
        budgets = np.zeros((b,), np.int32)
        for i, info in enumerate(self.slots):
            if not isinstance(info, _SlotInfo):
                continue
            req = info.req
            if req.eos_id is not None and req.eos_id >= 0:
                eos[i] = req.eos_id
            budgets[i] = max(0, min(
                req.max_tokens - info.generated,
                (self.runner.max_seq - 1) - info.prompt_len - info.generated))
        return eos, budgets

    def _spec_retune(self, accepted: int, offered: int) -> None:
        """Fold one retired flight's acceptance into the window; retune
        draft_len once the window holds 2k offered drafts: halve at a rate
        <= spec_shrink_rate (k = 0 pauses), one up toward spec_draft_max at
        >= spec_grow_rate.  Runs between dispatches (retire)."""
        self._accept_acc += accepted
        self._accept_off += offered
        k = getattr(self.runner, "draft_len", 0)
        if self._accept_off < 2 * max(1, k):
            return
        rate = self._accept_acc / max(1, self._accept_off)
        new_k = k
        if rate <= self.spec_shrink_rate:
            new_k = k // 2
        elif rate >= self.spec_grow_rate and k < self.spec_draft_max:
            new_k = k + 1
        self._accept_acc = self._accept_off = 0
        self._spec_probing = False
        if new_k != k:
            self.runner.set_draft_len(new_k)
            self.spec_retunes += 1
            if new_k == 0:
                self._plain_since_probe = 0
            log.info("spec retune: draft_len %d -> %d (window rate %.2f)",
                     k, new_k, rate)

    def _spec_probe_tick(self, steps: int) -> None:
        """A paused controller counts plain steps; after
        spec_probe_interval of them it arms ONE k=1 probe (one step, via
        ``_chunk_size``) whose acceptance ``_spec_retune`` then reads."""
        self._plain_since_probe += steps
        if (not self._spec_probing
                and self._plain_since_probe >= self.spec_probe_interval):
            self._plain_since_probe = 0
            self._spec_probing = True
            self.spec_probes += 1
            self.runner.set_draft_len(1)

    # ----------------------------------- gateway-drafted pipeline pacing

    def _paced_slots(self, rjob) -> list:
        """Live slots pacing on remote-draft credits, after the release
        rules: a closed and drained feed, a mixed batch (an unpaced live
        slot) or a ragged prefill in flight sets ``free_run``.  Pacing is
        exact only when every live slot is paced."""
        paced, live = [], 0
        for i, info in enumerate(self.slots):
            if not isinstance(info, _SlotInfo):
                continue
            live += 1
            feed = info.req.feed
            if feed is None or feed.free_run:
                continue
            if feed.closed and not feed.chunks:
                feed.free_run = True  # the gateway hung up: finish at speed
                continue
            paced.append((i, info))
        if paced and (rjob is not None or len(paced) != live):
            for _i, info in paced:
                info.req.feed.free_run = True
                self.spec_pipeline_freeruns += 1
            return []
        return paced

    async def _dispatch_paced(self, paced) -> _InFlightChunk | None:
        """One pipeline round: one credit per paced feed (stale draft
        chunks nacked at once), then ONE verify round: the hosted verify
        over the gateway's drafts when a credit carried tokens, else one
        step of the runner's own program.  Creditless feeds park the loop
        until credit arrives or the stall budget frees the stream.  None
        when nothing was dispatched."""
        if self._inflight is not None:
            # Per-slot counts are pre-retire until the previous round
            # retires: consume credits next iteration.
            return None
        now = time.monotonic()
        ready, park = True, self.spec_pipeline_stall_s
        for _i, info in paced:
            feed = info.req.feed
            if feed.chunks:
                feed.stalled_at = 0.0
                continue
            if not feed.stalled_at:
                feed.stalled_at = now
            waited = now - feed.stalled_at
            if waited >= self.spec_pipeline_stall_s:
                feed.free_run = True
                self.spec_pipeline_freeruns += 1
                log.warning("spec pipeline stall: releasing paced stream "
                            "to full speed after %.1fs without credit",
                            waited)
            else:
                ready = False
                park = min(park, self.spec_pipeline_stall_s - waited)
        if any(info.req.feed.free_run for _i, info in paced):
            return None  # released: the next iteration dispatches normally
        if not ready:
            if (self.pending.empty() and not self._deferred
                    and not self._exclusive
                    and self._migrating is None and self._chunking is None):
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=max(0.01, park))
                except asyncio.TimeoutError:
                    pass
            return None
        kmax = int(getattr(self.runner, "draft_len", 0))
        meta: list[tuple[int, int]] = []
        token_chunks: dict[int, list[int]] = {}
        for i, info in paced:
            feed = info.req.feed
            credit = None
            while feed.chunks:
                cid, pos, toks = feed.chunks.popleft()
                if toks and (kmax <= 0 or pos != info.generated):
                    # Drafted from a superseded prefix, or the runner
                    # paused drafting: nack without a verify forward.
                    self.spec_stale_chunks += 1
                    self.spec_verifies += 1
                    info.req.out.put_nowait((_VERIFY, {
                        "chunk_id": cid, "position": info.generated,
                        "accepted": 0, "tokens": []}))
                    continue
                credit = (cid, toks)
                break
            if credit is None:
                continue  # the stale flush ate every queued credit
            cid, toks = credit
            meta.append((i, cid))
            if toks:
                token_chunks[i] = toks
        if not meta:
            return None
        if token_chunks:
            kk = min(max(len(t) for t in token_chunks.values()), kmax)
            drafts = np.full((len(self.slots), kk), -1, np.int32)
            for i, toks in token_chunks.items():
                t = toks[:kk]
                drafts[i, :len(t)] = t
            tokens_dev, self.state = await self._run(
                self.runner.decode_steps_hosted, self.state, drafts)
        else:
            tokens_dev, self.state = await self._run(
                self.runner.decode_steps_device, self.state, 1)
        self._step_budget_used = float(len(meta))
        self.host_dispatches += 1
        return _InFlightChunk(tokens_dev=tokens_dev,
                              snapshot=list(self.slots),
                              dispatched_at=self._clock(), verify_meta=meta)

    def _fail_all(self, reason: str) -> None:
        if self._chunking is not None:
            req, _, _ = self._chunking
            self._chunking = None
            self._admitting -= 1
            req.finish(reason)
        for i, info in enumerate(self.slots):
            if isinstance(info, _SlotInfo):
                info.req.finish(reason)
            self.slots[i] = None
        while self._deferred:
            self._deferred.popleft().finish(reason)
        while not self.pending.empty():
            self.pending.get_nowait().finish(reason)
        if self._migrating is not None:
            # Everything was failed above: nothing left to move.
            fut, self._migrating = self._migrating, None
            if not fut.done():
                fut.set_result(0)

    async def _retire_all(self, reason: str) -> int:
        """Finish every request with ``reason`` (between dispatches): the
        chunked admission in progress (its pages freed), active slots
        (released), deferred and pending requests.  Returns how many this
        call finished."""
        moved = 0
        if self._chunking is not None:
            req = self._chunking[0]
            await self._abort_chunking()
            moved += req.finish(reason)
        for i, info in enumerate(self.slots):
            if isinstance(info, _SlotInfo):
                self.slots[i] = None
                self.state = await self._run(self.runner.release, self.state,
                                             i)
                moved += info.req.finish(reason)
        while self._deferred:
            moved += self._deferred.popleft().finish(reason)
        while not self.pending.empty():
            moved += self.pending.get_nowait().finish(reason)
        return moved

    async def _loop(self) -> None:
        while True:
            try:
                await self._loop_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # A failed dispatch must not silently kill serving: fail
                # every in-flight request, reset device state, keep going.
                log.exception("decode loop error; failing in-flight requests")
                self._inflight = None
                self._fail_all("error: engine failure")
                self._to_release.clear()  # init_state replaces it all
                self.state = await self._run(self.runner.init_state)

    async def _abort_chunking(self) -> None:
        req, slot, job = self._chunking
        self._chunking = None
        self._admitting -= 1
        self.slots[slot] = None  # release the reservation
        if getattr(job, "ragged", False):  # a legacy job holds no pages
            await self._run(self.runner.ragged_abort, job)
        elif getattr(self.runner, "prefill_abort", None) is not None:
            # Multi-process: followers drop the job's accumulators.
            await self._run(self.runner.prefill_abort, job)

    async def _flush_releases(self) -> None:
        """The releases ``_emit`` deferred, on the dispatch thread."""
        while self._to_release:
            slot = self._to_release.pop(0)
            self.state = await self._run(self.runner.release, self.state,
                                         slot)

    async def _loop_once(self) -> None:
        await self._flush_releases()
        if (all(s is None for s in self.slots) and self.pending.empty()
                and self._inflight is None and self._chunking is None
                and not self._deferred and not self._exclusive
                and self._migrating is None):
            self._wake.clear()
            await self._wake.wait()

        # Free cancelled slots — only the loop touches device state.
        for i, info in enumerate(self.slots):
            if isinstance(info, _SlotInfo) and info.req.cancelled:
                self.slots[i] = None
                self.state = await self._run(self.runner.release, self.state,
                                             i)
        if self._chunking is not None and self._chunking[0].cancelled:
            await self._abort_chunking()

        # migrate(): retire everything at this safe point.  Slots clear
        # before the in-flight chunk is read back, so its tokens are
        # dropped by the identity check (the successor replays decode).
        if self._migrating is not None:
            fut = self._migrating
            moved = await self._retire_all("migrate")
            self._migrating = None
            if not fut.done():
                fut.set_result(moved)

        # run_exclusive: nothing is queued on the dispatch thread now.
        await self._run_exclusive_fns()

        # Dispatch the NEXT chunk before reading back the previous one, so
        # the readback + emit below overlap this chunk's compute.
        dispatched: _InFlightChunk | None = None
        rjob = (self._chunking if self._chunking is not None
                and getattr(self._chunking[2], "ragged", False) else None)
        live = sum(1 for s in self.slots if isinstance(s, _SlotInfo))
        if rjob is not None or live:
            # When every live slot rides a remote-draft stream, decode
            # advances one verify round per wire credit.
            paced = self._paced_slots(rjob)
            k = 1 if paced else self._chunk_size()
            # Only full-size chunks become megasteps (a size-1 dispatch
            # keeps its admission-latency purpose), and a plain decode
            # chunk only while speculation is paused (draft_len 0):
            # speculative flights run eagerly.  Deciding before
            # pre_decode_check sizes page growth for the real step count.
            use_mega = (self._megastep and k == self.decode_chunk
                        and (rjob is not None
                             or (not paced and getattr(self.runner,
                                                       "draft_len", 0) == 0)))
            if use_mega:
                k = self.megastep_k
            # Slots an overcommitted pool cannot grow finish with "length"
            # (their pages free on release), one at a time.
            starved = await self._run(self.runner.pre_decode_check, k)
            if starved and self._inflight is not None:
                await self._retire_inflight()
                starved = await self._run(self.runner.pre_decode_check, k)
            while starved:
                slot = starved[0]
                info = self.slots[slot]
                if isinstance(info, _SlotInfo):
                    log.warning("kv pool exhausted: finishing slot %d early",
                                slot)
                    info.req.finish("length")
                    self.slots[slot] = None
                self.state = await self._run(self.runner.release, self.state,
                                             slot)
                starved = await self._run(self.runner.pre_decode_check, k)
            live = sum(1 for s in self.slots if isinstance(s, _SlotInfo))
            if rjob is not None:
                dispatched = await self._ragged_dispatch(k, use_mega, live)
            elif paced:
                dispatched = await self._dispatch_paced(paced)
            elif live:
                done_dev = None
                if use_mega:
                    eos_ids, budgets = self._mega_limits()
                    tokens_dev, done_dev, self.state = await self._run(
                        self.runner.decode_megastep, self.state, k,
                        eos_ids=eos_ids, budgets=budgets)
                else:
                    tokens_dev, self.state = await self._run(
                        self.runner.decode_steps_device, self.state, k)
                self._step_budget_used = float(live)
                self.host_dispatches += 1
                dispatched = _InFlightChunk(
                    tokens_dev=tokens_dev, snapshot=list(self.slots),
                    dispatched_at=self._clock(), done_dev=done_dev)

        # Advance a legacy chunked admission by ONE prefill chunk (ragged
        # jobs advanced inside the dispatch above).
        if self._chunking is not None and rjob is None:
            await self._prefill_chunk_step()

        await self._admit_pending()

        # Retire the PREVIOUS chunk (readback overlaps the new dispatch).
        await self._retire_inflight()
        if dispatched is not None:
            cls = self._flight_class(dispatched)
            self.class_steps[cls] = (self.class_steps.get(cls, 0)
                                     + dispatched.tokens_dev.shape[0])
        self._inflight = dispatched
        await asyncio.sleep(0)  # let submitters/streamers run

    async def _ragged_dispatch(self, k: int, mega: bool,
                               live: int) -> _InFlightChunk | None:
        """Advance the parked ragged admission inside this decode dispatch
        (``mega``: one ``ragged_megastep`` flight of ``k`` steps with
        done-flags, else ``ragged_step``); on its last chunk sample its
        first token and activate its slot."""
        req, slot, job = self._chunking
        c = self.runner.ragged_chunk
        chunk_toks = min(k * c, len(job.prompt_ids) - job.done_tokens)
        n_chunks = -(-chunk_toks // max(1, c))
        done_dev = None
        try:
            await faults.inject("scheduler.ragged_chunk",
                                done=job.done_tokens,
                                total=len(job.prompt_ids))
        except faults.DrainRequested:
            # A drain mid-chunked-prefill: started beside the loop, which
            # keeps chunking until migrate() retires the job at its next
            # safe point (completed pages stay prefix-cached).
            if self.drain_requested_cb is not None:
                self.drain_requested_cb()
            else:
                asyncio.get_running_loop().create_task(self.migrate())
        try:
            if mega:
                eos_ids, budgets = self._mega_limits()
                tokens_dev, done_dev, self.state = await self._run(
                    self.runner.ragged_megastep, self.state, job, k,
                    eos_ids=eos_ids, budgets=budgets)
            else:
                tokens_dev, self.state = await self._run(
                    self.runner.ragged_step, self.state, job, k)
        except ValueError as e:
            # Pool cannot cover the job's next pages (PagesExhausted):
            # fail THIS request, the engine stays up.
            await self._abort_chunking()
            log.warning("ragged admit failed: %s", e)
            req.finish(f"error: {e}")
            return None
        self.ragged_chunks += n_chunks
        self._step_budget_used = float(live + chunk_toks / max(1, k))
        self.host_dispatches += 1
        dispatched = _InFlightChunk(
            tokens_dev=tokens_dev, snapshot=list(self.slots),
            dispatched_at=self._clock(), ragged_steps=n_chunks,
            done_dev=done_dev)
        if job.finished:
            self._chunking = None
            self._admitting -= 1
            try:
                first, self.state = await self._run(
                    self.runner.ragged_finish, self.state, job,
                    req.temperature, req.top_p, self._req_key(req, 0),
                    slot_key=self._req_key(req, 1), top_k=req.top_k,
                    repeat_penalty=req.repeat_penalty)
            except BaseException:
                self.slots[slot] = None
                req.finish("error: engine failure")
                raise
            self._place(req, slot, len(req.prompt_ids), first)
            await self._flush_releases()
        return dispatched

    async def _prefill_chunk_step(self) -> None:
        """Run one chunk of the parked legacy admission; on its last chunk
        sample the first token, insert and activate its slot."""
        req, slot, job = self._chunking
        try:
            done = await self._run(self.runner.prefill_step, job)
            self.prefill_chunks += 1
            if done:
                self._chunking = None
                first, ks, vs, plen = await self._run(
                    self.runner.prefill_finish, job, req.temperature,
                    req.top_p, self._req_key(req, 0), top_k=req.top_k,
                    repeat_penalty=req.repeat_penalty)
                await self._insert_place(req, slot, ks, vs, plen, first)
        except ValueError as e:
            # Bad request or pool exhaustion at insert (PagesExhausted):
            # fail THIS request, the engine stays up.
            self._chunking = None
            self.slots[slot] = None
            log.warning("chunked admit failed: %s", e)
            req.finish(f"error: {e}")
        except BaseException:
            self._chunking = None
            self.slots[slot] = None
            req.finish("error: engine failure")
            raise
        finally:
            if self._chunking is None:
                self._admitting -= 1

    async def _admit_pending(self) -> None:
        """Admit waiting requests into free slots; at most one monolithic
        prefill per iteration once more than one slot decodes, so a burst
        of prompts interleaves with decode chunks."""
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            if self._deferred and self._chunking is None:
                req = self._deferred.popleft()
            elif not self.pending.empty():
                req = self.pending.get_nowait()
            else:
                break
            if req.cancelled:
                continue
            if req.kv_import is not None:
                # Before the monolithic-vs-chunked decision: imported pages
                # steer it as a local prefix hit does.
                await self._apply_kv_import(req)
            chunk = (self.runner.ragged_chunk if self._ragged
                     else self.runner.prefill_chunk)
            hint = getattr(self.runner, "prefill_prefers_monolithic", None)
            if (chunk and len(req.prompt_ids) > chunk
                    and not (hint is not None
                             and hint(req.prompt_ids, chunk=chunk))):
                if self._chunking is not None:
                    self._deferred.append(req)
                    continue
                req.admitted_at = time.monotonic()
                try:
                    if self._ragged:
                        job = await self._run(self.runner.ragged_begin,
                                              req.prompt_ids, slot,
                                              state=self.state)
                    else:
                        job = await self._run(self.runner.prefill_begin,
                                              req.prompt_ids,
                                              state=self.state)
                except ValueError as e:
                    log.warning("admit failed: %s", e)
                    req.finish(f"error: {e}")
                    continue
                except BaseException:
                    req.finish("error: engine failure")
                    raise
                self._admitting += 1
                self._chunking = (req, slot, job)
                self.slots[slot] = _RESERVED
                continue
            self._admitting += 1
            try:
                await self._admit_one(req, slot)
            except ValueError as e:  # bad request (too long, pool full)
                log.warning("admit failed: %s", e)
                req.finish(f"error: {e}")
                continue
            except BaseException:
                req.finish("error: engine failure")
                raise
            finally:
                self._admitting -= 1
            if sum(1 for s in self.slots if isinstance(s, _SlotInfo)) > 1:
                break

    async def _retire_inflight(self) -> None:
        """Read back and emit the in-flight chunk, if any, and account it
        in the flight plane."""
        if self._inflight is None:
            return
        fl, self._inflight = self._inflight, None
        # One host transfer per flight: the done-flags ride with the tokens.
        if fl.done_dev is None:
            packed = await self._run(lambda t: t.cpu().numpy(), fl.tokens_dev)
            tokens, done = packed, None
        else:
            packed = await self._run(
                lambda t, d: torch.stack([t, d.to(t.dtype)]).cpu().numpy(),
                fl.tokens_dev, fl.done_dev)
            tokens, done = packed[0], packed[1].astype(bool)
        now = self._clock()
        dt = max(now - max(self._last_retire_at, fl.dispatched_at), 1e-6)
        # Host gap: the stretch after the previous flight retired with
        # nothing queued on the device (zero when this flight was
        # dispatched before that retire, the pipelined steady state).
        gap = (max(0.0, fl.dispatched_at - self._last_retire_at)
               if self._last_retire_at else 0.0)
        cls = self._flight_class(fl)
        ENGINE_TELEMETRY.host_gap_seconds.labels(cls).observe(gap)
        duty = dt / max(dt + gap, 1e-9)
        prev = self._duty.get(cls)
        self._duty[cls] = duty if prev is None else 0.9 * prev + 0.1 * duty
        # The watchdog's baseline: the wall time spent waiting on flights
        # of this class.
        e = self._flight_ewma.get(cls)
        self._flight_ewma[cls] = dt if e is None else 0.9 * e + 0.1 * dt
        self._last_retire_at = now
        if fl.ragged_steps:
            # The flight's chunks ran back to back: share its wall time.
            per = max(now - fl.dispatched_at, 1e-6) / fl.ragged_steps
            for _ in range(fl.ragged_steps):
                ENGINE_TELEMETRY.prefill_chunk_seconds.observe(per)
        # Every step runs the whole batch: slots empty at dispatch computed
        # throwaway rows.  A megastep flight counts only the steps before
        # its whole-batch exit (a fused ragged flight at least its chunks).
        live_cols = np.array([isinstance(s, _SlotInfo) for s in fl.snapshot],
                             bool)
        live = int(live_cols.sum())
        steps_run = tokens.shape[0]
        if done is not None and live_cols.any() \
                and done[:, live_cols].any(axis=0).all():
            steps_run = int(done[:, live_cols].argmax(axis=0).max()) + 1
            if fl.ragged_steps:
                steps_run = max(steps_run, fl.ragged_steps)
        ENGINE_TELEMETRY.padding_inc(
            useful=live * steps_run,
            waste=max(0, tokens.shape[-1] - live) * steps_run)
        emitted = self._emit_flight(fl, tokens)
        await self._flush_releases()
        self._tokens_per_dispatch = emitted
        if emitted == 0:
            return  # pure-overshoot chunk: not a sample
        rate = emitted / dt
        self.throughput_ema = (rate if self.throughput_ema == 0.0
                               else 0.9 * self.throughput_ema + 0.1 * rate)
        if self._autotune is not None:
            # Between dispatches: a dial it moves shapes the next flight.
            self._autotune.on_window(cls, self._duty.get(cls, 0.0), emitted,
                                     dt)

    def _emit_flight(self, fl: _InFlightChunk, tokens: np.ndarray) -> int:
        """Emit a read-back flight's tokens to the slots still owned by the
        request they were dispatched for; returns how many.  A packed
        speculative block [K, 2+J, B] emits each step's counted tokens,
        splits the accepted drafts by source, feeds the adaptive
        controller, and answers the flight's consumed credits with VERIFY
        payloads; a plain flight on a paused controller counts toward the
        next probe."""
        emitted = acc = off = 0
        spec = tokens.ndim == 3
        # k at dispatch, from the block's shape: a retune may have
        # happened since.
        k_dispatch = tokens.shape[1] - 3 if spec else 0
        verify_tok: dict[int, list[int]] = {}
        for step in range(tokens.shape[0]):
            for i, info in enumerate(fl.snapshot):
                if not isinstance(info, _SlotInfo) or self.slots[i] is not info:
                    continue
                row = (tokens[step, 1:1 + int(tokens[step, 0, i]), i] if spec
                       else tokens[step, i:i + 1])
                n = 0
                for tok in row:
                    if self.slots[i] is not info:  # retired mid-step
                        break
                    self._emit(info.req, int(tok), info)
                    if fl.verify_meta is not None:
                        verify_tok.setdefault(i, []).append(int(tok))
                    n += 1
                emitted += n
                if spec and n >= 1:
                    if n > 1:
                        if int(tokens[step, -1, i]) == 1:
                            self.spec_accept_echo += n - 1
                        else:
                            self.spec_accept_gen += n - 1
                    acc += n - 1
                    off += k_dispatch
        if spec:
            self.spec_steps += tokens.shape[0] * max(
                1, sum(1 for s in fl.snapshot if isinstance(s, _SlotInfo)))
            self.spec_emitted += emitted
            if self._spec_adaptive and off:
                self._spec_retune(acc, off)
        elif (self._spec_adaptive
              and getattr(self.runner, "draft_len", -1) == 0):
            self._spec_probe_tick(tokens.shape[0])
        for slot, chunk_id in fl.verify_meta or ():
            # One VerifyResult per consumed credit (a slot retired in the
            # round answers too, so the gateway's window drains).
            info = fl.snapshot[slot]
            toks = verify_tok.get(slot, [])
            self.spec_verifies += 1
            info.req.out.put_nowait((_VERIFY, {
                "chunk_id": chunk_id, "position": info.generated,
                "accepted": max(0, len(toks) - 1), "tokens": toks}))
        return emitted


DONE = _DONE
VERIFY = _VERIFY
