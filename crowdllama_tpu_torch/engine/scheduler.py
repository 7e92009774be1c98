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

Graceful shutdown: ``drain`` rejects new submissions and waits for the
work in flight; ``migrate`` retires every request (active slots, the
chunked admission in progress, deferred and pending requests) with the
terminal reason ``"migrate"`` at the loop's next safe point, between
dispatches, so the gateway re-routes each stream.  Released slots return
their pages through the runner's prefix cache.

Not ported yet: speculation, megastep, the autopilot, the dispatch
watchdog, KV import and the fault-injection hooks.
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

log = logging.getLogger("crowdllama.torch.scheduler")

_DONE = object()
# Slot sentinel: reserved for an in-progress chunked admission — occupied
# (skipped by _free_slot) but carrying no request yet.
_RESERVED = object()


class OverloadedError(RuntimeError):
    """Admission rejected: pending depth crossed the configured threshold.
    The message starts with "overloaded" (the gateway maps it to HTTP 503)."""


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


class Scheduler:
    def __init__(self, runner, max_queue: int = 256, decode_chunk: int = 8,
                 admission_pending_max: int = 0, ragged: bool = True):
        self.runner = runner
        self.decode_chunk = max(1, decode_chunk)
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
        self.prefill_chunks = 0  # legacy chunked-admission chunks run
        self._draining = False  # submissions are refused
        # Set by migrate(): the loop retires everything at its next safe
        # point and resolves the future with the count moved.
        self._migrating: asyncio.Future | None = None
        self._embeds = 0  # embedding forwards in flight (drain waits)
        # Submitted requests whose output queue a consumer may still be
        # reading (drain waits for them to empty).
        self._tracked: weakref.WeakSet[GenRequest] = weakref.WeakSet()

    # ---------------------------------------------------------------- public

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
        if self._exec is None:
            self._exec = self._new_executor()
        if self.state is None:
            self.state = self.runner.init_state()
        if self._task is None:
            self._task = asyncio.create_task(self._loop(), name="decode-loop")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
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
        own terminal (it was served, not moved)."""
        self._draining = True
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

    @property
    def load(self) -> float:
        busy = sum(1 for s in self.slots if s is not None)
        return busy / max(1, len(self.slots))

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
            # Runs between dispatches on the loop; the release itself is
            # host bookkeeping plus tiny device writes queued in order.
            self.state = self.runner.release(self.state, slot)

    def _chunk_size(self) -> int:
        """Steps per dispatch: 1 while an admittable request waits
        (admission latency beats amortization), else decode_chunk."""
        if self._free_slot() is None:
            return self.decode_chunk
        if not self.pending.empty() or self._deferred:
            return 1
        return self.decode_chunk

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
                self.state = await self._run(self.runner.init_state)

    async def _abort_chunking(self) -> None:
        req, slot, job = self._chunking
        self._chunking = None
        self._admitting -= 1
        self.slots[slot] = None  # release the reservation
        if getattr(job, "ragged", False):  # a legacy job holds no pages
            await self._run(self.runner.ragged_abort, job)

    async def _loop_once(self) -> None:
        if (all(s is None for s in self.slots) and self.pending.empty()
                and self._inflight is None and self._chunking is None
                and not self._deferred and self._migrating is None):
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

        # Dispatch the NEXT chunk before reading back the previous one, so
        # the readback + emit below overlap this chunk's compute.
        dispatched: _InFlightChunk | None = None
        rjob = (self._chunking if self._chunking is not None
                and getattr(self._chunking[2], "ragged", False) else None)
        live = sum(1 for s in self.slots if isinstance(s, _SlotInfo))
        if rjob is not None or live:
            k = self._chunk_size()
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
                dispatched = await self._ragged_dispatch(k)
            elif live:
                tokens_dev, self.state = await self._run(
                    self.runner.decode_steps_device, self.state, k)
                dispatched = _InFlightChunk(
                    tokens_dev=tokens_dev, snapshot=list(self.slots),
                    dispatched_at=time.monotonic())

        # Advance a legacy chunked admission by ONE prefill chunk (ragged
        # jobs advanced inside the dispatch above).
        if self._chunking is not None and rjob is None:
            await self._prefill_chunk_step()

        await self._admit_pending()

        # Retire the PREVIOUS chunk (readback overlaps the new dispatch).
        await self._retire_inflight()
        self._inflight = dispatched
        await asyncio.sleep(0)  # let submitters/streamers run

    async def _ragged_dispatch(self, k: int) -> _InFlightChunk | None:
        """Advance the parked ragged admission inside this decode dispatch;
        on its last chunk sample its first token and activate its slot."""
        req, slot, job = self._chunking
        c = self.runner.ragged_chunk
        chunk_toks = min(k * c, len(job.prompt_ids) - job.done_tokens)
        n_chunks = -(-chunk_toks // max(1, c))
        try:
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
        dispatched = _InFlightChunk(
            tokens_dev=tokens_dev, snapshot=list(self.slots),
            dispatched_at=time.monotonic())
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
        """Read back and emit the in-flight chunk, if any."""
        if self._inflight is None:
            return
        fl, self._inflight = self._inflight, None
        tokens = await self._run(lambda t: t.cpu().numpy(), fl.tokens_dev)
        now = time.monotonic()
        dt = max(now - max(self._last_retire_at, fl.dispatched_at), 1e-6)
        self._last_retire_at = now
        emitted = 0
        for step in range(tokens.shape[0]):
            for i, info in enumerate(fl.snapshot):
                # Emit only to slots still owned by the request they were
                # dispatched for.
                if not isinstance(info, _SlotInfo) or self.slots[i] is not info:
                    continue
                self._emit(info.req, int(tokens[step, i]), info)
                emitted += 1
        if emitted == 0:
            return  # pure-overshoot chunk: not a throughput sample
        rate = emitted / dt
        self.throughput_ema = (rate if self.throughput_ema == 0.0
                               else 0.9 * self.throughput_ema + 0.1 * rate)


DONE = _DONE
