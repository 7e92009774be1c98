"""Engine facade: the serving seam between the swarm and the model.

Counterpart of ``crowdllama_tpu/engine/engine.py``: ``Chunk``,
``StopMatcher``, the ``Engine`` base with the request seams everything
above it speaks (``handle``: one llama.v1 ``BaseMessage`` in, one out;
``handle_streaming_frames``: encoded frames out, one per chunk, a
``MigrateFrame`` last when the request is handed off), ``TorchEngine``
(the runner the serving plan names, paged or contiguous, behind the
continuous-batching scheduler, streaming text chunks from ``generate``;
``embed``, ``drain``, ``migrate``, ``capture_profile``) and
``FakeEngine``, the echo engine of consumer nodes and tests.  Not ported:
KV shipping (``kv_donor``), the remote-draft ``VerifyResult`` branch, the
fault-injection sites and the obs plane.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import math
import os
import tempfile
import time
from dataclasses import dataclass
from typing import AsyncIterator

import torch

from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.core import llama_v1 as pb
from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import (
    create_embed_response,
    create_generate_response,
    extract_embed_request,
    extract_generate_request,
    flatten_chat,
    genresp_frame_bytes,
    migrate_frame_msg,
)
from crowdllama_tpu_torch.engine.runner import resolve_device
from crowdllama_tpu_torch.parallel.mesh import build_mesh

log = logging.getLogger("crowdllama.torch.engine")


@dataclass
class Chunk:
    text: str
    done: bool = False
    done_reason: str = ""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # Scheduler stamps on the final chunk (ns): submit -> admission and
    # admission -> first token.
    queue_ns: int = 0
    prefill_ns: int = 0


class StopMatcher:
    """Streaming stop-sequence scanner (Ollama options.stop semantics).

    ``feed(text)`` returns (emit_now, stopped): text safe to send — up to
    ``max(len(stop)) - 1`` chars are held back so a stop spanning two
    chunks is still caught — and whether a stop fired (everything from the
    match on is dropped).  ``flush()`` returns the held tail.
    """

    def __init__(self, stop: list[str] | None):
        self.stops = [s for s in (stop or []) if s]
        self._hold = max((len(s) for s in self.stops), default=1) - 1
        self._pending = ""

    def feed(self, text: str) -> tuple[str, bool]:
        if not self.stops:
            return text, False
        self._pending += text
        cut = min((i for i in (self._pending.find(s) for s in self.stops)
                   if i >= 0), default=-1)
        if cut >= 0:
            emit, self._pending = self._pending[:cut], ""
            return emit, True
        if len(self._pending) > self._hold:
            split = len(self._pending) - self._hold
            emit, self._pending = self._pending[:split], self._pending[split:]
            return emit, False
        return "", False

    def flush(self) -> str:
        out, self._pending = self._pending, ""
        return out


class Engine:
    """Abstract engine seam."""

    models: list[str] = []

    async def start(self) -> None: ...
    async def stop(self) -> None: ...

    async def drain(self, timeout: float = 30.0) -> bool:
        """Finish in-flight work before shutdown; True when drained."""
        return True

    async def migrate(self) -> int:
        """Hand off every in-flight request (graceful drain): each active
        stream retires with a ``"migrate"`` terminal reason, which
        ``handle_streaming_frames`` turns into a MigrateFrame so the
        gateway re-routes it.  Returns how many requests were moved."""
        return 0

    def describe(self) -> dict:
        """Capability/telemetry snapshot for Resource advertisement."""
        return {"models": self.models, "throughput": 0.0, "load": 0.0}

    def generate(self, prompt: str, model: str = "", max_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 stop: list[str] | None = None, top_k: int = 0,
                 repeat_penalty: float = 1.0) -> AsyncIterator[Chunk]:
        raise NotImplementedError

    async def embed(self, texts: list[str], model: str = "",
                    truncate: bool = True) -> tuple[list[list[float]], int]:
        """Embed texts -> (one vector per text, total prompt tokens);
        ``truncate=False`` raises on an input longer than the context."""
        raise NotImplementedError

    # ---- the request seams: llama.v1 BaseMessage in ----------------------

    async def handle(self, msg: pb.BaseMessage,
                     worker_id: str = "") -> pb.BaseMessage:
        """One request message -> one reply message (an EmbedResponse for
        an EmbedRequest, else the whole GenerateResponse)."""
        if msg.WhichOneof("message") == "embed_request":
            ereq = extract_embed_request(msg)
            t0 = time.monotonic_ns()
            vectors, n_tokens = await self.embed(
                list(ereq.input), model=ereq.model, truncate=ereq.truncate)
            return create_embed_response(
                model=ereq.model, embeddings=vectors, worker_id=worker_id,
                total_duration_ns=time.monotonic_ns() - t0,
                prompt_tokens=n_tokens)
        req = extract_generate_request(msg)
        t0 = time.monotonic_ns()
        text_parts: list[str] = []
        final: Chunk | None = None
        async for chunk in self._gen_from_request(req):
            text_parts.append(chunk.text)
            final = chunk
        if final is None:
            raise RuntimeError("generation ended without a final chunk")
        return create_generate_response(
            model=req.model, response="".join(text_parts),
            worker_id=worker_id, done=True,
            done_reason=final.done_reason or "stop",
            total_duration_ns=time.monotonic_ns() - t0,
            prompt_tokens=final.prompt_tokens,
            completion_tokens=final.completion_tokens)

    async def handle_streaming(self, msg: pb.BaseMessage,
                               worker_id: str = ""
                               ) -> AsyncIterator[pb.BaseMessage]:
        """``handle_streaming_frames`` with each frame decoded."""
        async for frame in self.handle_streaming_frames(msg, worker_id):
            yield wire.decode_payload(frame[4:])

    async def handle_streaming_frames(self, msg: pb.BaseMessage,
                                      worker_id: str = ""
                                      ) -> AsyncIterator[bytes]:
        """Encoded wire frames, one GenerateResponse per chunk (``done``
        on the last) with the request's trace id; a request handed off by
        ``migrate`` ends in a MigrateFrame instead (its held-back text is
        dropped: the successor replays the generation)."""
        req = extract_generate_request(msg)
        t0 = time.monotonic_ns()
        async for chunk in self._gen_from_request(req):
            if chunk.done and chunk.done_reason == "migrate":
                hashes, page_size = self._migrate_export_meta(req)
                mig = migrate_frame_msg(
                    model=req.model, worker_id=worker_id,
                    delivered_tokens=chunk.completion_tokens,
                    prompt_tokens=chunk.prompt_tokens, chain_hashes=hashes,
                    page_size=page_size, reason="drain")
                mig.trace_id = msg.trace_id
                yield wire.encode_frame(mig)
                return
            yield genresp_frame_bytes(
                model=req.model, response=chunk.text, worker_id=worker_id,
                done=chunk.done,
                done_reason=chunk.done_reason if chunk.done else "",
                total_duration_ns=((time.monotonic_ns() - t0) if chunk.done
                                   else 0),
                prompt_tokens=chunk.prompt_tokens if chunk.done else 0,
                completion_tokens=(chunk.completion_tokens if chunk.done
                                   else 0),
                trace_id=msg.trace_id)

    def _format_chat(self, messages: list[dict], model: str = "") -> str:
        """Chat -> prompt string: the role-tagged flattening (the byte
        tokenizer has no chat template)."""
        return flatten_chat(messages)

    def _prompt_of(self, req: pb.GenerateRequest) -> str:
        prompt = req.prompt
        if not prompt and req.messages:
            prompt = self._format_chat(
                [{"role": m.role, "content": m.content} for m in req.messages],
                model=req.model)
        return prompt

    def _migrate_export_meta(self, req: pb.GenerateRequest
                             ) -> tuple[list[bytes], int]:
        """(chain hashes, page size) a MigrateFrame advertises: the prefix
        pages this worker can serve the successor.  Engines without a
        paged prefix index advertise nothing."""
        return [], 0

    def _gen_from_request(self, req: pb.GenerateRequest
                          ) -> AsyncIterator[Chunk]:
        # The float fields are float32 values (as protobuf reads them), so
        # a seeded request draws the same tokens on either package.
        return self.generate(
            self._prompt_of(req), model=req.model,
            max_tokens=req.max_tokens or 128, temperature=req.temperature,
            top_p=req.top_p or 1.0, seed=int(req.seed or 0),
            stop=list(req.stop), top_k=int(req.top_k or 0),
            repeat_penalty=float(req.repeat_penalty or 1.0))


class TorchEngine(Engine):
    """The real engine: the plan's runner + continuous-batching Scheduler.

    Serves on CUDA unless ``device`` is given; without CUDA and without a
    device, construction raises.  ``params`` (a parameter dict, e.g. from
    ``engine.weights.params_from_numpy``) replaces the random init, whose
    seed is ``seed``; the engine hands it to the runner (which shards it
    under tp) and keeps no reference.  Tensor parallelism: ``mesh_shape``
    (e.g. "2") with the ranks on ``devices`` (default: the visible CUDA
    devices, each once); ``devices`` may name one device twice, e.g.
    ``["cpu", "cpu"]`` or two shards on one card.  ``model_config`` (a
    ``ModelConfig``) serves in place of the registry's entry for
    ``config.model``, e.g. a copy cut to fewer layers."""

    def __init__(self, config: Configuration | None = None, *,
                 device: torch.device | str | None = None,
                 devices: list | None = None,
                 params: dict | None = None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 model_config=None, **overrides):
        self.config = dataclasses.replace(config or Configuration(),
                                          **overrides)
        self.models = [self.config.model]
        if devices is not None and device is not None:
            raise ValueError("pass device= or devices=, not both")
        self._device = device
        self.devices = (None if devices is None
                        else [torch.device(d) for d in devices])
        if self.devices is not None:
            self.device = self.devices[0]
        elif self.config.mesh_shape and device is None:
            self.device = build_mesh(self.config.mesh_shape).devices[0]
        else:
            self.device = resolve_device(device)
        self.dtype = dtype
        self.seed = seed
        self._params = params
        self._model_config = model_config
        self.scheduler = None
        self.tokenizer = None
        self.runner = None
        self.plan = None

    async def start(self) -> None:
        """Build tokenizer/params/runner (through the serving plan), run
        each serving path once (warmup, which also builds the kernels),
        start the scheduler."""
        from crowdllama_tpu_torch.engine.factory import build_runner
        from crowdllama_tpu_torch.engine.plan import resolve_serving_plan
        from crowdllama_tpu_torch.engine.scheduler import Scheduler
        from crowdllama_tpu_torch.engine.tokenizer import get_tokenizer
        from crowdllama_tpu_torch.models.config import get_config

        c = self.config
        self.plan = resolve_serving_plan(c)
        cfg = self._model_config or get_config(c.model)
        if c.max_context_length:
            cfg = dataclasses.replace(cfg, max_context_length=min(
                cfg.max_context_length, c.max_context_length))
        self.tokenizer = get_tokenizer(c.model_path)
        loop = asyncio.get_running_loop()

        def _build():
            params, self._params = self._params, None
            return build_runner(c, self.plan, cfg, params,
                                dtype=self.dtype, seed=self.seed,
                                device=self._device, devices=self.devices)

        self.runner = await loop.run_in_executor(None, _build)
        self.device = self.runner.device
        if c.warmup:
            await loop.run_in_executor(None, self._warmup)
        self.scheduler = Scheduler(
            self.runner, decode_chunk=c.decode_chunk,
            admission_pending_max=c.admission_pending_max,
            ragged=c.ragged_prefill)
        self.scheduler.start()
        log.info("engine up: model=%s devices=%s layout=%s kv_dtype=%s "
                 "slots=%d max_seq=%d", cfg.name, self.runner.devices,
                 self.plan.kv_layout, self.plan.kv_dtype,
                 self.runner.max_slots, self.runner.max_seq)

    def _warmup(self) -> None:
        """Run every serving path once before serving: monolithic prefill +
        insert (kernel A), decode chunks of 1 and decode_chunk (kernel D on
        the contiguous layout, B on the paged one), the prefix-hit suffix
        prefill, a legacy chunked prefill of one chunk + 1 tokens, the
        embeddings forward, and on the paged layout a unified ragged
        prefill of one chunk + 1 tokens (kernel C).  On an int8 KV cache
        the same calls run its paths: quantizing insert, int8 decode
        (kernel B's int8 variant when paged, the plain
        ``decode_attention_q`` when contiguous), the dequantized context
        of the prefix-hit prefill and the int8 ragged step."""
        r = self.runner
        state = r.init_state()
        tok, ks, vs, plen = r.prefill([1, 2, 3], 0.0, 1.0, None)
        state = r.insert(state, 0, ks, vs, plen, tok, 0.0, 1.0)
        for k in sorted({1, self.config.decode_chunk}):
            _, state = r.decode_steps(state, k)
        if getattr(r, "prefix_cache", False):
            r.warmup_ctx_prefill(state)
        vocab = r.cfg.vocab_size
        if r.prefill_chunk and r.max_seq > r.prefill_chunk + 1:
            job = r.prefill_begin([1 + i % (vocab - 1)
                                   for i in range(r.prefill_chunk + 1)])
            while not r.prefill_step(job):
                pass
            r.prefill_finish(job, 0.0, 1.0, None)
        r.embed_prompts([[1, 2, 3]])
        state = r.release(state, 0)
        if (self.config.ragged_prefill and r.supports_ragged
                and r.max_seq > r.ragged_chunk + 1):
            job = r.ragged_begin([2 + i % (vocab - 2)
                                  for i in range(r.ragged_chunk + 1)], 0,
                                 state=state)
            while not job.finished:
                _, state = r.ragged_step(state, job, 1)
            _, state = r.ragged_finish(state, job, 0.0, 1.0, None)
            state = r.release(state, 0)
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
        log.info("warmup done")

    async def stop(self) -> None:
        if self.scheduler is not None:
            await self.scheduler.stop()

    async def drain(self, timeout: float = 30.0) -> bool:
        """Finish in-flight requests before shutdown; False on timeout."""
        if self.scheduler is None:
            return True
        return await self.scheduler.drain(timeout)

    async def migrate(self) -> int:
        """Retire every in-flight request with "migrate" at the decode
        loop's next safe point; prefix pages stay cached."""
        if self.scheduler is None:
            return 0
        return await self.scheduler.migrate()

    def _migrate_export_meta(self, req: pb.GenerateRequest
                             ) -> tuple[list[bytes], int]:
        r = self.runner
        if (r is None or self.tokenizer is None
                or not getattr(r, "prefix_cache", False)):
            return [], 0
        ids = self.tokenizer.encode(self._prompt_of(req))
        return r.chain_keys_for_prompt(ids), int(r.page_size)

    async def capture_profile(self, seconds: float = 3.0) -> str:
        """Trace ``seconds`` (0.1-60) of live serving with
        ``torch.profiler`` (CPU activity, and CUDA kernels when the engine
        serves on a card: the device-wide trace spans whatever the
        scheduler dispatches meanwhile), write it as a Chrome trace
        (``<host>.pt.trace.json``) in a new directory under
        ``profile_dir/plugins/profile/`` and return that directory."""
        if not self.config.profile_dir:
            raise RuntimeError("profiling disabled: set profile_dir "
                               "(--profile-dir / CROWDLLAMA_TPU_PROFILE_DIR)")
        seconds = min(max(float(seconds), 0.1), 60.0)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        root = os.path.join(self.config.profile_dir, "plugins", "profile")

        def _trace() -> str:
            with torch.profiler.profile(activities=activities) as prof:
                time.sleep(seconds)
            os.makedirs(root, exist_ok=True)
            out = tempfile.mkdtemp(
                prefix=time.strftime("%Y_%m_%d_%H_%M_%S_"), dir=root)
            prof.export_chrome_trace(
                os.path.join(out, f"{os.uname().nodename}.pt.trace.json"))
            return out

        return await asyncio.get_running_loop().run_in_executor(None, _trace)

    def describe(self) -> dict:
        d = {"models": self.models, "throughput": 0.0, "load": 0.0}
        if self.runner is not None:
            d["embeddings"] = True
        if self.scheduler is not None:
            d["throughput"] = round(self.scheduler.throughput_ema, 2)
            d["load"] = round(self.scheduler.load, 3)
        if self.runner is not None:
            r = self.runner
            d["device"] = str(r.device)
            d["tp"] = r.tp
            d["devices"] = [str(x) for x in r.devices]
            d["kv_layout"] = r.kv_layout
            d["kv_dtype"] = r.kv_dtype
            if getattr(r, "prefix_cache", False):
                d["prefix_cache"] = {
                    "hits": r.prefix_hits,
                    "misses": r.prefix_misses,
                    "tokens_reused": r.prefix_tokens_reused,
                }
        return d

    async def generate(  # type: ignore[override]
        self, prompt: str, model: str = "", max_tokens: int = 128,
        temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
        stop: list[str] | None = None, top_k: int = 0,
        repeat_penalty: float = 1.0,
    ) -> AsyncIterator[Chunk]:
        from crowdllama_tpu_torch.engine.scheduler import DONE, GenRequest

        if self.scheduler is None:
            raise RuntimeError("engine not started")
        if model and model not in self.models:
            raise ValueError(f"model {model!r} not served (have {self.models})")
        prompt_ids = self.tokenizer.encode(prompt)
        req = GenRequest(prompt_ids=prompt_ids, max_tokens=max_tokens,
                         temperature=temperature, top_p=top_p,
                         top_k=max(0, int(top_k)),
                         repeat_penalty=float(repeat_penalty or 1.0),
                         eos_id=self.tokenizer.eos_id, seed=seed)
        await self.scheduler.submit(req)
        decoder = self.tokenizer.stream_decoder()
        matcher = StopMatcher(stop)
        completion = 0
        finished = False

        def _final(text: str, reason: str) -> Chunk:
            base = req.admitted_at or req.submitted_at
            q = max(0.0, base - req.submitted_at)
            p = (max(0.0, req.first_token_at - base)
                 if req.first_token_at else 0.0)
            return Chunk(text=text, done=True, done_reason=reason,
                         prompt_tokens=len(prompt_ids),
                         completion_tokens=completion,
                         queue_ns=int(q * 1e9), prefill_ns=int(p * 1e9))

        try:
            while True:
                token, reason = await req.out.get()
                if token is DONE:
                    finished = True
                    if reason.startswith("error"):
                        raise RuntimeError(reason)
                    yield _final(matcher.flush(), reason)
                    return
                completion += 1
                if token == req.eos_id:
                    continue  # silent; DONE follows
                text = decoder.feed(token)
                if not text:
                    continue
                emit, stopped = matcher.feed(text)
                if stopped:
                    finished = True
                    self.scheduler.cancel(req)
                    yield _final(emit, "stop")
                    return
                if emit:
                    yield Chunk(text=emit)
        finally:
            if not finished:
                # Consumer stopped early: free the decode slot.
                self.scheduler.cancel(req)

    async def embed(self, texts: list[str], model: str = "",
                    truncate: bool = True) -> tuple[list[list[float]], int]:
        """Mean-pooled final-hidden-state embeddings
        (``runner.embed_prompts``, through the scheduler's dispatch
        thread); refused while draining."""
        if self.scheduler is None:
            raise RuntimeError("engine not started")
        if self.scheduler.draining:
            raise RuntimeError("worker is draining for shutdown")
        if model and model not in self.models:
            raise ValueError(f"model {model!r} not served (have {self.models})")
        max_len = self.runner.max_seq - 1
        prompts, n_tokens = [], 0
        for text in texts:
            ids = self.tokenizer.encode(text)
            if len(ids) > max_len:
                if not truncate:
                    raise ValueError(
                        f"input of {len(ids)} tokens exceeds context length "
                        f"{max_len} and truncate=false")
                ids = ids[:max_len]
            ids = ids or [0]
            n_tokens += len(ids)
            prompts.append(ids)
        vectors = await self.scheduler.embed(prompts,
                                             self.runner._EMBED_BATCH[-1])
        return vectors, n_tokens


class FakeEngine(Engine):
    """Echo engine for consumer nodes and tests: streams ``"echo: "`` and
    the prompt word by word; ``migrate()`` retires every active stream
    with "migrate" at its next word."""

    def __init__(self, models: list[str] | None = None, delay: float = 0.0):
        self.models = models or ["tiny-test"]
        self.delay = delay
        self.calls = 0
        self._migrating = False
        self._active = 0

    async def start(self) -> None:
        return

    async def stop(self) -> None:
        return

    async def migrate(self) -> int:
        self._migrating = True
        return self._active

    def describe(self) -> dict:
        return {"models": self.models, "throughput": 100.0, "load": 0.1}

    async def generate(  # type: ignore[override]
        self, prompt: str, model: str = "", max_tokens: int = 128,
        temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
        stop: list[str] | None = None, top_k: int = 0,
        repeat_penalty: float = 1.0,
    ) -> AsyncIterator[Chunk]:
        self.calls += 1
        self._active += 1
        try:
            if self.delay:
                await asyncio.sleep(self.delay)
            matcher = StopMatcher(stop)
            words = f"echo: {prompt}".split(" ")
            emitted = 0
            stopped = False
            for i, w in enumerate(words):
                if self._migrating:
                    yield Chunk(text="", done=True, done_reason="migrate",
                                prompt_tokens=len(prompt.split()),
                                completion_tokens=max(emitted, 1))
                    return
                emit, stopped = matcher.feed(
                    w + ("" if i == len(words) - 1 else " "))
                if emit:
                    yield Chunk(text=emit)
                    emitted += 1
                if stopped:
                    break
            yield Chunk(text="" if stopped else matcher.flush(), done=True,
                        done_reason="stop",
                        prompt_tokens=len(prompt.split()),
                        completion_tokens=max(emitted, 1))
        finally:
            self._active -= 1

    async def embed(self, texts: list[str], model: str = "",
                    truncate: bool = True) -> tuple[list[list[float]], int]:
        """Deterministic unit vectors keyed by the text's hash."""
        self.calls += 1
        out = []
        for text in texts:
            h = hashlib.sha256(text.encode()).digest()
            vec = [b / 255.0 - 0.5 for b in h[:8]]
            norm = math.sqrt(sum(v * v for v in vec)) or 1.0
            out.append([v / norm for v in vec])
        return out, sum(len(t.split()) for t in texts)
