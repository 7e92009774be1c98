"""Engine facade: the serving seam between the swarm and the model.

Counterpart of ``crowdllama_tpu/engine/engine.py``: ``Chunk``,
``StopMatcher``, the ``Engine`` base with the request seams everything
above it speaks (``handle``: one llama.v1 ``BaseMessage`` in, one out;
``handle_streaming_frames``: encoded frames out, one per chunk, a
``MigrateFrame`` last when the request is handed off), ``TorchEngine``
(the runner the serving plan names, paged or contiguous, behind the
continuous-batching scheduler, streaming text chunks from ``generate``;
``embed``, ``drain``, ``migrate``, ``capture_profile``) and
``FakeEngine``, the echo engine of consumer nodes and tests.  The seams
record the obs plane's spans and histograms (``_obs_generate``, into the
``NodeObs`` a ``Peer`` hands to ``engine.obs``) and carry the chaos sites
of ``testing/faults.py`` (``engine.request``, ``engine.stream_chunk``,
``spec.verify``).  A streamed request flagged ``remote_draft`` on an
engine whose runner verifies remote drafts (``supports_remote_draft``)
paces on the ``DraftFeed`` the peer fills from the gateway's DraftChunk
frames: ``generate`` yields a handshake (chunk 0: the prompt ids and the
first token) and one control chunk per consumed credit, which
``handle_streaming_frames`` writes as ``VerifyResult`` frames between the
text frames.

KV shipping: a request whose ``kv_donor`` names another worker makes
``generate`` fetch the prompt's prefix pages from that donor over a pooled
inference stream before submitting (two attempts within
``kv_ship_timeout``, the ``kv_ship_min_tokens`` break-even gate, both
bypassed for a migrated stream), and the scheduler imports them at
admission; every failure falls back to plain prefill.  As a donor,
``export_kv_pages`` gathers the pages on the dispatch thread between
dispatches (``Scheduler.run_exclusive``).  The fetch is the worker's
``kv_fetch`` span and the ``crowdllama_kv_ship_*``,
``crowdllama_kv_fetch_seconds`` and
``crowdllama_replayed_prefill_tokens_total`` families.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import math
import os
import random
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import AsyncIterator

import torch

from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.core import llama_v1 as pb
from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import (
    create_embed_response,
    create_generate_response,
    create_kv_fetch_request,
    extract_embed_request,
    extract_generate_request,
    extract_kv_pages,
    flatten_chat,
    genresp_frame_bytes,
    migrate_frame_msg,
    verify_result_msg,
)
from crowdllama_tpu_torch.engine.factory import process_devices
from crowdllama_tpu_torch.engine.runner import resolve_device
from crowdllama_tpu_torch.parallel import multihost
from crowdllama_tpu_torch.parallel.mesh import build_mesh
from crowdllama_tpu_torch.parallel.replicated import ReplicatedRunner
from crowdllama_tpu_torch.testing import faults

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
    # KV shipping, on the final chunk: the wall time spent fetching donor
    # pages before submit (the worker's kv_fetch span; 0 = no fetch), and
    # whether the fetch yielded no pages and prefill ran plain.
    kv_fetch_ns: int = 0
    kv_fallback: bool = False
    # Remote-draft control chunk: the VerifyResult payload (no text, not
    # done); None on every text chunk.
    verify: dict | None = None


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
    # NodeObs of the owning worker peer (set by Peer.start); None when the
    # engine runs without a peer (IPC-only, unit tests).
    obs = None
    # The owning Peer (attach_peer): a chaos drain goes through it.
    _peer = None
    _chaos_drain = None  # the task a "drain" fault or the watchdog started
    # Engines whose runner batch-verifies remote drafts opt in; on every
    # other engine a remote-draft stream runs unpaced and the peer nacks
    # the gateway's DraftChunk credits.
    supports_remote_draft = False
    # Engines that act on a GenerateRequest.kv_donor hint (fetch a donor's
    # pages before prefill) opt in; everywhere else the hint is dropped.
    supports_kv_donor = False

    async def start(self) -> None: ...
    async def stop(self) -> None: ...

    def attach_peer(self, peer) -> None:
        """Called by ``Peer.start()``."""
        self._peer = peer

    def obs_gauges(self) -> dict:
        """Engine/scheduler gauges for the metrics exposition: the JAX
        engine's keys, at zero on an engine without a scheduler (a
        ``TorchEngine`` overlays its scheduler's measured values: the duty
        cycle per dispatch class, ``step_token_budget_used``, the
        watchdog's, the autopilot's when it runs); without a tuner the
        ``autotune_*`` keys read 0."""
        g = {"pending_depth": 0.0, "active_slots": 0.0,
             "batch_occupancy": 0.0, "kv_cache_utilization": 0.0,
             "prefill_chunk_slots": 0.0, "step_token_budget_used": 0.0,
             "host_dispatches_total": 0.0, "tokens_per_dispatch": 0.0}
        for cls in ("plain", "megastep", "ragged", "ragged_mega", "spec"):
            g[f"duty_cycle|dispatch={cls}"] = 0.0
        g.update({"autotune_score": 0.0, "autotune_moves_total": 0.0,
                  "autotune_reverts_total": 0.0,
                  "autotune_backoffs_total": 0.0})
        for dial in ("megastep_k", "draft_k", "step_token_budget",
                     "prefill_chunk", "pipeline_depth"):
            g[f"autotune_dial|dial={dial}"] = 0.0
        return g

    async def export_kv_pages(self, model: str, chain_hashes: list[bytes],
                              page_size: int) -> dict | None:
        """A peer's KvFetchRequest: the pages of the longest indexed
        prefix, or None when this engine has nothing to offer (no paged
        prefix cache, another model, another page size)."""
        return None

    def set_gossip(self, gossip) -> None:
        """Hand the node's GossipNode to the engine (the autopilot's
        ``tune/<model>`` keys); a no-op on engines that do not tune."""

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

    def model_dir(self, model: str) -> str | None:
        """Local checkpoint directory for ``model`` if this engine can
        share it over the swarm (net/model_share.py); None otherwise."""
        return None

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

    def _obs_generate(self, msg: pb.BaseMessage, model: str, t0: int,
                      first_ns: int, end_ns: int,
                      final: Chunk | None) -> None:
        """Record the worker-side spans and histograms of one generate
        exchange.  The queue/prefill split is the scheduler's stamps on
        the final chunk when it has them, else prefill is the first
        chunk's latency (FakeEngine)."""
        if self.obs is None:
            return
        queue_ns = final.queue_ns if final else 0
        prefill_ns = final.prefill_ns if final else 0
        kv_ns = final.kv_fetch_ns if final else 0
        if kv_ns:
            # The donor fetch ran before submit: in neither the queue nor
            # the prefill stamp, so it gets its own span.
            self.obs.trace.record(
                msg.trace_id, "kv_fetch", kv_ns, parent=msg.parent_span,
                **({"fallback": True} if final.kv_fallback else {}))
        if not prefill_ns:
            prefill_ns = max(0, (first_ns or end_ns) - t0 - queue_ns - kv_ns)
        decode_ns = max(0, (end_ns - t0) - queue_ns - prefill_ns - kv_ns)
        steps = final.completion_tokens if final else 0
        if steps > 0 and decode_ns > 0:
            self.obs.metrics.decode_step_seconds.observe(
                decode_ns / steps / 1e9)
        self.obs.observe_generate(
            msg.trace_id, msg.parent_span, model, queue_ns, prefill_ns,
            decode_ns, steps, end_ns - t0, node="worker")

    async def handle(self, msg: pb.BaseMessage,
                     worker_id: str = "") -> pb.BaseMessage:
        """One request message -> one reply message (an EmbedResponse for
        an EmbedRequest, else the whole GenerateResponse)."""
        if msg.WhichOneof("message") == "embed_request":
            ereq = extract_embed_request(msg)
            t0 = time.monotonic_ns()
            vectors, n_tokens = await self.embed(
                list(ereq.input), model=ereq.model, truncate=ereq.truncate)
            dt = time.monotonic_ns() - t0
            if self.obs is not None:
                self.obs.metrics.request_seconds.labels(
                    ereq.model).observe(dt / 1e9)
                if msg.trace_id:
                    self.obs.trace.record(msg.trace_id, "embed", dt,
                                          parent=msg.parent_span)
                    self.obs.trace.finish(msg.trace_id, dt)
            return create_embed_response(
                model=ereq.model, embeddings=vectors, worker_id=worker_id,
                total_duration_ns=dt, prompt_tokens=n_tokens)
        req = extract_generate_request(msg)
        await faults.inject("engine.request", worker=worker_id,
                            model=req.model)
        t0 = time.monotonic_ns()
        first_ns = 0
        text_parts: list[str] = []
        final: Chunk | None = None
        async for chunk in self._gen_from_request(req, trace_id=msg.trace_id):
            if not first_ns:
                first_ns = time.monotonic_ns()
            text_parts.append(chunk.text)
            final = chunk
        if final is None:
            raise RuntimeError("generation ended without a final chunk")
        end_ns = time.monotonic_ns()
        self._obs_generate(msg, req.model, t0, first_ns, end_ns, final)
        return create_generate_response(
            model=req.model, response="".join(text_parts),
            worker_id=worker_id, done=True,
            done_reason=final.done_reason or "stop",
            total_duration_ns=end_ns - t0,
            prompt_tokens=final.prompt_tokens,
            completion_tokens=final.completion_tokens)

    async def handle_streaming(self, msg: pb.BaseMessage,
                               worker_id: str = "", draft_feed=None
                               ) -> AsyncIterator[pb.BaseMessage]:
        """``handle_streaming_frames`` with each frame decoded."""
        async for frame in self.handle_streaming_frames(
                msg, worker_id, draft_feed=draft_feed):
            yield wire.decode_payload(frame[4:])

    def _verify_frame_fields(self) -> tuple[int, int]:
        """(draft_k, depth_hint) a VerifyResult advertises."""
        return 0, 1

    async def handle_streaming_frames(self, msg: pb.BaseMessage,
                                      worker_id: str = "", draft_feed=None
                                      ) -> AsyncIterator[bytes]:
        """Encoded wire frames, one GenerateResponse per chunk (``done``
        on the last) with the request's trace id; a request handed off by
        ``migrate`` ends in a MigrateFrame instead (its held-back text is
        dropped: the successor replays the generation).  With
        ``draft_feed`` a remote-draft request's control chunks become
        VerifyResult frames (the ``spec.verify`` fault site before each)."""
        req = extract_generate_request(msg)
        t0 = time.monotonic_ns()
        first_ns = 0
        n_chunk = 0
        async for chunk in self._gen_from_request(req, trace_id=msg.trace_id,
                                                  draft_feed=draft_feed):
            if not first_ns:
                first_ns = time.monotonic_ns()
            if chunk.verify is not None:
                v = chunk.verify
                await faults.inject("spec.verify", worker=worker_id,
                                    model=req.model,
                                    chunk_id=int(v.get("chunk_id", 0)))
                dk, dh = self._verify_frame_fields()
                vmsg = verify_result_msg(
                    chunk_id=int(v.get("chunk_id", 0)),
                    position=int(v.get("position", 0)),
                    accepted=int(v.get("accepted", 0)),
                    tokens=v.get("tokens", []), done=False, draft_k=dk,
                    depth_hint=dh, prompt_ids=v.get("prompt_ids", []))
                vmsg.trace_id = msg.trace_id
                yield wire.encode_frame(vmsg)
                continue
            try:
                await faults.inject("engine.stream_chunk", worker=worker_id,
                                    model=req.model, index=n_chunk)
            except faults.DrainRequested:
                # Chaos trigger for live migration: as if SIGTERM landed
                # mid-stream.  The drain runs beside this stream, which
                # ends in a MigrateFrame at the scheduler's next safe point.
                self._chaos_drain = asyncio.get_running_loop().create_task(
                    self._peer.drain() if self._peer is not None
                    else self.migrate())
            n_chunk += 1
            if chunk.done:
                self._obs_generate(msg, req.model, t0, first_ns,
                                   time.monotonic_ns(), chunk)
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
        """Chat -> prompt string: the role-tagged flattening."""
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

    def _gen_from_request(self, req: pb.GenerateRequest, trace_id: str = "",
                          draft_feed=None) -> AsyncIterator[Chunk]:
        # The float fields are float32 values (as protobuf reads them), so
        # a seeded request draws the same tokens on either package.
        kwargs = {}
        if (draft_feed is not None and req.remote_draft
                and self.supports_remote_draft):
            # Only engines that pace on credits see the keywords.
            kwargs = dict(remote_draft=True, draft_feed=draft_feed)
        if req.kv_donor and self.supports_kv_donor:
            # Only engines that opted in see the keywords; the trace id
            # puts the donor's kv_export span in this request's trace.  A
            # migrated stream bypasses the kv_ship and break-even gates:
            # the fetch is the point of its re-route.
            kwargs.update(kv_donor=req.kv_donor, kv_trace=trace_id)
            if req.migrate:
                kwargs["migrate"] = True
        return self.generate(
            self._prompt_of(req), model=req.model,
            max_tokens=req.max_tokens or 128, temperature=req.temperature,
            top_p=req.top_p or 1.0, seed=int(req.seed or 0),
            stop=list(req.stop), top_k=int(req.top_k or 0),
            repeat_penalty=float(req.repeat_penalty or 1.0), **kwargs)


class TorchEngine(Engine):
    """The real engine: the plan's runner + continuous-batching Scheduler.

    Serves on CUDA unless ``device`` is given; without CUDA and without a
    device, construction raises.  ``params`` (a parameter dict, e.g. from
    ``engine.weights.params_from_numpy``) replaces the random init, whose
    seed is ``seed``; the engine hands it to the runner (which shards it
    on a mesh) and keeps no reference.  A mesh: ``mesh_shape`` (e.g. "2",
    "2x1", "1x2x1x1x2") with the ranks on ``devices`` (default: the
    visible CUDA devices, each once); ``devices`` may name one device
    several times, e.g. ``["cpu"] * 4`` or every rank on one card.  The
    serving plan moves a paged request on a dp/sp/pp mesh to the
    contiguous layout and logs why.  ``model_config`` (a
    ``ModelConfig``) serves in place of the registry's entry for
    ``config.model``, e.g. a copy cut to fewer layers.  ``model_path``
    (a native or an HF checkpoint directory) serves its weights and
    tokenizer; a ``model`` name outside the registry takes the
    directory's config.json."""

    supports_kv_donor = True

    def __init__(self, config: Configuration | None = None, *,
                 device: torch.device | str | None = None,
                 devices: list | None = None,
                 params: dict | None = None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 model_config=None, **overrides):
        self.config = dataclasses.replace(config or Configuration(),
                                          **overrides)
        self.models = [self.config.model]
        if devices is None and multihost.process_count() > 1:
            # One worker over several processes: this process's ranks.
            devices, device = process_devices(self.config, device), None
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
        self.model_config = None
        self.load_seconds = 0.0  # host seconds to load model_path
        self.plan = None
        self._kv_streams = None  # pooled donor streams (lazy StreamPool)
        # The autopilot, built in start() when config.autotune is set; the
        # gossip node may be wired before or after.
        self.autotuner = None
        self._gossip = None

    def set_gossip(self, gossip) -> None:
        """The autopilot's warm-start and publish plane (the CLI starts
        the node's GossipNode after the engine): kept for start() and
        handed to a running tuner."""
        self._gossip = gossip
        if self.autotuner is not None:
            self.autotuner.set_gossip(gossip)

    async def start(self) -> None:
        """Build tokenizer/params/runner (through the serving plan), run
        each serving path once (warmup, which also builds the kernels),
        start the scheduler."""
        from crowdllama_tpu_torch.engine.factory import build_process_runner
        from crowdllama_tpu_torch.engine.plan import check_megastep
        from crowdllama_tpu_torch.engine.scheduler import Scheduler
        from crowdllama_tpu_torch.engine.tokenizer import get_tokenizer

        c = self.config
        self.tokenizer = get_tokenizer(c.model_path)
        loop = asyncio.get_running_loop()

        def _build():
            # One builder shared with run_follower (engine/factory.py):
            # every process builds the same runner.
            params, self._params = self._params, None
            return build_process_runner(
                c, devices=self.devices, device=self._device, params=params,
                dtype=self.dtype, seed=self.seed,
                model_config=self._model_config)

        runner, self.plan, cfg, self.load_seconds = (
            await loop.run_in_executor(None, _build))
        # The composition table's single decision point (engine/plan.py);
        # a documented fallback is logged, never silent.
        for note in self.plan.notes:
            log.warning("%s", note)
        self.model_config = cfg
        if multihost.process_count() > 1:
            # One worker over several processes: every device-touching
            # call is broadcast to the followers before it runs
            # (parallel/replicated.py).
            runner = ReplicatedRunner(runner)
        self.runner = runner
        check_megastep(c.megastep_k, self.runner.devices)
        self.device = self.runner.device
        if c.warmup:
            await loop.run_in_executor(None, self._warmup)
        self.scheduler = Scheduler(
            self.runner, decode_chunk=c.decode_chunk,
            admission_pending_max=c.admission_pending_max,
            spec_draft_max=c.spec_draft_max, ragged=c.ragged_prefill,
            megastep_k=c.megastep_k, wedge_multiplier=c.wedge_multiplier)
        self.scheduler.drain_requested_cb = self._self_drain
        if c.autotune:
            from crowdllama_tpu_torch.engine.autotune import AutoTuner

            self.autotuner = AutoTuner(
                self.scheduler, model_id=c.model,
                interval=c.autotune_interval,
                bounds={"megastep_k": c.autotune_megastep_max,
                        "draft_k": c.autotune_draft_max,
                        "step_token_budget": c.autotune_budget_max,
                        "prefill_chunk": c.autotune_prefill_max,
                        "pipeline_depth": c.autotune_depth_max},
                decode_ms=c.slo_decode_ms, gossip=self._gossip)
            self.scheduler.attach_autotuner(self.autotuner)
        self.scheduler.start()
        log.info("engine up: model=%s devices=%s layout=%s kv_dtype=%s "
                 "slots=%d max_seq=%d", cfg.name, self.runner.devices,
                 self.plan.kv_layout, self.plan.kv_dtype,
                 self.runner.max_slots, self.runner.max_seq)

    def _format_chat(self, messages: list[dict], model: str = "") -> str:
        """Chat -> prompt string: the checkpoint's own chat template when
        its tokenizer has one, else the role-tagged flattening."""
        fmt = getattr(self.tokenizer, "format_chat", None)
        if fmt is not None:
            try:
                return fmt(messages)
            except ValueError:
                pass  # no template (or none this package renders): flatten
            except Exception:
                # A template that rejects this conversation (Gemma's raises
                # on a system role): flatten, loudly.
                log.warning("chat template failed; using generic "
                            "flattening", exc_info=True)
        return flatten_chat(messages)

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
        of the prefix-hit prefill and the int8 ragged step.  With
        ``megastep_k`` a megastep flight runs greedy and once sampled: on
        the card each captures its CUDA graph on this state, which the
        runner then keeps (``init_state`` zeroes it in place), so the
        scheduler's flights replay these captures."""
        r = self.runner
        state = r.init_state()
        tok, ks, vs, plen = r.prefill([1, 2, 3], 0.0, 1.0, None)
        state = r.insert(state, 0, ks, vs, plen, tok, 0.0, 1.0)
        for k in sorted({1, self.config.decode_chunk}):
            _, state = r.decode_steps(state, k)
        mk = self.config.megastep_k
        if mk and getattr(r, "supports_megastep", False):
            _, _, state = r.decode_megastep(state, mk)
            slot = min(1, r.max_slots - 1)
            state = r.insert(state, slot, ks, vs, plen, tok, 1.0, 1.0)
            _, _, state = r.decode_megastep(state, mk)
            if slot:
                state = r.release(state, slot)
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
        if self._kv_streams is not None:
            self._kv_streams.close()
        if self.scheduler is not None:
            # Waits for the dispatch thread's last call, so STOP below
            # never interleaves with a frame.
            await self.scheduler.stop()
        if isinstance(self.runner, ReplicatedRunner):
            self.runner.shutdown()  # release the follower loops

    @property
    def supports_remote_draft(self) -> bool:  # type: ignore[override]
        """True once the runner carries the hosted verify
        (``SpecPagedModelRunner``): known after ``start()``."""
        return bool(getattr(self.runner, "supports_remote_draft", False))

    def _verify_frame_fields(self) -> tuple[int, int]:
        return (int(getattr(self.runner, "draft_len", 0)),
                int(getattr(self.scheduler, "spec_pipeline_depth", 1)))

    def _self_drain(self) -> None:
        """The self-watchdog's drain: through the owning peer when there is
        one (it publishes draining to the swarm), else this engine's
        ``migrate``."""
        loop = asyncio.get_running_loop()
        self._chaos_drain = loop.create_task(
            self._peer.drain() if self._peer is not None else self.migrate())

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
        moved = await self.scheduler.migrate()
        if moved and self.obs is not None:
            self.obs.metrics.drain_inc("migrated_slots", moved)
        return moved

    def obs_gauges(self) -> dict:
        g = super().obs_gauges()
        if self.scheduler is not None:
            g.update(self.scheduler.telemetry_gauges())
        return g

    def _migrate_export_meta(self, req: pb.GenerateRequest
                             ) -> tuple[list[bytes], int]:
        r = self.runner
        if (r is None or self.tokenizer is None
                or not getattr(r, "prefix_cache", False)):
            return [], 0
        ids = self.tokenizer.encode(self._prompt_of(req))
        return r.chain_keys_for_prompt(ids), int(r.page_size)

    # ------------------------------------------------------- KV shipping

    def _kv_ship_ready(self, migrate: bool = False) -> bool:
        """Whether this engine imports a donor's pages: ``kv_ship`` on
        (a migrated stream needs no opt-in) and a paged prefix cache."""
        r = self.runner
        if isinstance(r, ReplicatedRunner):
            # A leader-side import would part the processes' pools and
            # allocators: refused (parallel/replicated.py UNFRAMED).
            if self.config.kv_ship or migrate:
                log.warning("kv import refused under multi-process serving")
            return False
        return ((bool(self.config.kv_ship) or migrate)
                and self.scheduler is not None and r is not None
                and getattr(r, "prefix_cache", False)
                and hasattr(r, "import_pages"))

    async def export_kv_pages(self, model: str, chain_hashes: list[bytes],
                              page_size: int) -> dict | None:
        """Donor side: serve a peer's fetch from the prefix index.  The
        gather runs on the dispatch thread between dispatches
        (``run_exclusive``): read from the event loop while a dispatch or
        a graph replay is in flight, the pool would race the card."""
        r = self.runner
        if (self.scheduler is None or r is None
                or not getattr(r, "prefix_cache", False)
                or not hasattr(r, "export_pages")):
            return None
        if model and model not in self.models:
            return None
        if isinstance(r, ReplicatedRunner):
            # A leader-side export reads its own shards only and touches
            # the prefix LRU on the leader alone (UNFRAMED): no pages.
            log.warning("kv export refused under multi-process serving")
            return None
        hashes = [bytes(h) for h in chain_hashes]
        return await self.scheduler.run_exclusive(
            lambda state: r.export_pages(state, hashes,
                                         page_size=int(page_size)))

    async def _fetch_kv_payload(self, donor: str, model: str,
                                prompt_ids: list[int], trace_id: str = "",
                                migrate: bool = False
                                ) -> tuple[dict | None, int]:
        """Receiver side: dial the donor and pull the prompt's prefix
        pages.  Returns (the payload for ``GenRequest.kv_import`` or None,
        the fetch's wall ns; 0 when no fetch was attempted).  Every failure
        (donor gone, stream killed, timeout) degrades to plain prefill.
        One failure earns one retry after a jittered backoff inside the
        same ``kv_ship_timeout`` budget.

        ``migrate`` marks a migrated stream: the kv_ship opt-in and the
        break-even gate are bypassed, and the prompt pages this worker
        recomputes although the donor could have served them are counted
        in ``replayed_prefill_tokens`` (0 is a complete hand-off)."""
        r = self.runner
        peer = self._peer
        if (not self._kv_ship_ready(migrate) or peer is None or not donor
                or donor == getattr(peer, "peer_id", "")):
            return None, 0
        keys = r.chain_keys_for_prompt(prompt_ids)
        covered = r.local_prefix_coverage(keys)
        uncovered = (len(keys) - covered) * r.page_size
        mx = self.obs.metrics if self.obs is not None else None

        def _account_replay(covered_pages: int) -> None:
            if migrate and mx is not None:
                mx.replayed_prefill_tokens += (
                    max(0, len(keys) - covered_pages) * r.page_size)

        if uncovered <= 0:
            return None, 0  # local pages already cover the prompt
        if (not migrate
                and uncovered < max(1, int(self.config.kv_ship_min_tokens))):
            return None, 0  # a short tail: the round trip costs more
        timeout = max(0.5, float(self.config.kv_ship_timeout))
        deadline = time.monotonic() + timeout
        t0 = time.monotonic_ns()
        payload, err = None, None
        for attempt in range(2):
            budget = deadline - time.monotonic()
            if budget <= 0:
                break
            try:
                payload = await asyncio.wait_for(
                    self._kv_fetch_once(peer, donor, model, keys, trace_id),
                    budget)
                err = None
                break
            except Exception as e:
                err = e
                if attempt:
                    break
                # Decorrelated jitter; no retry when the backoff would eat
                # what is left of the budget.
                backoff = random.uniform(0.05, 0.15)
                if deadline - time.monotonic() <= backoff:
                    break
                if mx is not None:
                    mx.kv_ship_inc("retries")
                log.warning("kv fetch from %s failed (%s); retrying in "
                            "%.0f ms", donor, e, backoff * 1e3)
                await asyncio.sleep(backoff)
        dt = time.monotonic_ns() - t0
        if mx is not None:
            mx.kv_ship_inc("fetches")
            mx.kv_fetch_seconds.observe(dt / 1e9)
        if err is not None or payload is None:
            if mx is not None:
                mx.kv_ship_inc("fallbacks")
            if err is not None:
                log.warning("kv fetch from %s failed (%s); plain prefill",
                            donor, err)
            _account_replay(covered)
            return None, dt
        if mx is not None:
            mx.kv_ship_inc("bytes", payload.get("bytes", 0))
        # The donor's pages cover keys[:n] from the chain's start: a
        # superset or subset of the local coverage, never disjoint.
        _account_replay(max(covered, len(payload.get("keys", ()))))
        return payload, dt

    async def _kv_fetch_once(self, peer, donor: str, model: str,
                             keys: list[bytes],
                             trace_id: str = "") -> dict | None:
        """One fetch over a pooled stream to ``donor``: a
        KvFetchRequest, then KvPages frames until ``done`` (an in-band
        error raises).  None when the donor matched nothing."""
        from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL
        from crowdllama_tpu_torch.net.host import StreamPool

        await faults.inject("kv.fetch", worker=getattr(peer, "peer_id", ""),
                            donor=donor)
        # Pooled: the dial and signed hello cost more than a small fetch.
        if self._kv_streams is None:
            self._kv_streams = StreamPool(max_per_key=2)
        stream = self._kv_streams.get(donor)
        if stream is None:
            contact = await peer.dht.find_peer(donor)
            if contact is None:
                raise LookupError(f"kv donor {donor} not found in DHT")
            stream = await peer.host.new_stream(contact, INFERENCE_PROTOCOL)
        done = False
        try:
            fetch = create_kv_fetch_request(model, keys, self.runner.page_size)
            fetch.trace_id = trace_id  # the donor's kv_export joins it
            await wire.write_length_prefixed_pb(stream.writer, fetch)
            k_pages: list[bytes] = []
            v_pages: list[bytes] = []
            k_scales: list[bytes] = []
            v_scales: list[bytes] = []
            dtype = ""
            while True:
                frame = await wire.read_length_prefixed_pb(
                    stream.reader,
                    timeout=max(0.5, float(self.config.kv_ship_timeout)))
                kvp = extract_kv_pages(frame)
                if kvp.error:
                    raise RuntimeError(f"kv donor error: {kvp.error}")
                dtype = kvp.kv_dtype or dtype
                k_pages.extend(kvp.k_pages)
                v_pages.extend(kvp.v_pages)
                k_scales.extend(kvp.k_scales)
                v_scales.extend(kvp.v_scales)
                if kvp.done:
                    done = True
                    break
        finally:
            # A completed exchange leaves the stream at a frame boundary
            # (reusable); anything else may leave frames in flight.
            if done:
                self._kv_streams.put(donor, stream)
            else:
                stream.close()
        n = min(len(k_pages), len(v_pages))
        if n == 0:
            return None  # the donor matched nothing
        total = sum(len(b) for b in (*k_pages, *v_pages,
                                     *k_scales, *v_scales))
        return {"keys": keys[:n],
                "k_pages": k_pages[:n], "v_pages": v_pages[:n],
                "k_scales": k_scales[:n], "v_scales": v_scales[:n],
                "kv_dtype": dtype, "bytes": total}

    async def capture_profile(self, seconds: float = 3.0) -> str:
        """Trace ``seconds`` (0.1-60) of live serving with
        ``torch.profiler`` (CPU activity, and CUDA kernels when the engine
        serves on a card), write it as a Chrome trace
        (``<host>.pt.trace.json``) in a new directory under
        ``profile_dir/plugins/profile/`` and return that directory.

        The session opens and closes on the scheduler's dispatch thread,
        between two of its device calls, so the trace holds that thread's
        operators and the kernels it launches.  On the card, a session
        opened on another thread while the dispatch thread launches
        kernels sometimes records none of them: CUPTI hands back that
        thread's runtime calls but no kernel record
        (``obs/profiler_probe.py`` counts such sessions).  An engine not
        serving yet traces from a worker thread.  The export runs on a
        worker thread."""
        if not self.config.profile_dir:
            raise RuntimeError("profiling disabled: set profile_dir "
                               "(--profile-dir / CROWDLLAMA_TPU_PROFILE_DIR)")
        seconds = min(max(float(seconds), 0.1), 60.0)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        root = os.path.join(self.config.profile_dir, "plugins", "profile")

        def _start() -> torch.profiler.profile:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            return prof

        sched = self.scheduler
        if sched is not None and sched._exec is not None:
            prof = await sched.on_dispatch_thread(_start)
            try:
                await asyncio.sleep(seconds)
            finally:
                await sched.on_dispatch_thread(prof.stop)
        else:
            prof = await asyncio.to_thread(_start)
            try:
                await asyncio.sleep(seconds)
            finally:
                await asyncio.to_thread(prof.stop)

        def _export() -> str:
            os.makedirs(root, exist_ok=True)
            out = tempfile.mkdtemp(
                prefix=time.strftime("%Y_%m_%d_%H_%M_%S_"), dir=root)
            prof.export_chrome_trace(
                os.path.join(out, f"{os.uname().nodename}.pt.trace.json"))
            return out

        return await asyncio.to_thread(_export)

    def model_dir(self, model: str) -> str | None:
        """``model_path`` when it serves ``model`` and holds safetensors."""
        mp = self.config.model_path
        if (model in self.models and mp
                and list(Path(mp).expanduser().glob("*.safetensors"))):
            return mp
        return None

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
            d["mesh"] = r.mesh.axes
            if r.mesh.n_processes > 1:
                comms = getattr(r, "comms", {})
                d["mesh"] = {**r.mesh.axes,
                             "processes": r.mesh.n_processes,
                             "frames": "gloo",
                             "device_collectives": next(
                                 (c.backend for c in comms.values()), None),
                             "axes_across": sorted(comms)}
            d["devices"] = [str(x) for x in r.devices]
            d["kv_layout"] = r.kv_layout
            d["kv_dtype"] = r.kv_dtype
            if getattr(r, "prefix_cache", False):
                d["prefix_cache"] = {
                    "hits": r.prefix_hits,
                    "misses": r.prefix_misses,
                    "tokens_reused": r.prefix_tokens_reused,
                }
            if hasattr(r, "kv_pages_exported"):
                d["kv_ship"] = {
                    "enabled": bool(self.config.kv_ship),
                    "pages_exported": r.kv_pages_exported,
                    "pages_imported": r.kv_pages_imported,
                }
        if self.scheduler is not None and self.scheduler.spec_steps:
            d["spec_decode"] = self._spec_stats()
        if self.autotuner is not None:
            d["autotune"] = self.autotuner.describe()
        return d

    def _spec_stats(self) -> dict:
        """The ``spec_decode`` block of ``describe()``, under the JAX
        engine's keys: verify steps, tokens per step, and the accepted
        share of offered drafts split by source (prompt echo only pays on
        traffic that replays its input)."""
        s, c = self.scheduler, self.config
        steps, emitted = s.spec_steps, s.spec_emitted
        offered = steps * max(1, c.spec_draft)
        echo, gen = s.spec_accept_echo, s.spec_accept_gen
        d = {"mode": c.spec_decode, "verify_steps": steps,
             "tokens_emitted": emitted,
             "tokens_per_step": round(emitted / steps, 2),
             "acceptance_rate": round((echo + gen) / offered, 3),
             "accepted_prompt_echo": echo, "accepted_generative": gen,
             "acceptance_rate_prompt_echo": round(echo / offered, 3),
             "acceptance_rate_generative": round(gen / offered, 3)}
        if c.spec_decode == "draft":
            d["draft_model"] = c.spec_draft_model or c.spec_draft_path
        if s._spec_adaptive:
            d["adaptive"] = {"draft_len": getattr(self.runner, "draft_len", 0),
                             "draft_len_max": s.spec_draft_max,
                             "retunes": s.spec_retunes,
                             "probes": s.spec_probes}
        return d

    async def generate(  # type: ignore[override]
        self, prompt: str, model: str = "", max_tokens: int = 128,
        temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
        stop: list[str] | None = None, top_k: int = 0,
        repeat_penalty: float = 1.0, kv_donor: str = "", kv_trace: str = "",
        migrate: bool = False, remote_draft: bool = False,
        draft_feed=None,
    ) -> AsyncIterator[Chunk]:
        from crowdllama_tpu_torch.engine.scheduler import (
            DONE,
            VERIFY,
            GenRequest,
            WedgedError,
        )

        if self.scheduler is None:
            raise RuntimeError("engine not started")
        if model and model not in self.models:
            raise ValueError(f"model {model!r} not served (have {self.models})")
        prompt_ids = self.tokenizer.encode(prompt)
        kv_import, kv_ns = None, 0
        if kv_donor:
            kv_import, kv_ns = await self._fetch_kv_payload(
                kv_donor, model, prompt_ids, trace_id=kv_trace,
                migrate=migrate)
        kv_fallback = kv_import is None and kv_ns > 0
        req = GenRequest(prompt_ids=prompt_ids, max_tokens=max_tokens,
                         temperature=temperature, top_p=top_p,
                         top_k=max(0, int(top_k)),
                         repeat_penalty=float(repeat_penalty or 1.0),
                         eos_id=self.tokenizer.eos_id, seed=seed,
                         kv_import=kv_import)
        if remote_draft and draft_feed is not None:
            req.remote_draft, req.feed = True, draft_feed
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
                         queue_ns=int(q * 1e9), prefill_ns=int(p * 1e9),
                         kv_fetch_ns=kv_ns, kv_fallback=kv_fallback)

        try:
            while True:
                token, reason = await req.out.get()
                if token is VERIFY:
                    # A consumed DraftChunk credit's answer: control only.
                    yield Chunk(text="", verify=reason)
                    continue
                if token is DONE:
                    finished = True
                    if reason.startswith("error: wedged"):
                        # Typed: the self-watchdog failed this request.
                        raise WedgedError(reason[len("error: "):])
                    if reason.startswith("error"):
                        raise RuntimeError(reason)
                    yield _final(matcher.flush(), reason)
                    return
                completion += 1
                if completion == 1 and req.remote_draft:
                    # Handshake (chunk 0, never a credit): the prompt ids
                    # and the first token seed the gateway's drafter.
                    yield Chunk(text="", verify={
                        "chunk_id": 0, "position": 1, "accepted": 0,
                        "tokens": [int(token)],
                        "prompt_ids": [int(t) for t in prompt_ids]})
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
