"""ShardedEngine: multi-worker sharded serving behind the Engine seam.

Counterpart of ``crowdllama_tpu/engine/sharded.py``: a node started with
``--shard-group G --shard-index i --shard-count N [--shard-strategy pp|ep]``
serves one shard of an N-way split.  Every member registers the
``SHARD_PROTOCOL`` stream service and advertises a ``ShardGroup`` in its
Resource; the peer manager (``peermanager/manager.py``) routes requests
for the model to the group leader (shard_index 0) once, and only while,
the group is complete.

Strategies:

- **"pp"**: member i serves layer slice i (``engine/shard_service.py``).
  The leader is itself stage 0: it assembles the stage chain (LocalStage
  + one RemoteStage per member found through the DHT, connections pooled
  across requests), drives SwarmPipeline prefill/decode, samples on the
  host and streams tokens.
- **"ep"** (MoE models): member i hosts experts ``e % N == i`` for every
  layer (``engine/expert_service.py``).  The leader runs attention,
  router and KV locally and dispatches per-expert token batches to the
  banks, combining the weighted outputs.

Either way, a member failure mid-request drops the pooled connections so
the next request re-resolves the (possibly re-formed) group; the health
machine marks the dead member unhealthy, which makes the group incomplete
and the leader unroutable until it recovers.  The wire is the JAX
package's, so a group may mix members of both packages.

A member holds only its share on its device (the card unless the caller
passes ``device="cpu"``; without CUDA construction raises), in bf16: its
layer slice, or its experts plus, on the leader, attention, router and
the embeddings.  A checkpoint (``model_path``) is read on the host and
the runners place their share of it; without one, the share is drawn
piece by piece on the device from seed 0 (``engine/weights.py
init_params_slice``), so every member holds the weights of one model.
Sampling runs on the leader's host with a numpy ``Generator``, as JAX's
does, so a seeded request samples the same tokens on a JAX leader and a
torch leader that see the same logits.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import uuid
from typing import AsyncIterator

import numpy as np
import torch

from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.core.resource import ShardGroup
from crowdllama_tpu_torch.engine.engine import Chunk, Engine, StopMatcher
from crowdllama_tpu_torch.engine.runner import resolve_device

log = logging.getLogger("crowdllama.torch.engine.sharded")


def _ngram_drafts(history: list[int], k: int) -> list[int]:
    """Host-side bigram prompt-lookup drafts (the n-gram proposer of
    engine/spec.py, B=1 on plain Python lists): find the LATEST earlier
    occurrence of the trailing bigram and draft the k tokens that followed
    it; no match -> zero-padded drafts the first verify mismatch rejects."""
    if len(history) >= 2:
        a, b = history[-2], history[-1]
        for i in range(len(history) - 3, -1, -1):
            if history[i] == a and history[i + 1] == b:
                cont = history[i + 2:i + 2 + k]
                return (cont + [0] * k)[:k]
    return [0] * k


def sample_host(logits: np.ndarray, temperature: float, top_p: float,
                rng: np.random.Generator, top_k: int = 0,
                recent: "list[int] | None" = None,
                repeat_penalty: float = 1.0) -> int:
    """Greedy / temperature / nucleus sampling on the leader host.

    The pipeline returns one [V] logits vector per step; sampling here is
    trivial work next to a network round trip.  Nucleus over the top
    ``TOPK_WINDOW`` logits (greedy exact), as the single-worker sampler.
    """
    from crowdllama_tpu_torch.engine.sampling import REPEAT_LAST_N, TOPK_WINDOW

    if repeat_penalty > 0 and repeat_penalty != 1.0 and recent:
        logits = logits.copy()
        for t in set(recent[-REPEAT_LAST_N:]):
            logits[t] = (logits[t] / repeat_penalty if logits[t] > 0
                         else logits[t] * repeat_penalty)
    if temperature <= 0:
        return int(logits.argmax())
    w = min(TOPK_WINDOW, logits.shape[-1])
    if top_k > 0:
        w = min(w, top_k)
    top = np.argpartition(logits, -w)[-w:]
    top = top[np.argsort(logits[top])[::-1]]  # descending
    x = logits[top].astype(np.float64) / max(temperature, 1e-6)
    x -= x.max()
    probs = np.exp(x)
    probs /= probs.sum()
    if top_p < 1.0:
        cum = np.cumsum(probs)
        keep = (cum - probs) < top_p
        keep[0] = True  # the top token always survives
        probs = np.where(keep, probs, 0.0)
        probs /= probs.sum()
    return int(top[rng.choice(w, p=probs)])


class ShardedEngine(Engine):
    """One member of a sharded model group (leader when index 0).

    ``device`` and ``model_config`` (a ``ModelConfig`` served in place of
    the registry's entry, e.g. a copy cut to fewer layers) as
    ``TorchEngine``'s."""

    #: the weights' and activations' dtype on the device (JAX's members
    #: serve bf16 too)
    dtype = torch.bfloat16

    def __init__(self, config: Configuration | None = None, *,
                 device: torch.device | str | None = None,
                 model_config=None, **overrides):
        self.config = config or Configuration.from_environment()
        for k, v in overrides.items():
            setattr(self.config, k, v)
        if self.config.shard_count < 2:
            raise ValueError("ShardedEngine needs shard_count >= 2")
        if not (0 <= self.config.shard_index < self.config.shard_count):
            raise ValueError(
                f"shard_index {self.config.shard_index} out of range for "
                f"shard_count {self.config.shard_count}")
        self.strategy = self.config.shard_strategy
        if self.strategy not in ("pp", "ep"):
            raise ValueError(f"unknown shard strategy {self.strategy!r}")
        self.group_id = (
            self.config.shard_group
            or f"{self.config.model}/{self.strategy}{self.config.shard_count}")
        self.shard_index = self.config.shard_index
        self.shard_count = self.config.shard_count
        self.is_leader = self.shard_index == 0
        self.models = [self.config.model]
        self.device = resolve_device(device)
        self._model_config = model_config

        self.shard_service = None  # registered on SHARD_PROTOCOL by Peer
        self.runner = None
        self.tokenizer = None
        self._peer = None
        self._pipeline = None  # leader: cached pipeline over pooled streams
        self._pipeline_lock = asyncio.Lock()
        self._sem: asyncio.Semaphore | None = None
        self._active = 0
        self._draining = False
        self._tput_ema = 0.0
        self._rng = np.random.default_rng(0)
        # Cross-worker speculative decoding telemetry.
        self._spec_steps = 0
        self._spec_emitted = 0
        # Set when a group member rejects the 'verify' op (older release):
        # later requests go per-token instead of failing on every try.
        self._verify_unsupported = False

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        from crowdllama_tpu_torch.engine.tokenizer import get_tokenizer
        from crowdllama_tpu_torch.engine.weights import (
            resolve_clamped_model_config,
        )

        c = self.config
        if self._model_config is not None:
            cfg = self._model_config
            if c.max_context_length:
                cfg = dataclasses.replace(cfg, max_context_length=min(
                    cfg.max_context_length, c.max_context_length))
        else:
            cfg = resolve_clamped_model_config(c)
        if self.strategy == "ep" and not cfg.is_moe:
            raise ValueError(
                f"shard strategy 'ep' needs an MoE model; {cfg.name} is dense")
        if self.strategy == "ep" and c.quantize:
            # Expert banks slice raw weight arrays; int8 there is future
            # work: reject loudly rather than silently serving bf16.
            raise ValueError("quantize is not supported with shard strategy "
                             "'ep' yet (use 'pp' or unsharded)")
        if c.kv_layout == "paged":
            # Shard stages hold per-session B=1 caches, not slot pools: a
            # shared page pool has nothing to pool over here, so the paged
            # layout does not apply (contiguous per-session caches are
            # used).
            log.info("sharded engines use per-session contiguous caches; "
                     "kv_layout='paged' does not apply")
        self.cfg = cfg
        loop = asyncio.get_running_loop()
        build = self._build_pp if self.strategy == "pp" else self._build_ep
        await loop.run_in_executor(None, build)
        if self.is_leader:
            self.tokenizer = get_tokenizer(c.model_path)
            self._sem = asyncio.Semaphore(c.max_batch_slots)
        log.info("shard member up: group=%s strategy=%s index=%d/%d%s",
                 self.group_id, self.strategy, self.shard_index,
                 self.shard_count, " (leader)" if self.is_leader else "")

    def _share(self, **share) -> dict:
        """This member's weights: a checkpoint read on the host (the
        runners place their share of it), or the share drawn on the
        device from seed 0."""
        from crowdllama_tpu_torch.engine.weights import (
            init_params_slice,
            load_or_init_params,
        )

        if self.config.model_path:
            return load_or_init_params(self.cfg, self.config.model_path,
                                       dtype=self.dtype)
        return init_params_slice(self.cfg, 0, dtype=self.dtype,
                                 device=self.device, **share)

    def _build_pp(self) -> None:
        from crowdllama_tpu_torch.engine.shard_service import (
            ShardStageRunner,
            ShardStageService,
        )

        per = self.cfg.num_layers // self.shard_count
        lo = self.shard_index * per
        params = self._share(layers=range(lo, lo + per),
                             embed=self.is_leader)
        if self.config.quantize:
            from crowdllama_tpu_torch.ops.quant import quantize_params

            # Where the weights are: a drawn share on the device, a
            # checkpoint on the host (the stage places its slice).
            params = quantize_params(params, mode=self.config.quantize)
        self.runner = ShardStageRunner(
            self.cfg, params, self.shard_index, self.shard_count,
            max_seq=self.cfg.max_context_length, dtype=self.dtype,
            device=self.device)
        self._embed_params = (
            {k: v for k, v in params.items() if k != "layers"}
            if self.is_leader else None)
        self.shard_service = ShardStageService(self.runner)

    def _build_ep(self) -> None:
        from crowdllama_tpu_torch.engine.expert_service import (
            EPLeaderRunner,
            ExpertBankRunner,
            ExpertBankService,
            assign_experts,
        )
        from crowdllama_tpu_torch.engine.weights import EXPERT_KEYS

        self.expert_ids = assign_experts(
            self.cfg.num_experts, self.shard_count, self.shard_index)
        keys = EXPERT_KEYS
        if self.is_leader:
            keys += EPLeaderRunner.layer_keys(self.cfg)
        params = self._share(experts=self.expert_ids, layer_keys=keys,
                             embed=self.is_leader)
        self.bank = ExpertBankRunner(self.cfg, params, self.expert_ids,
                                     dtype=self.dtype, device=self.device)
        self.shard_service = ExpertBankService(self.bank)
        self.runner = (EPLeaderRunner(self.cfg, params,
                                      max_seq=self.cfg.max_context_length,
                                      dtype=self.dtype, device=self.device)
                       if self.is_leader else None)

    async def drain(self, timeout: float = 30.0) -> bool:
        """Wait for in-flight sharded generations before shutdown (the
        pipeline streams close at stop(), severing anything still active);
        new generations are rejected so clients fail over.

        Leaders wait on their own request count; members also wait for the
        leader's live KV sessions hosted here (shard_service) to release:
        stopping a member mid-pipeline kills the leader's stream."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while True:
            member_sessions = 0
            svc = self.shard_service
            if svc is not None:
                counter = getattr(getattr(svc, "runner", None),
                                  "session_count", None)
                if counter is not None:
                    member_sessions = counter() if callable(counter) else counter
            if self._active == 0 and member_sessions == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(0.1)

    async def stop(self) -> None:
        async with self._pipeline_lock:
            if self._pipeline is not None:
                self._pipeline.close()
                self._pipeline = None

    def describe(self) -> dict:
        d = {}
        if self._spec_steps:
            d["spec_decode"] = {
                "mode": "ngram (cross-worker verify)",
                "verify_steps": self._spec_steps,
                "tokens_emitted": self._spec_emitted,
                "tokens_per_step": round(
                    self._spec_emitted / self._spec_steps, 2),
            }
        return {
            **d,
            "models": self.models,
            "throughput": round(self._tput_ema, 2),
            # Sharded engines have no embeddings path (Engine.embed raises
            # NotImplementedError): advertise it so the gateway never
            # routes /api/embed here (Resource.embeddings).
            "embeddings": False,
            "load": round(self._active / max(self.config.max_batch_slots, 1), 3),
            "shard_group": ShardGroup(
                group_id=self.group_id,
                model=self.config.model,
                strategy=self.strategy,
                shard_index=self.shard_index,
                shard_count=self.shard_count,
                expert_ids=list(getattr(self, "expert_ids", [])),
            ),
        }

    # ------------------------------------------------------ stage assembly

    async def _dial_members(self) -> dict[int, tuple]:
        """Resolve and dial every non-leader member's SHARD_PROTOCOL; returns
        {shard_index: (PeerInfo, Stream)}.  Caller owns the streams."""
        from crowdllama_tpu_torch.core.protocol import SHARD_PROTOCOL

        if self._peer is None or self._peer.peer_manager is None:
            raise RuntimeError("shard leader not attached to a peer")
        members = self._peer.peer_manager.group_members(self.group_id)
        by_index = {p.resource.shard_group.shard_index: p for p in members}
        missing = [i for i in range(1, self.shard_count) if i not in by_index]
        if missing:
            raise RuntimeError(
                f"shard group {self.group_id} incomplete: "
                f"missing indices {missing}")
        dialed: dict[int, tuple] = {}
        try:
            for i in range(1, self.shard_count):
                info = by_index[i]
                contact = self._peer.host.peerstore.get(info.peer_id)
                if contact is None:
                    contact = await self._peer.dht.find_peer(info.peer_id)
                if contact is None:
                    raise RuntimeError(
                        f"shard member {info.peer_id[:8]} not dialable")
                stream = await self._peer.host.new_stream(
                    contact, SHARD_PROTOCOL)
                dialed[i] = (info, stream)
        except Exception:
            for _, stream in dialed.values():
                stream.close()
            raise
        return dialed

    async def _resolve_pipeline(self):
        """Build (or reuse) the pipeline over the current group: dials each
        remote member's SHARD_PROTOCOL once and pools the streams."""
        from crowdllama_tpu_torch.engine.expert_service import (
            EPPipeline,
            LocalExpertBank,
            RemoteExpertBank,
        )
        from crowdllama_tpu_torch.engine.shard_service import (
            LocalStage,
            RemoteStage,
            SwarmPipeline,
        )

        async with self._pipeline_lock:
            if self._pipeline is not None:
                return self._pipeline
            dialed = await self._dial_members()
            try:
                if self.strategy == "pp":
                    stages: list = [LocalStage(self.runner)]
                    for i in range(1, self.shard_count):
                        stages.append(RemoteStage(dialed[i][1]))
                    self._pipeline = SwarmPipeline(
                        self.cfg, self._embed_params, stages,
                        dtype=self.dtype, device=self.device)
                else:
                    banks: list = [LocalExpertBank(self.bank)]
                    for i in range(1, self.shard_count):
                        info, stream = dialed[i]
                        advertised = list(info.resource.shard_group.expert_ids)
                        banks.append(RemoteExpertBank(stream, advertised))
                    self._pipeline = EPPipeline(self.cfg, self.runner, banks)
            except Exception:
                # e.g. EPPipeline's expert-coverage check on a stale
                # advertisement: don't leak the freshly dialed streams.
                for _, stream in dialed.values():
                    stream.close()
                raise
            log.info("shard group %s assembled (%s, %d members)",
                     self.group_id, self.strategy, self.shard_count)
            return self._pipeline

    async def _drop_pipeline(self) -> None:
        async with self._pipeline_lock:
            if self._pipeline is not None:
                self._pipeline.close()
                self._pipeline = None

    # ----------------------------------------------------------- inference

    async def generate(  # type: ignore[override]
        self,
        prompt: str,
        model: str = "",
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        stop: list[str] | None = None,
        top_k: int = 0,
        repeat_penalty: float = 1.0,
    ) -> AsyncIterator[Chunk]:
        if not self.is_leader:
            raise RuntimeError(
                f"shard member {self.shard_index} of {self.group_id} does not "
                "serve requests; the group leader routes")
        if self._draining:
            raise RuntimeError("worker is draining for shutdown")
        if model and model not in self.models:
            raise ValueError(f"model {model!r} not served (have {self.models})")

        prompt_ids = self.tokenizer.encode(prompt)
        max_seq = self.cfg.max_context_length
        if len(prompt_ids) >= max_seq:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds context {max_seq}")
        bucket = 16
        while bucket < len(prompt_ids):
            bucket *= 2
        bucket = min(bucket, max_seq)
        budget = min(max_tokens, max_seq - len(prompt_ids))

        pipeline = await self._resolve_pipeline()
        session = uuid.uuid4().hex
        decoder = self.tokenizer.stream_decoder()
        matcher = StopMatcher(stop)
        tail = ""  # pre-match text carried into the final chunk on stop
        completion = 0
        t0 = time.monotonic()
        # Seeded requests sample from a private generator so identical
        # seeds reproduce identical tokens.
        rng = np.random.default_rng(seed) if seed else self._rng
        async with self._sem:
            self._active += 1
            try:
                history = list(prompt_ids)
                logits = await pipeline.prefill(session, prompt_ids, bucket)
                token = sample_host(logits, temperature, top_p, rng,
                                    top_k=top_k, recent=history,
                                    repeat_penalty=repeat_penalty)
                history.append(token)
                n = len(prompt_ids)
                reason = "length"
                # Cross-worker speculative decoding: cross-worker decode is
                # bound by network latency (one round trip per stage, pp,
                # or per layer's expert dispatch, ep, per token), so on
                # greedy requests the leader drafts by n-gram lookup and
                # verifies the whole window in ONE trip, emitting up to
                # 1+k tokens per round trip.  Greedy-exact (drafts change
                # how many tokens per trip, never which); penalized or
                # sampled requests keep the per-token path.
                draft_k = max(1, self.config.spec_draft)
                use_spec = (self.config.spec_decode == "ngram"
                            and temperature <= 0.0
                            and repeat_penalty == 1.0
                            and not self._verify_unsupported
                            and hasattr(pipeline, "verify"))
                pending: list[int] = []  # verified tokens awaiting emission
                while True:
                    completion += 1
                    if token == self.tokenizer.eos_id:
                        reason = "stop"
                        break
                    text = decoder.feed(token)
                    if text:
                        emit, stopped = matcher.feed(text)
                        if stopped:
                            tail = emit  # excludes the matched stop
                            reason = "stop"
                            break
                        if emit:
                            yield Chunk(text=emit)
                    if completion >= budget:
                        break
                    if pending:
                        token = pending.pop(0)
                        history.append(token)
                        n += 1
                        self._spec_emitted += 1  # consumed, counts at use
                        continue
                    if use_spec and n + draft_k + 1 <= max_seq:
                        window = [token] + _ngram_drafts(history, draft_k)
                        try:
                            wlogits = await pipeline.verify(session, window,
                                                            n)
                        except RuntimeError as e:
                            if "unknown op" in str(e):
                                # A pre-verify group member: remember and
                                # fail this request (the old handler left
                                # the stream desynced); the gateway retry
                                # and all later requests run per-token.
                                self._verify_unsupported = True
                                log.warning(
                                    "group member lacks the verify op; "
                                    "disabling cross-worker speculation")
                            raise
                        model_next = wlogits.argmax(axis=-1)
                        a = 0
                        while (a < draft_k
                               and window[a + 1] == int(model_next[a])):
                            a += 1
                        self._spec_steps += 1
                        self._spec_emitted += 1  # emitted[0], consumed now
                        emitted = [int(t) for t in model_next[:a + 1]]
                        token = emitted[0]
                        pending = emitted[1:]
                        history.append(token)
                        n += 1
                        continue
                    logits = await pipeline.decode(session, token, n, n + 1)
                    token = sample_host(logits, temperature, top_p, rng,
                                        top_k=top_k, recent=history,
                                        repeat_penalty=repeat_penalty)
                    history.append(token)
                    n += 1
                dt = max(time.monotonic() - t0, 1e-6)
                inst = completion / dt
                self._tput_ema = (inst if self._tput_ema == 0.0
                                  else 0.8 * self._tput_ema + 0.2 * inst)
                yield Chunk(text=tail + matcher.flush(), done=True,
                            done_reason=reason,
                            prompt_tokens=len(prompt_ids),
                            completion_tokens=completion)
            except (ConnectionError, asyncio.IncompleteReadError, OSError,
                    asyncio.TimeoutError, RuntimeError):
                # A stage died or desynchronized: drop pooled connections so
                # the next request re-resolves the group.
                await self._drop_pipeline()
                raise
            finally:
                self._active -= 1
                # Release on the pipeline this request ran on (NOT
                # self._pipeline, which a failure just nulled): local-stage
                # and leader KV sessions must be freed even when remote
                # stages are already gone, or failed requests leak device
                # memory.
                try:
                    await pipeline.release(session)
                except Exception:
                    log.debug("session release failed", exc_info=True)
