"""Gateway-side speculative drafting.

Counterpart of ``crowdllama_tpu/gateway/draft.py``.  The gateway runs a
draft checkpoint next to the CLIENT, streams draft-token chunks ahead of
the worker over the inference stream (``DraftChunk`` frames), and the
worker batch-verifies each chunk with its hosted verify step, so the
swarm RTT is paid once per pipeline window instead of once per token.

- :class:`GatewayDrafter`: the draft model (a native or an HF
  checkpoint) on the gateway's device (the card unless the caller asks
  for the CPU): its prompt prefill runs kernel A, its greedy decode step
  kernel D over a contiguous cache; shared by every stream.
- :class:`DraftSession`: per-stream drafting state: the committed
  sequence, the outstanding speculative rollout, and the draft's cache
  kept in lockstep (a rejected tail is masked by position and
  overwritten).
- :class:`SpecPipelinePump`: per-stream flow control: keeps
  ``min(controller depth, worker depth_hint)`` chunks in flight, feeds
  the RTT / step / acceptance estimators from VerifyResult arrivals, and
  degrades to pure-ack credits (worker-draft pacing) with no drafter or
  while the controller pauses.

Correctness never depends on any of this: the worker's verify is exact
(the stream is byte-identical to plain greedy decode); drafts only decide
how many tokens each round emits.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch

from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import draft_chunk_msg
from crowdllama_tpu_torch.core.spec_pipeline import PipelineDepthController
from crowdllama_tpu_torch.engine.runner import resolve_device
from crowdllama_tpu_torch.models import transformer as T

log = logging.getLogger("crowdllama.torch.gateway.draft")


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class GatewayDrafter:
    """The gateway's draft model: one native checkpoint, a prefill and a
    greedy decode step, shared by every stream's session."""

    def __init__(self, params: dict, cfg, max_seq: int = 2048,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.max_seq = int(max_seq)
        # Rope tables cover every position a session can reach.
        self.cfg = dataclasses.replace(cfg, max_context_length=self.max_seq)

        def place(tree):
            return {k: place(v) if isinstance(v, dict) else v.to(self.device)
                    for k, v in tree.items()}

        self.params = [place(params)]
        self.rope = [T.rope_for(self.cfg, self.device)]

    @classmethod
    def from_checkpoint(cls, path: str, max_seq: int = 2048,
                        device: torch.device | str | None = None,
                        dtype: torch.dtype = torch.bfloat16
                        ) -> "GatewayDrafter":
        """Load a draft checkpoint directory (native, or HF safetensors
        with the architecture from its config.json) as the worker engine
        would."""
        from crowdllama_tpu_torch.engine.weights import (
            config_from_hf_dir,
            is_native_checkpoint,
            load_or_init_params,
            native_config_from_dir,
        )

        if is_native_checkpoint(path):
            cfg = native_config_from_dir(path)
        else:
            cfg = config_from_hf_dir(path)
        params = load_or_init_params(cfg, path, dtype=dtype)
        return cls(params, cfg, max_seq=max_seq, device=device)

    @torch.inference_mode()
    def prefill(self, toks: list[int]):
        """The draft over ``toks``: (the greedy token after them, the KV
        cache [L, 1, Hkv, max_seq, Dh] pair with the prompt written)."""
        n = len(toks)
        t = min(_bucket(n), self.max_seq)
        dev = self.device
        tokens = torch.zeros((1, t), dtype=torch.long, device=dev)
        tokens[0, :n] = torch.tensor(toks, dtype=torch.long, device=dev)
        ar = torch.arange(t, device=dev, dtype=torch.int32)
        logits, (ks,), (vs,) = T.prefill(
            self.params, self.cfg, tokens, torch.clamp(ar, max=n - 1)[None],
            kv_valid=(ar < n)[None], rope=self.rope)
        shape = list(ks.shape)
        shape[3] = self.max_seq
        k = torch.zeros(shape, dtype=ks.dtype, device=dev)
        v = torch.zeros_like(k)
        k[:, :, :, :t] = ks
        v[:, :, :, :t] = vs
        return int(logits[0, n - 1].argmax()), (k, v)

    @torch.inference_mode()
    def step(self, tok: int, pos: int, kv) -> int:
        """Ingest ``tok`` at position ``pos`` (the cache grows in place);
        returns the greedy next token."""
        dev = self.device
        k, v = kv
        logits = T.decode_step(
            self.params, self.cfg,
            torch.tensor([tok], dtype=torch.int32, device=dev),
            torch.tensor([pos], dtype=torch.int32, device=dev), k, v,
            torch.tensor([pos + 1], dtype=torch.int32, device=dev),
            rope=self.rope)[0]
        return int(logits[0].argmax())

    def session(self, prompt_ids, first_token: int) -> "DraftSession":
        return DraftSession(self, prompt_ids, first_token)


class DraftSession:
    """Per-stream draft state.

    ``seq`` is the committed sequence (prompt + every token the worker has
    verified), ``spec`` the outstanding greedy rollout beyond it, and
    ``sent`` how far into ``spec`` chunks have been shipped.  Chunk i+1 is
    positioned assuming chunk i fully accepts: the worker's generative
    emit after a full accept is the rollout's next token, so the pointer
    skips one drafted token per shipped chunk.  A partial accept drops
    the rollout and rewinds the cache watermark; the in-flight tail comes
    back as stale nacks and the pump re-drafts from the corrected prefix.
    """

    def __init__(self, drafter: GatewayDrafter, prompt_ids,
                 first_token: int):
        self.d = drafter
        self.prompt_len = len(prompt_ids)
        self.seq = [int(t) for t in prompt_ids] + [int(first_token)]
        self.spec: list[int] = []
        self.sent = 0
        self.kv = None  # the draft's (k, v), made on the first draft
        self.ingested = 0  # tokens whose KV is in the cache
        self._next = None  # the predicted token after position ingested-1

    def observe(self, tokens) -> None:
        """Fold one verify round's emitted tokens into the state."""
        for t in tokens:
            t = int(t)
            if self.spec and self.spec[0] == t:
                self.spec.pop(0)
                self.sent = max(0, self.sent - 1)
            else:
                # The rollout diverged: everything speculative is garbage,
                # its KV tail too (masked by position, overwritten next).
                self.spec = []
                self.sent = 0
                self.ingested = min(self.ingested, len(self.seq))
                self._next = None
            self.seq.append(t)

    def _extend(self, n: int) -> None:
        toks = self.seq + self.spec
        n = min(n, self.d.max_seq - len(toks) - 1)
        if n <= 0:
            return
        if self.kv is None:
            self._next, self.kv = self.d.prefill(toks)
            self.ingested = len(toks)
        while self.ingested < len(toks):
            self._next = self.d.step(toks[self.ingested], self.ingested,
                                     self.kv)
            self.ingested += 1
        for _ in range(n):
            t = int(self._next)
            self.spec.append(t)
            self._next = self.d.step(t, self.ingested, self.kv)
            self.ingested += 1

    def next_chunk(self, k: int) -> tuple[int, list[int]]:
        """(position, tokens) of the next chunk of up to ``k`` drafts.  The
        position is the worker's expected generated count when it consumes
        the chunk (pipelined: every in-flight chunk assumed fully
        accepted).  Out of context room: no tokens (the chunk is an ack)."""
        want = self.sent + int(k)
        if len(self.spec) < want + 1:
            # +1: the predicted generative token the pointer skips.
            self._extend(want + 1 - len(self.spec))
        toks = list(self.spec[self.sent:want])
        position = (len(self.seq) - self.prompt_len) + self.sent
        if toks:
            self.sent += len(toks) + 1
        return position, toks


class SpecPipelinePump:
    """Flow control for one remote-draft stream.

    The gateway's receive loop calls :meth:`on_verify` for every
    VerifyResult frame; the pump folds the observation into the depth
    controller and tops the outstanding window back up.  ``send`` is the
    async whole-frame writer of the worker stream.  With no drafter every
    chunk is a pure ack credit: worker-paced speculation over the same
    wire."""

    def __init__(self, model: str, send, drafter: GatewayDrafter | None,
                 controller: PipelineDepthController | None = None):
        self.model = model
        self._send = send
        self.drafter = drafter
        self.session: DraftSession | None = None
        self.ctrl = controller or PipelineDepthController()
        self._inflight: dict[int, tuple[float, int]] = {}
        self._next_id = 1
        self._last_verify_at = 0.0
        self.worker_k = 0
        self.worker_depth = 1
        # The gateway's crowdllama_draft_chunk_* families.
        self.chunks_sent = 0
        self.acks_sent = 0
        self.nacks = 0
        self.tokens_accepted = 0
        self.tokens_offered = 0

    async def fill(self) -> None:
        depth = min(self.ctrl.depth(), max(1, self.worker_depth))
        if self.session is None:
            # A pure-ack credit predicts nothing: stop-and-wait.
            depth = 1
        while len(self._inflight) < depth:
            k = 0
            if self.session is not None:
                k = self.ctrl.draft_k(self.worker_k)
            pos, toks = (self.session.next_chunk(k)
                         if (self.session is not None and k > 0)
                         else (0, []))
            cid = self._next_id
            self._next_id += 1
            self._inflight[cid] = (time.monotonic(), len(toks))
            if toks:
                self.chunks_sent += 1
                self.tokens_offered += len(toks)
            else:
                self.acks_sent += 1
            await self._send(wire.encode_frame(draft_chunk_msg(
                model=self.model, chunk_id=cid, position=pos, tokens=toks)))

    async def on_verify(self, vr) -> None:
        now = time.monotonic()
        self.worker_k = max(0, int(vr.draft_k))
        self.worker_depth = max(1, int(vr.depth_hint))
        if int(vr.chunk_id) == 0:
            # The handshake (never a credit): the prompt ids and the first
            # token seed the drafter's session.
            if self.drafter is not None and vr.prompt_ids and vr.tokens:
                try:
                    self.session = self.drafter.session(
                        list(vr.prompt_ids), int(vr.tokens[0]))
                except Exception as e:
                    log.warning("draft session init failed (%s); "
                                "degrading to ack pacing", e)
                    self.session = None
            await self.fill()
            return
        meta = self._inflight.pop(int(vr.chunk_id), None)
        if self._last_verify_at and self._inflight:
            # A busy pipe spaces arrivals one worker round apart.
            self.ctrl.observe_step(now - self._last_verify_at)
        self._last_verify_at = now
        if meta is not None:
            sent_at, offered = meta
            elapsed = now - sent_at
            if self.ctrl.step_ewma > 0.0:
                # Rounds queued ahead of this chunk are step time.
                q = len(self._inflight) * self.ctrl.step_ewma
                self.ctrl.observe_rtt(max(0.0, elapsed - q))
            else:
                # Cold start: rtt + one step, not yet separable.
                self.ctrl.observe_step(elapsed / 2.0)
                self.ctrl.observe_rtt(elapsed / 2.0)
            if offered:
                acc = max(0, int(vr.accepted))
                self.ctrl.observe_accept(acc, offered)
                self.tokens_accepted += min(acc, offered)
                if not vr.tokens:
                    self.nacks += 1  # a stale chunk flushed unverified
        if self.session is not None and vr.tokens:
            self.session.observe(list(vr.tokens))
        await self.fill()
