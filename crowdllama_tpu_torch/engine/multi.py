"""MultiEngine: one worker serving several models (Ollama-style).

Counterpart of ``crowdllama_tpu/engine/multi.py``: one child
``TorchEngine`` per model name (``model="a,b,c"``) behind the same
``Engine`` seam, each request routed by its ``model`` field.  Children
share the device; their schedulers' dispatch threads interleave at the
device queue, so serving stays single-flight per child while models
multiplex the card.  Keyword arguments other than the configuration
(``device``, ``dtype``, ``seed``) go to every child.  A ``kv_donor`` hint
reaches the child that serves the request's model, and a donor fetch is
answered by the child of the model it names.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import AsyncIterator

from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.engine.engine import Chunk, Engine, TorchEngine

log = logging.getLogger("crowdllama.torch.engine.multi")


class MultiEngine(Engine):
    supports_kv_donor = True

    def __init__(self, config: Configuration, **engine_kw):
        self.config = config
        self._engine_kw = engine_kw
        names = [m.strip() for m in config.model.split(",") if m.strip()]
        if not names:
            raise ValueError("MultiEngine needs >= 1 model name")
        # model_path names ONE checkpoint: it belongs to the first listed
        # model only.
        self._engines: dict[str, TorchEngine] = {
            name: TorchEngine(dataclasses.replace(
                config, model=name,
                model_path=config.model_path if i == 0 else ""), **engine_kw)
            for i, name in enumerate(names)}
        self.models = names
        self._obs = None
        self._gossip = None

    # The peer hands its NodeObs to ``engine.obs``; the children serve, so
    # the handle fans out to them.
    @property
    def obs(self):
        return self._obs

    @obs.setter
    def obs(self, value) -> None:
        self._obs = value
        for eng in self._engines.values():
            eng.obs = value

    def attach_peer(self, peer) -> None:
        self._peer = peer
        for eng in self._engines.values():
            eng.attach_peer(peer)

    def set_gossip(self, gossip) -> None:
        """Every child tunes its own model, so each gets the node's
        GossipNode (a model added later too)."""
        self._gossip = gossip
        for eng in self._engines.values():
            eng.set_gossip(gossip)

    def _child(self, model: str) -> TorchEngine:
        if not model:
            raise ValueError(
                f"model is required (serving {sorted(self._engines)})")
        eng = self._engines.get(model)
        if eng is None:
            raise ValueError(
                f"model {model!r} not served (have {sorted(self._engines)})")
        return eng

    async def start(self) -> None:
        from crowdllama_tpu_torch.parallel import multihost

        if multihost.process_count() > 1 and len(self._engines) > 1:
            # Each child would wrap its runner in a ReplicatedRunner and
            # interleave frame streams the single follower replay loop
            # (parallel/replicated.py) cannot represent.  One child is
            # fine: one stream.
            raise ValueError(
                "multi-model workers do not compose with multi-host "
                "serving (one replicated engine per cluster)")
        # Sequential: children build and warm up on the same device.
        for name, eng in self._engines.items():
            log.info("starting child engine for %s", name)
            await eng.start()

    async def stop(self) -> None:
        await asyncio.gather(*(e.stop() for e in self._engines.values()),
                             return_exceptions=True)

    async def drain(self, timeout: float = 30.0) -> bool:
        results = await asyncio.gather(
            *(e.drain(timeout) for e in self._engines.values()))
        return all(results)

    async def migrate(self) -> int:
        moved = await asyncio.gather(
            *(e.migrate() for e in self._engines.values()))
        return sum(moved)

    def model_dir(self, model: str) -> str | None:
        eng = self._engines.get(model)
        return eng.model_dir(model) if eng is not None else None

    async def add_model(self, name: str, path: str = "") -> None:
        """Hot-register a model (a swarm pull landing, net/model_share.py):
        build and start a child engine, then advertise the new list."""
        if name in self._engines:
            return
        eng = TorchEngine(dataclasses.replace(
            self.config, model=name, model_path=path or self.config.model_path),
            **self._engine_kw)
        eng.obs = self._obs
        eng.attach_peer(self._peer)
        eng.set_gossip(self._gossip)
        await eng.start()
        self._engines[name] = eng
        self.models = list(self._engines)
        if self._peer is not None:
            self._peer.update_metadata()  # advertise without waiting a tick
        log.info("hot-registered model %s from %s", name, path or "<default>")

    # Point-in-time gauges take the max across children; depths and
    # counts sum.
    _GAUGE_MAX = frozenset({"batch_occupancy", "kv_cache_utilization",
                            "spec_draft_len", "step_token_budget_used",
                            "tokens_per_dispatch", "autotune_score"})

    def obs_gauges(self) -> dict:
        out: dict = {}
        for eng in self._engines.values():
            for k, v in eng.obs_gauges().items():
                if (k in self._GAUGE_MAX or k.startswith("duty_cycle")
                        or k.startswith("autotune_dial")):
                    out[k] = max(out.get(k, 0.0), v)
                else:
                    out[k] = out.get(k, 0.0) + v
        return out

    def describe(self) -> dict:
        per = {name: e.describe() for name, e in self._engines.items()}
        return {
            "models": self.models,
            "embeddings": any(d.get("embeddings", True)
                              for d in per.values()),
            "throughput": round(sum(d["throughput"] for d in per.values()), 2),
            "load": round(max(d["load"] for d in per.values()), 3),
            "engines": per,
        }

    def _format_chat(self, messages: list[dict], model: str = "") -> str:
        return self._child(model)._format_chat(messages, model=model)

    def _migrate_export_meta(self, req) -> tuple[list[bytes], int]:
        eng = self._engines.get(req.model)
        return eng._migrate_export_meta(req) if eng is not None else ([], 0)

    @property
    def supports_remote_draft(self) -> bool:  # type: ignore[override]
        """Any child verifies remote drafts (a request for another child
        streams unpaced)."""
        return any(e.supports_remote_draft for e in self._engines.values())

    def _verify_frame_fields(self) -> tuple[int, int]:
        return max((e._verify_frame_fields() for e in self._engines.values()),
                   default=(0, 1))

    def generate(self, prompt: str, model: str = "", max_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 stop: list[str] | None = None, top_k: int = 0,
                 repeat_penalty: float = 1.0, kv_donor: str = "",
                 kv_trace: str = "", migrate: bool = False,
                 **remote) -> AsyncIterator[Chunk]:
        child = self._child(model)
        if not child.supports_remote_draft:
            remote = {}  # remote_draft / draft_feed: this child cannot pace
        return child.generate(
            prompt, model=model, max_tokens=max_tokens,
            temperature=temperature, top_p=top_p, seed=seed, stop=stop,
            top_k=top_k, repeat_penalty=repeat_penalty, kv_donor=kv_donor,
            kv_trace=kv_trace, migrate=migrate, **remote)

    async def export_kv_pages(self, model: str, chain_hashes: list[bytes],
                              page_size: int) -> dict | None:
        eng = self._engines.get(model)
        if eng is None:
            return None
        return await eng.export_kv_pages(model, chain_hashes, page_size)

    async def embed(self, texts: list[str], model: str = "",
                    truncate: bool = True) -> tuple[list[list[float]], int]:
        return await self._child(model).embed(texts, model=model,
                                              truncate=truncate)

    def _live_streams(self, eng: TorchEngine) -> int:
        """Streams a child holds: its occupied slots and its queue."""
        sched = eng.scheduler
        if sched is None:
            return 0
        return (sum(1 for s in sched.slots if s is not None)
                + sched.pending.qsize() + len(sched._deferred))

    async def capture_profile(self, seconds: float = 3.0) -> str:
        """The profile of the child serving the most live streams (the
        first on a tie): a session opens on one child's dispatch thread
        and may hold no kernel another thread launched
        (``TorchEngine.capture_profile``), so it opens where the work
        is.  Logs which child it traced."""
        name, eng = max(self._engines.items(),
                        key=lambda kv: self._live_streams(kv[1]))
        log.info("capture_profile: tracing %s (%d live streams)", name,
                 self._live_streams(eng))
        return await eng.capture_profile(seconds)
