"""MultiEngine: one worker serving several models (Ollama-style).

Counterpart of ``crowdllama_tpu/engine/multi.py``: one child
``TorchEngine`` per model name (``model="a,b,c"``) behind the same
``Engine`` seam, each request routed by its ``model`` field.  Children
share the device; their schedulers' dispatch threads interleave at the
device queue, so serving stays single-flight per child while models
multiplex the card.  Keyword arguments other than the configuration
(``device``, ``dtype``, ``seed``) go to every child.
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

    async def add_model(self, name: str, path: str = "") -> None:
        """Hot-register a model: build and start a child engine, then
        serve it."""
        if name in self._engines:
            return
        eng = TorchEngine(dataclasses.replace(
            self.config, model=name, model_path=path or self.config.model_path),
            **self._engine_kw)
        await eng.start()
        self._engines[name] = eng
        self.models = list(self._engines)
        log.info("hot-registered model %s from %s", name, path or "<default>")

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

    def generate(self, prompt: str, model: str = "", max_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 stop: list[str] | None = None, top_k: int = 0,
                 repeat_penalty: float = 1.0) -> AsyncIterator[Chunk]:
        return self._child(model).generate(
            prompt, model=model, max_tokens=max_tokens,
            temperature=temperature, top_p=top_p, seed=seed, stop=stop,
            top_k=top_k, repeat_penalty=repeat_penalty)

    async def embed(self, texts: list[str], model: str = "",
                    truncate: bool = True) -> tuple[list[list[float]], int]:
        return await self._child(model).embed(texts, model=model,
                                              truncate=truncate)

    async def capture_profile(self, seconds: float = 3.0) -> str:
        # One trace covers every child: they share the device.
        return await next(iter(self._engines.values())).capture_profile(
            seconds)
