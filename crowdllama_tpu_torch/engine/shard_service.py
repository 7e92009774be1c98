"""Cross-worker model sharding: pipeline stages over the swarm.

Counterpart of ``crowdllama_tpu/engine/shard_service.py``: a model too big
for one worker is split into contiguous layer slices; each worker of a
shard group (``core/resource.py ShardGroup``, strategy "pp") serves its
slice behind the ``/crowdllama/shard/1.0.0`` stream protocol, holding
per-session KV caches for its layers.  The group leader (shard_index 0)
embeds, drives the activations through the stages in order, unembeds and
samples (``engine/sharded.py``).

Wire format per call: one JSON header frame (op, session, scalars)
followed by zero or one tensor (a ``dtype``/``shape`` JSON frame, then a
big-endian length and the raw bytes); replies are ``{"ok": true, ...}``
plus an optional tensor, or ``{"ok": false, "error": ...}``.  The bytes
are the JAX package's, so one group may mix workers of both packages.

A stage runs on its device (the card unless the caller passes
``device="cpu"``): prefill through ``T.scan_prefill_layers`` (kernel A),
decode through ``T.scan_decode_layers`` over the session's contiguous
cache (kernel D), and the speculative verify window through the plain
prefix-context attention (``prefill_attention_ctx``, jnp in JAX as well).
Activations enter and leave as float32 numpy arrays.  ``prefill_attn`` and
``decode_attn`` are seams that let a check run the same stage through the
plain versions.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Any

import numpy as np
import torch

from crowdllama_tpu_torch.engine.runner import resolve_device
from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.net.host import (
    HandshakeError,
    Stream,
    read_json_frame,
    write_json_frame,
)
from crowdllama_tpu_torch.ops.attention import (
    decode_attention,
    prefill_attention,
)

log = logging.getLogger("crowdllama.torch.engine.shard")

_LEN = struct.Struct(">I")
MAX_TENSOR_BYTES = 512 * 1024 * 1024  # activations, not weights
STAGE_CALL_TIMEOUT = 120.0
# A stage stream with no traffic for this long is presumed abandoned by its
# leader and closed (the read loop never parks forever on a dead-but-open
# connection).
STREAM_IDLE_TIMEOUT = 600.0


# ------------------------------------------------------------ tensor frames

async def write_tensor(writer: asyncio.StreamWriter, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    await write_json_frame(
        writer, {"dtype": str(arr.dtype), "shape": list(arr.shape)})
    raw = arr.tobytes()
    if len(raw) > MAX_TENSOR_BYTES:
        raise ValueError(f"tensor too large: {len(raw)}")
    writer.write(_LEN.pack(len(raw)) + raw)
    await writer.drain()


async def read_tensor(reader: asyncio.StreamReader,
                      timeout: float | None = None) -> np.ndarray:
    async def _read() -> np.ndarray:
        header = await read_json_frame(reader)
        (length,) = _LEN.unpack(await reader.readexactly(_LEN.size))
        if length > MAX_TENSOR_BYTES:
            raise ValueError(f"tensor too large: {length}")
        raw = await reader.readexactly(length)
        return np.frombuffer(raw, dtype=np.dtype(header["dtype"])).reshape(
            header["shape"])

    if timeout is None:
        return await _read()
    return await asyncio.wait_for(_read(), timeout)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a float32 numpy array (what crosses the wire)."""
    return t.float().cpu().numpy()


def device_tensor(x: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """A received numpy array (read-only: it views the frame's bytes) on
    ``device`` in ``dtype``."""
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def place(leaf, device, dtype: torch.dtype):
    """A weight on ``device``: floating leaves in ``dtype``, integer ones
    (and a quantized weight's int8 values) in their own."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device=device, dtype=(
            dtype if leaf.is_floating_point() else leaf.dtype))
    return leaf.to(device)


# ------------------------------------------------------------- stage runner

class ShardStageRunner:
    """One worker's pipeline stage: a contiguous layer slice with prefill
    and decode over per-session KV caches.

    Sessions are leader-assigned ids; each holds this stage's KV for one
    in-flight sequence (B=1), a contiguous cache [L_local, 1, Hkv, S, Dh].
    The leader calls prefill once, decode per token, release at the end;
    sessions prefilled over a stream that dies are released by the
    service when the stream closes.

    ``params["layers"]`` leaves hold every layer of the model (the stage
    slices its range) or exactly this stage's range; only the slice is
    placed on ``device``.  The sliding windows are the model's, sliced by
    global layer index.
    """

    def __init__(self, cfg: ModelConfig, params: dict,
                 shard_index: int, shard_count: int,
                 max_seq: int = 0, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None):
        assert cfg.num_layers % shard_count == 0, (
            f"{cfg.num_layers} layers not divisible by {shard_count} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.max_seq = max_seq or cfg.max_context_length
        self.dtype = dtype
        self.device = resolve_device(device)
        l_local = cfg.num_layers // shard_count
        lo = shard_index * l_local
        self.layer_range = (lo, lo + l_local)

        def _slice(a):
            if a.shape[0] == cfg.num_layers:
                a = a[lo:lo + l_local]
            elif a.shape[0] != l_local:
                raise ValueError(f"layer leaf of {a.shape[0]} layers: want "
                                 f"{cfg.num_layers} or this stage's "
                                 f"{l_local}")
            return place(a, self.device, dtype)

        self.layers = {k: _slice(v) for k, v in params["layers"].items()}
        self.windows = T.layer_sliding_windows(cfg)[lo:lo + l_local]
        self.rope = T.rope_for(cfg, self.device)
        self._sessions: dict[str, dict[str, Any]] = {}
        #: no-context prefill attention (kernel A) and contiguous decode
        #: attention (kernel D); seams that let a caller run the same
        #: stage through the plain versions
        self.prefill_attn = prefill_attention
        self.decode_attn = decode_attention

    def _cache(self) -> torch.Tensor:
        l_local = self.layer_range[1] - self.layer_range[0]
        hkv, dh = self.cfg.num_kv_heads, self.cfg.resolved_head_dim()
        return torch.zeros((l_local, 1, hkv, self.max_seq, dh),
                           dtype=self.dtype, device=self.device)

    @torch.inference_mode()
    def prefill(self, session: str, x: np.ndarray, plen: int) -> np.ndarray:
        """x: [1, T, D] activations entering this stage; returns [1, T, D].
        Creates the session cache seeded with the prompt's KV."""
        t = x.shape[1]
        ar = torch.arange(t, device=self.device, dtype=torch.int32)
        positions = torch.clamp(ar, max=plen - 1)[None]
        kv_valid = (ar < plen)[None]
        y, ks, vs = T.scan_prefill_layers(
            [self.layers], self.windows, self.cfg,
            device_tensor(x, self.device, self.dtype), positions,
            kv_valid=kv_valid, attention=self.prefill_attn, rope=[self.rope])
        kc, vc = self._cache(), self._cache()
        kc[:, :, :, :t] = ks[0]
        vc[:, :, :, :t] = vs[0]
        self._sessions[session] = {"kc": kc, "vc": vc}
        return host_array(y)

    @torch.inference_mode()
    def decode(self, session: str, x: np.ndarray, position: int,
               seq_len: int) -> np.ndarray:
        """x: [1, D] activation of the new token; returns [1, D]."""
        sess = self._sessions[session]
        i32 = dict(dtype=torch.int32, device=self.device)
        y = T.scan_decode_layers(
            [self.layers], self.windows, self.cfg,
            device_tensor(x, self.device, self.dtype),
            torch.tensor([position], **i32), sess["kc"], sess["vc"],
            torch.tensor([seq_len], **i32), [self.rope],
            attention=self.decode_attn)
        return host_array(y)

    @torch.inference_mode()
    def verify(self, session: str, x: np.ndarray, start: int) -> np.ndarray:
        """x: [1, J, D] activations of a pending+drafts window starting at
        position ``start``; returns [1, J, D].  The window attends jointly
        over the session cache as context (positions < ``start`` valid;
        rejected drafts beyond the last accepted token are masked out by
        the next call's smaller start) and causally within itself, then
        its K/V are written at ``start``.  One network round trip carries
        J tokens."""
        sess = self._sessions[session]
        j = x.shape[1]
        positions = (start + torch.arange(j, device=self.device,
                                          dtype=torch.int32))[None]
        ctx_valid = (torch.arange(self.max_seq, device=self.device)
                     < start)[None]
        y, ks, vs = T.scan_prefill_layers(
            [self.layers], self.windows, self.cfg,
            device_tensor(x, self.device, self.dtype), positions,
            ctx_k=[sess["kc"]], ctx_v=[sess["vc"]], ctx_valid=ctx_valid,
            rope=[self.rope])
        sess["kc"][:, :, :, start:start + j] = ks[0]
        sess["vc"][:, :, :, start:start + j] = vs[0]
        return host_array(y)

    def release(self, session: str) -> None:
        self._sessions.pop(session, None)

    @property
    def session_count(self) -> int:
        return len(self._sessions)


# ------------------------------------------------------------ service side

class ShardStageService:
    """Stream handler serving a ShardStageRunner over SHARD_PROTOCOL."""

    def __init__(self, runner: ShardStageRunner,
                 idle_timeout: float = STREAM_IDLE_TIMEOUT):
        self.runner = runner
        self.idle_timeout = idle_timeout

    async def handle(self, stream: Stream) -> None:
        loop = asyncio.get_running_loop()
        # Sessions prefilled over this stream: their KV caches are released
        # when the stream dies (idle timeout / leader crash), not only on an
        # explicit release op, or an abandoned leader leaks device memory
        # on the worker forever.
        owned: set[str] = set()
        # Stream-death signals: timeout, clean/unclean disconnect, or a
        # malformed frame (HandshakeError also covers EOF mid-frame).  All
        # of them mean the stream is desynchronized or abandoned: break,
        # don't reply-and-continue.
        wire_errors = (asyncio.TimeoutError, asyncio.IncompleteReadError,
                       ConnectionResetError, HandshakeError)
        inflight: asyncio.Future | None = None
        try:
            while True:
                try:
                    header = await read_json_frame(stream.reader,
                                                   timeout=self.idle_timeout)
                    op = header.get("op", "")
                    sid = header.get("session", "")
                    x = None
                    if op in ("prefill", "decode", "verify"):
                        x = await read_tensor(stream.reader,
                                              timeout=self.idle_timeout)
                except wire_errors:
                    break
                try:
                    if op == "prefill":
                        # Register before dispatch: a cancellation landing
                        # after the executor inserted the KV must still
                        # release it in the finally below.
                        owned.add(sid)
                        inflight = loop.run_in_executor(
                            None, self.runner.prefill, sid, x,
                            int(header["plen"]))
                        y = await inflight
                        inflight = None
                        await write_json_frame(stream.writer, {"ok": True})
                        await write_tensor(stream.writer, y)
                    elif op == "decode":
                        inflight = loop.run_in_executor(
                            None, self.runner.decode, sid, x,
                            int(header["position"]), int(header["seq_len"]))
                        y = await inflight
                        inflight = None
                        await write_json_frame(stream.writer, {"ok": True})
                        await write_tensor(stream.writer, y)
                    elif op == "verify":
                        inflight = loop.run_in_executor(
                            None, self.runner.verify, sid, x,
                            int(header["start"]))
                        y = await inflight
                        inflight = None
                        await write_json_frame(stream.writer, {"ok": True})
                        await write_tensor(stream.writer, y)
                    elif op == "release":
                        self.runner.release(sid)
                        owned.discard(sid)
                        await write_json_frame(stream.writer, {"ok": True})
                    elif op == "info":
                        await write_json_frame(stream.writer, {
                            "ok": True,
                            "shard_index": self.runner.shard_index,
                            "shard_count": self.runner.shard_count,
                            "layer_range": list(self.runner.layer_range),
                            "sessions": self.runner.session_count,
                        })
                    else:
                        await write_json_frame(
                            stream.writer,
                            {"ok": False, "error": f"unknown op {op!r}"})
                except KeyError as e:
                    await write_json_frame(
                        stream.writer,
                        {"ok": False, "error": f"unknown session/field: {e}"})
                except Exception as e:
                    log.exception("shard op %s failed", op)
                    await write_json_frame(
                        stream.writer, {"ok": False, "error": str(e)})
        finally:
            # If cancellation landed while an executor op was running, the
            # thread may insert its session KV after this point unless we
            # let it settle first (executor futures are uncancellable once
            # started).
            if inflight is not None and not inflight.done():
                try:
                    await asyncio.shield(inflight)
                except BaseException:
                    pass
            for sid in owned:
                self.runner.release(sid)
            stream.close()


# ------------------------------------------------------------- client side

class RemoteStage:
    """Leader-side proxy for one remote pipeline stage (one stream reused
    across calls; a lock serializes request/reply pairs so concurrent
    sessions sharing the pooled stream cannot interleave frames)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self._lock = asyncio.Lock()

    async def _call(self, header: dict, tensor: np.ndarray | None,
                    want_tensor: bool) -> np.ndarray | None:
        async with self._lock:
            await write_json_frame(self._stream.writer, header)
            if tensor is not None:
                await write_tensor(self._stream.writer, tensor)
            reply = await read_json_frame(self._stream.reader,
                                          timeout=STAGE_CALL_TIMEOUT)
            if not reply.get("ok"):
                raise RuntimeError(f"shard stage error: {reply.get('error')}")
            if want_tensor:
                return await read_tensor(self._stream.reader,
                                         timeout=STAGE_CALL_TIMEOUT)
            return None

    async def prefill(self, session: str, x: np.ndarray,
                      plen: int) -> np.ndarray:
        return await self._call(
            {"op": "prefill", "session": session, "plen": plen}, x, True)

    async def decode(self, session: str, x: np.ndarray, position: int,
                     seq_len: int) -> np.ndarray:
        return await self._call(
            {"op": "decode", "session": session, "position": position,
             "seq_len": seq_len}, x, True)

    async def verify(self, session: str, x: np.ndarray,
                     start: int) -> np.ndarray:
        return await self._call(
            {"op": "verify", "session": session, "start": start}, x, True)

    async def release(self, session: str) -> None:
        await self._call({"op": "release", "session": session}, None, False)

    def close(self) -> None:
        self._stream.close()


class LocalStage:
    """Leader-side adapter running a ShardStageRunner in-process (the leader
    is itself stage 0)."""

    def __init__(self, runner: ShardStageRunner):
        self.runner = runner

    async def prefill(self, session: str, x: np.ndarray,
                      plen: int) -> np.ndarray:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.runner.prefill, session,
                                          x, plen)

    async def decode(self, session: str, x: np.ndarray, position: int,
                     seq_len: int) -> np.ndarray:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.runner.decode, session,
                                          x, position, seq_len)

    async def verify(self, session: str, x: np.ndarray,
                     start: int) -> np.ndarray:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.runner.verify, session,
                                          x, start)

    async def release(self, session: str) -> None:
        self.runner.release(session)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------- pipeline

class SwarmPipeline:
    """Drives a full forward pass through ordered stages (leader-side).

    Owns embed/unembed (on the leader's device) and hands the last
    position's logits to the sampling loop; stage i's activations feed
    stage i+1.  ``params`` needs only the non-layer leaves (embedding,
    final norm, lm_head).  The embedding and the unembedding run on the
    executor, as the stages do.
    """

    def __init__(self, cfg: ModelConfig, params: dict, stages: list,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.embed_params = {k: place(v, self.device, dtype)
                             for k, v in params.items() if k != "layers"}
        self.stages = stages

    @torch.inference_mode()
    def _embed(self, tokens: np.ndarray) -> np.ndarray:
        ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        return host_array(T._embed([self.embed_params], self.cfg, ids))

    @torch.inference_mode()
    def _unembed(self, x: np.ndarray) -> np.ndarray:
        """Logits [..., V] fp32 of activations x [..., D]."""
        return host_array(T._unembed(
            [self.embed_params], self.cfg,
            device_tensor(x, self.device, self.dtype)))

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    async def prefill(self, session: str, prompt_ids: list[int],
                      bucket: int) -> np.ndarray:
        """Returns the last position's logits [V] (fp32)."""
        plen = len(prompt_ids)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :plen] = prompt_ids
        x = await self._run(self._embed, tokens)
        for stage in self.stages:
            x = await stage.prefill(session, x, plen)
        logits = await self._run(self._unembed, x[0, plen - 1])
        return logits

    async def decode(self, session: str, token: int, position: int,
                     seq_len: int) -> np.ndarray:
        """One token through all stages; returns next-token logits [V]."""
        x = await self._run(self._embed, np.asarray([token], np.int32))
        for stage in self.stages:
            x = await stage.decode(session, x, position, seq_len)
        logits = await self._run(self._unembed, x)
        return logits[0]

    async def verify(self, session: str, tokens: list[int],
                     start: int) -> np.ndarray:
        """A pending+drafts window through all stages in ONE round trip
        per stage; returns per-position logits [J, V].  Cross-worker
        decode is bound by the network's latency, so verifying J tokens
        per trip emits up to J tokens for one token's latency."""
        x = await self._run(self._embed, np.asarray([tokens], np.int32))
        for stage in self.stages:
            x = await stage.verify(session, x, start)
        logits = await self._run(self._unembed, x)
        return logits[0]

    async def release(self, session: str) -> None:
        for stage in self.stages:
            try:
                await stage.release(session)
            except Exception:
                log.warning("stage release failed", exc_info=True)

    def close(self) -> None:
        for stage in self.stages:
            stage.close()
