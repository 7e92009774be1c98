"""Cross-worker expert parallelism: MoE expert banks over the swarm.

Counterpart of ``crowdllama_tpu/engine/expert_service.py``: Mixtral-style
expert FFN banks are spread round-robin over the members of a shard group
(``core/resource.py ShardGroup``, strategy "ep").  Every member, the
leader included, hosts ``experts e where e % shard_count == shard_index``
for all layers and serves them statelessly behind ``SHARD_PROTOCOL`` (op
"ffn": a batch of token activations tagged with global expert ids).  The
group leader (shard_index 0) runs everything else (embed, attention and
so the whole KV cache, router, norms, unembed) and per MoE layer computes
the top-k routing, partitions the (token, expert) pairs by owning member,
dispatches the per-member batches concurrently and combines the weighted
expert outputs.  The frames are the JAX package's (``shard_service.py``'s
tensor frames), so one group may mix workers of both packages.

A bank runs the sorted grouped dispatch over its local experts: the rows
sorted by local expert (stable, as ``jnp.argsort``), padded with zero rows
to JAX's bucket (routed to local expert 0), then the three grouped
products on kernel G's bf16 entry (``models/transformer.py
_expert_ffn``; ``lax.ragged_dot`` in JAX), then unsorted.  The leader's
layer bodies are JAX's: plain RMSNorm, no softcap and no window; prefill
attention through kernel A, decode through kernel D over the session's
contiguous cache, the verify window through the plain prefix-context
attention; the router in fp32 with a stable top-k.  ``prefill_attn`` and
``decode_attn`` are seams that let a check run the leader through the
plain versions.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from crowdllama_tpu_torch.engine.runner import resolve_device
from crowdllama_tpu_torch.engine.shard_service import (
    STAGE_CALL_TIMEOUT,
    STREAM_IDLE_TIMEOUT,
    device_tensor,
    host_array,
    place,
    read_tensor,
    write_tensor,
)
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
    prefill_attention_ctx,
)
from crowdllama_tpu_torch.ops.norms import rms_norm
from crowdllama_tpu_torch.ops.rope import apply_rope

log = logging.getLogger("crowdllama.torch.engine.expert")


def assign_experts(num_experts: int, shard_count: int,
                   shard_index: int) -> list[int]:
    """Round-robin expert placement: expert e lives on member e % count."""
    return [e for e in range(num_experts) if e % shard_count == shard_index]


def _pad_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# ------------------------------------------------------------- bank (server)

class ExpertBankRunner:
    """One member's expert FFN bank: its expert subset for every layer.

    Stateless: a call is (layer, global expert id per token, activations)
    -> per-token expert outputs.  The weights are stacked [L, E_local, ...]
    on ``device``; ``params["layers"]`` expert leaves hold every expert of
    the model (the bank takes its own) or exactly the bank's.
    """

    def __init__(self, cfg: ModelConfig, params: dict, expert_ids: list[int],
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None):
        assert cfg.is_moe, "ExpertBankRunner needs an MoE config"
        self.cfg = cfg
        self.expert_ids = list(expert_ids)
        self._local = {e: i for i, e in enumerate(self.expert_ids)}
        self.dtype = dtype
        self.device = resolve_device(device)
        idx = torch.as_tensor(self.expert_ids, dtype=torch.long)
        lw = params["layers"]

        def _bank(a):
            if a.shape[1] == cfg.num_experts:
                a = a[:, idx]
            elif a.shape[1] != len(self.expert_ids):
                raise ValueError(f"expert leaf of {a.shape[1]} experts: "
                                 f"want {cfg.num_experts} or this bank's "
                                 f"{len(self.expert_ids)}")
            return place(a, self.device, dtype).contiguous()

        self.wg = _bank(lw["w_gate"])  # [L, El, D, F]
        self.wu = _bank(lw["w_up"])
        self.wd = _bank(lw["w_down"])  # [L, El, F, D]

    @torch.inference_mode()
    def _ffn(self, layer: int, local_idx: np.ndarray,
             x: np.ndarray) -> np.ndarray:
        """x: [n, D]; local_idx: [n].  Rows grouped by local expert, each
        computed for exactly its expert (operations proportional to the
        routed rows); bucket-padding rows (x = 0) give zero outputs."""
        xd = device_tensor(x, self.device, self.dtype)
        li = torch.from_numpy(local_idx).to(self.device, torch.long)
        order = torch.argsort(li, stable=True)
        xs = xd.index_select(0, order)
        sizes = torch.bincount(li, minlength=len(self.expert_ids))
        offsets = F.pad(torch.cumsum(sizes, 0), (1, 0)).to(torch.int32)
        lp = {"w_gate": self.wg[layer], "w_up": self.wu[layer],
              "w_down": self.wd[layer]}
        ys = T._expert_ffn(lp, xs, offsets)
        inv = torch.argsort(order)  # unsort
        return host_array(ys.index_select(0, inv))

    def ffn(self, layer: int, expert_ids: np.ndarray,
            x: np.ndarray) -> np.ndarray:
        """x: [n, D] activations; expert_ids: [n] GLOBAL ids (all must be
        local to this bank).  Returns [n, D] fp32."""
        n = x.shape[0]
        try:
            local = np.asarray([self._local[int(e)] for e in expert_ids],
                               np.int32)
        except KeyError as e:
            raise ValueError(f"expert {e} not hosted here "
                             f"(have {self.expert_ids})") from None
        b = _pad_bucket(n)
        xp = np.zeros((b, x.shape[1]), np.float32)
        xp[:n] = x
        lp = np.zeros((b,), np.int32)
        lp[:n] = local
        return self._ffn(int(layer), lp, xp)[:n]


class ExpertBankService:
    """Stream handler serving an ExpertBankRunner over SHARD_PROTOCOL.

    Stateless ops, no sessions to leak, so the lifecycle is simpler than
    ShardStageService's: wire errors and the idle timeout just close the
    stream.
    """

    def __init__(self, runner: ExpertBankRunner,
                 idle_timeout: float = STREAM_IDLE_TIMEOUT):
        self.runner = runner
        self.idle_timeout = idle_timeout

    async def handle(self, stream: Stream) -> None:
        loop = asyncio.get_running_loop()
        wire_errors = (asyncio.TimeoutError, asyncio.IncompleteReadError,
                       ConnectionResetError, HandshakeError)
        try:
            while True:
                try:
                    header = await read_json_frame(stream.reader,
                                                   timeout=self.idle_timeout)
                    op = header.get("op", "")
                    x = eids = None
                    if op == "ffn":
                        x = await read_tensor(stream.reader,
                                              timeout=self.idle_timeout)
                        eids = await read_tensor(stream.reader,
                                                 timeout=self.idle_timeout)
                except wire_errors:
                    break
                try:
                    if op == "ffn":
                        y = await loop.run_in_executor(
                            None, self.runner.ffn, int(header["layer"]),
                            eids.astype(np.int64), x)
                        await write_json_frame(stream.writer, {"ok": True})
                        await write_tensor(stream.writer, y)
                    elif op == "info":
                        await write_json_frame(stream.writer, {
                            "ok": True,
                            "expert_ids": self.runner.expert_ids,
                            "layers": int(self.runner.wg.shape[0]),
                        })
                    else:
                        await write_json_frame(
                            stream.writer,
                            {"ok": False, "error": f"unknown op {op!r}"})
                except Exception as e:
                    log.exception("expert op %s failed", op)
                    await write_json_frame(
                        stream.writer, {"ok": False, "error": str(e)})
        finally:
            stream.close()


# ------------------------------------------------------------ bank (client)

class RemoteExpertBank:
    """Leader-side proxy for a member's expert bank (one pooled stream; a
    lock serializes request/reply pairs)."""

    def __init__(self, stream: Stream, expert_ids: list[int]):
        self._stream = stream
        self.expert_ids = list(expert_ids)
        self._lock = asyncio.Lock()

    async def ffn(self, layer: int, expert_ids: np.ndarray,
                  x: np.ndarray) -> np.ndarray:
        async with self._lock:
            await write_json_frame(self._stream.writer,
                                   {"op": "ffn", "layer": layer})
            await write_tensor(self._stream.writer, x.astype(np.float32))
            await write_tensor(self._stream.writer,
                               expert_ids.astype(np.int32))
            reply = await read_json_frame(self._stream.reader,
                                          timeout=STAGE_CALL_TIMEOUT)
            if not reply.get("ok"):
                raise RuntimeError(f"expert bank error: {reply.get('error')}")
            return await read_tensor(self._stream.reader,
                                     timeout=STAGE_CALL_TIMEOUT)

    def close(self) -> None:
        self._stream.close()


class LocalExpertBank:
    """Leader-side adapter for the leader's own expert subset."""

    def __init__(self, runner: ExpertBankRunner):
        self.runner = runner
        self.expert_ids = list(runner.expert_ids)

    async def ffn(self, layer: int, expert_ids: np.ndarray,
                  x: np.ndarray) -> np.ndarray:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.runner.ffn, layer,
                                          expert_ids, x)

    def close(self) -> None:
        pass


# ------------------------------------------------------------------ leader

class EPLeaderRunner:
    """Leader-local compute for cross-worker EP: attention + router + KV.

    Per-layer steps over the stacked non-expert weights, because the
    expert dispatch between attention and the residual add is
    asynchronous host code.  Each step updates the session cache in place
    and returns the residual stream (on the device) with the routed
    rows' norm, top-k weights and expert ids as host arrays.  Only the
    attention leaves, the router and the non-layer leaves are placed on
    ``device``.
    """

    _ATTN_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router")

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None):
        assert cfg.is_moe
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_seq = max_seq or cfg.max_context_length
        self.layers = {k: place(params["layers"][k], self.device, dtype)
                       for k in self.layer_keys(cfg)}
        self.embed_params = {k: place(v, self.device, dtype)
                             for k, v in params.items() if k != "layers"}
        self._sessions: dict[str, dict[str, Any]] = {}
        self.scale = T.attn_scale(cfg)
        self.cos, self.sin = T.rope_for(cfg, self.device)
        #: prefill attention (kernel A) and contiguous decode attention
        #: (kernel D); seams that let a caller run the same step through
        #: the plain versions
        self.prefill_attn = prefill_attention
        self.decode_attn = decode_attention

    @classmethod
    def layer_keys(cls, cfg: ModelConfig) -> tuple[str, ...]:
        """The stacked leaves the leader holds.  Qwen2-style qkv biases and
        Qwen3-style per-head qk-norms ride along (applied with the shared
        layer bodies' ordering: bias before the head reshape, norm before
        rope)."""
        keys = cls._ATTN_KEYS
        if cfg.attn_qkv_bias:
            keys += ("bq", "bk", "bv")
        if cfg.qk_norm:
            keys += ("q_norm", "k_norm")
        return keys

    def _layer(self, layer: int) -> dict:
        return {k: w[layer] for k, w in self.layers.items()}

    def _qkv(self, lp: dict, x: torch.Tensor, positions: torch.Tensor):
        """Norm -> projections (+ Qwen2 bias) -> heads (+ Qwen3 qk-norm)
        -> rope -> head-major K/V, for x [B, T, D]."""
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        h = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = (T.qmatmul(h, lp["wq"]), T.qmatmul(h, lp["wk"]),
                   T.qmatmul(h, lp["wv"]))
        if "bq" in lp:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        dh = cfg.resolved_head_dim()
        q = q.reshape(b, t, cfg.num_heads, dh)
        k = k.reshape(b, t, cfg.num_kv_heads, dh)
        v = v.reshape(b, t, cfg.num_kv_heads, dh)
        if "q_norm" in lp:
            q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
        q = apply_rope(q, positions, self.cos, self.sin)
        k = apply_rope(k, positions, self.cos, self.sin)
        return (q.contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous())

    def _tail(self, lp: dict, x: torch.Tensor, attn: torch.Tensor):
        """Output projection and residual, then the routed rows' norm and
        top-k: (x, h2, topw, topi), the last three on the host."""
        x = x + T.qmatmul(attn, lp["wo"])
        h2 = rms_norm(x, lp["ln2"], self.cfg.rms_norm_eps)
        topw, topi = T._route_topk(lp, self.cfg, h2)
        return x, host_array(h2), host_array(topw), topi.cpu().numpy()

    @torch.inference_mode()
    def prefill_layer(self, layer: int, x: torch.Tensor, plen: int,
                      sess: dict):
        """x [1, bucket, D]: padding positions clamp to plen-1 and
        ``kv_valid`` excludes them."""
        lp = self._layer(layer)
        b, t = x.shape[0], x.shape[1]
        ar = torch.arange(t, device=self.device, dtype=torch.int32)
        positions = torch.clamp(ar, max=plen - 1)[None]
        kv_valid = (ar < plen)[None]
        q, kh, vh = self._qkv(lp, x, positions)
        attn = self.prefill_attn(q, kh, vh, positions, self.scale,
                                 kv_valid=kv_valid)
        sess["kc"][layer, :, :, :t] = kh
        sess["vc"][layer, :, :, :t] = vh
        return self._tail(lp, x, attn.reshape(b, t, -1))

    @torch.inference_mode()
    def decode_layer(self, layer: int, x: torch.Tensor, position: int,
                     seq_len: int, sess: dict):
        lp = self._layer(layer)
        pos = torch.tensor([[position]], dtype=torch.int32,
                           device=self.device)
        lens = torch.tensor([seq_len], dtype=torch.int32, device=self.device)
        q, kh, vh = self._qkv(lp, x[:, None], pos)
        kc_l, vc_l = sess["kc"][layer], sess["vc"][layer]
        kc_l[0, :, position] = kh[0, :, 0]
        vc_l[0, :, position] = vh[0, :, 0]
        attn = self.decode_attn(q[:, 0], kc_l, vc_l, lens, self.scale)
        return self._tail(lp, x, attn.reshape(x.shape[0], -1))

    @torch.inference_mode()
    def verify_layer(self, layer: int, x: torch.Tensor, start: int,
                     sess: dict):
        """A J-token speculative window at positions start..start+J-1
        attending over the session cache as context (< start valid) and
        causally within the window: one expert round trip per layer
        carries J tokens instead of 1."""
        lp = self._layer(layer)
        b, t = x.shape[0], x.shape[1]
        positions = (start + torch.arange(t, device=self.device,
                                          dtype=torch.int32))[None]
        q, kh, vh = self._qkv(lp, x, positions)
        kc_l, vc_l = sess["kc"][layer], sess["vc"][layer]
        ctx_valid = (torch.arange(self.max_seq, device=self.device)
                     < start)[None]
        attn = prefill_attention_ctx(q, kh, vh, positions, kc_l, vc_l,
                                     ctx_valid, self.scale)
        kc_l[:, :, start:start + t] = kh
        vc_l[:, :, start:start + t] = vh
        return self._tail(lp, x, attn.reshape(b, t, -1))

    @torch.inference_mode()
    def embed(self, tokens: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        return T._embed([self.embed_params], self.cfg, ids)

    @torch.inference_mode()
    def unembed(self, x: torch.Tensor) -> np.ndarray:
        return host_array(T._unembed([self.embed_params], self.cfg, x))

    @torch.inference_mode()
    def add(self, x: torch.Tensor, moe: np.ndarray) -> torch.Tensor:
        return x + device_tensor(moe, self.device, x.dtype)

    def new_session(self, session: str) -> None:
        L, hkv, dh = (self.cfg.num_layers, self.cfg.num_kv_heads,
                      self.cfg.resolved_head_dim())
        kc = torch.zeros((L, 1, hkv, self.max_seq, dh), dtype=self.dtype,
                         device=self.device)
        self._sessions[session] = {"kc": kc, "vc": torch.zeros_like(kc)}

    def release(self, session: str) -> None:
        self._sessions.pop(session, None)

    @property
    def session_count(self) -> int:
        return len(self._sessions)


# ---------------------------------------------------------------- pipeline

class EPPipeline:
    """Drives a full forward pass with swarm-distributed experts
    (leader-side).  Same interface as shard_service.SwarmPipeline so
    ShardedEngine can drive either strategy."""

    def __init__(self, cfg: ModelConfig, runner: EPLeaderRunner, banks: list):
        self.cfg = cfg
        self.runner = runner
        self.banks = banks
        self._owner: dict[int, Any] = {}
        for bank in banks:
            for e in bank.expert_ids:
                self._owner[e] = bank
        missing = set(range(cfg.num_experts)) - set(self._owner)
        if missing:
            raise RuntimeError(f"experts {sorted(missing)} unassigned")

    async def _moe(self, layer: int, h: np.ndarray, topw: np.ndarray,
                   topi: np.ndarray) -> np.ndarray:
        """h: [n, D]; topw/topi: [n, K].  Partition (token, expert) pairs by
        owning bank, dispatch concurrently, combine weighted outputs."""
        n, K = topi.shape
        flat_tok = np.repeat(np.arange(n), K)
        flat_e = topi.reshape(-1)
        flat_w = topw.reshape(-1).astype(np.float32)
        calls = []
        for bank in self.banks:
            sel = np.isin(flat_e, np.asarray(bank.expert_ids))
            if sel.any():
                calls.append((bank, sel))
        results = await asyncio.gather(*(
            bank.ffn(layer, flat_e[sel], h[flat_tok[sel]])
            for bank, sel in calls))
        out = np.zeros_like(h, dtype=np.float32)
        for (bank, sel), y in zip(calls, results):
            np.add.at(out, flat_tok[sel], flat_w[sel, None] * y)
        return out

    async def prefill(self, session: str, prompt_ids: list[int],
                      bucket: int) -> np.ndarray:
        """Returns the last position's logits [V] (fp32)."""
        loop = asyncio.get_running_loop()
        r = self.runner
        plen = len(prompt_ids)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :plen] = prompt_ids
        await loop.run_in_executor(None, r.new_session, session)
        sess = r._sessions[session]
        x = await loop.run_in_executor(None, r.embed, tokens)
        for l in range(self.cfg.num_layers):
            x, h2, topw, topi = await loop.run_in_executor(
                None, r.prefill_layer, l, x, plen, sess)
            # Dispatch only the real prompt rows: padding tokens would
            # otherwise be routed and computed remotely for every layer.
            moe = await self._moe(l, h2[0, :plen], topw[0, :plen],
                                  topi[0, :plen])
            full = np.zeros((bucket, moe.shape[-1]), np.float32)
            full[:plen] = moe
            x = await loop.run_in_executor(None, r.add, x, full[None])
        return await loop.run_in_executor(None, r.unembed, x[0, plen - 1])

    async def decode(self, session: str, token: int, position: int,
                     seq_len: int) -> np.ndarray:
        loop = asyncio.get_running_loop()
        r = self.runner
        sess = r._sessions[session]
        x = await loop.run_in_executor(
            None, r.embed, np.asarray([token], np.int32))
        for l in range(self.cfg.num_layers):
            x, h2, topw, topi = await loop.run_in_executor(
                None, r.decode_layer, l, x, position, seq_len, sess)
            moe = await self._moe(l, h2, topw, topi)
            x = await loop.run_in_executor(None, r.add, x, moe)
        logits = await loop.run_in_executor(None, r.unembed, x)
        return logits[0]

    async def verify(self, session: str, tokens: list[int],
                     start: int) -> np.ndarray:
        """A pending+drafts window in one pass: each layer's expert
        dispatch batches the J window rows, so the per-layer round trip to
        the banks carries J tokens instead of 1.  Returns [J, V]."""
        loop = asyncio.get_running_loop()
        r = self.runner
        sess = r._sessions[session]
        j = len(tokens)
        x = await loop.run_in_executor(
            None, r.embed, np.asarray([tokens], np.int32))
        for l in range(self.cfg.num_layers):
            x, h2, topw, topi = await loop.run_in_executor(
                None, r.verify_layer, l, x, start, sess)
            moe = await self._moe(l, h2[0], topw[0], topi[0])
            x = await loop.run_in_executor(None, r.add, x, moe[None])
        logits = await loop.run_in_executor(None, r.unembed, x)
        return logits[0].reshape(j, -1)

    async def release(self, session: str) -> None:
        self.runner.release(session)

    def close(self) -> None:
        for bank in self.banks:
            bank.close()
