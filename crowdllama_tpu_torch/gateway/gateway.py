"""The consumer's HTTP gateway: the Ollama API and the OpenAI surface.

Counterpart of ``crowdllama_tpu/gateway/gateway.py`` on the port's own
HTTP plane (``net/http.py``, imported as ``web`` so the two gateways read
side by side).  A request (``POST /api/chat``, ``/api/generate``,
``/v1/chat/completions``, ``/v1/completions``, the embedding routes) is
admitted (or shed with 503 + ``Retry-After``), routed to the best worker
(prefix affinity on continuations, else the peer manager's
throughput / (1 + load) score), sent as a llama.v1 ``GenerateRequest``
over a pooled secure inference stream, and its reply rendered as
Ollama NDJSON or OpenAI SSE.  The per-request wall-clock budget is
charged across every retry and failover; a stream fails over on a worker
error, on a drain or migrate (the drained worker becomes the successor's
KV donor), and on a stall past ``stream_stall_ms``; the replay is trimmed
by count so the client sees every character once.  ``hedge_ttft_ms``
races a second worker for the first token and delivers one stream.
The speculative pipeline (``spec_pipeline``): streamed generations are
flagged ``remote_draft``; the worker's VerifyResult frames feed a
per-stream ``SpecPipelinePump`` (``gateway/draft.py``) that answers with
DraftChunk frames, drafted here by the ``spec_draft_path`` checkpoint
("gateway", on this process's card) or pure ack credits ("worker");
such a stream is never hedged or pooled back, and its failover replay runs
plain.  ``/metrics``, ``/metrics/cluster``, ``/debug/trace[/{id}]``,
``/debug/flightrecorder`` and ``/debug/profile`` (``torch.profiler``
over this process) are the operator's surfaces.

The replicated gateway: with a ``gossip`` node (``swarm/gossip.py``) the
affinity pins and drain quarantines are shared with the other replicas (a
continuation routes to the worker that holds its KV, or names it as the
chosen worker's ``kv_donor``, whichever replica it comes through; a
drain one replica observes quarantines the worker on all), and with
``tenant_quotas`` admission is per tenant (``X-Tenant``): a token bucket
charged by every replica's admits, and a weighted fair share of the
inflight cap.  ``/api/pull`` of
a model no worker serves is proxied to a worker, which pulls it from the
swarm (``net/model_share.py``).  An
autopilot back-off in this process (``engine/autotune.py BACKOFF_LOG``)
captures the first request finished after it with the reason
``autotune_backoff``, its stitched trace carrying the dial move.  The
native data plane encodes request frames (``core/wire.encode_genreq_frame``)
and decodes reply frames with its strict decoder where it applies
(``core/wire.decode_payload_fast``); /metrics carries the
``crowdllama_native_*`` families.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import random
import time
from collections import OrderedDict

from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import (
    create_embed_request,
    create_generate_request,
    extract_embed_response,
    extract_generate_response,
)
from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL
from crowdllama_tpu_torch.engine.autotune import BACKOFF_LOG
from crowdllama_tpu_torch.net import http as web
from crowdllama_tpu_torch.net import secure
from crowdllama_tpu_torch.net.host import HANDSHAKE_TIMEOUT, StreamPool
from crowdllama_tpu_torch.obs import GATEWAY_ROOT_SPAN, NodeObs, new_trace_id
from crowdllama_tpu_torch.obs.cluster import ClusterScraper
from crowdllama_tpu_torch.obs.collector import FlightRecorder, TraceCollector
from crowdllama_tpu_torch.obs.http import host_stat_lines, native_metric_lines
from crowdllama_tpu_torch.obs.metrics import (
    ENGINE_TELEMETRY,
    LabelGuard,
    device_memory_lines,
    engine_gauge_lines,
)
from crowdllama_tpu_torch.obs.slo import SloEngine
from crowdllama_tpu_torch.version import VERSION

log = logging.getLogger("crowdllama.torch.gateway")

# Gateway span phases recorded per request: the always-present quartet,
# plus dial / stream_flush when the request paid them.
_GW_PHASES = ("route", "serde", "aead", "io_wait")
_GW_OPT_PHASES = ("dial", "stream_flush")


def _now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()) + "Z"


class _StreamStarted(Exception):
    """The CLIENT side of a streamed response failed (disconnect, write
    error): not retryable, not failover-able, the response is final.
    Worker-side mid-stream failures are ordinary exceptions, so _route
    fails the stream over."""

    def __init__(self, response: web.StreamResponse, cause: Exception):
        super().__init__(str(cause))
        self.response = response
        self.cause = cause


class _BudgetExhausted(Exception):
    """The request's wall-clock budget expired (pre- or mid-stream)."""


class _WorkerDraining(Exception):
    """The worker is draining: it rejected the request (typed
    ``draining`` terminal frame) or handed an in-flight stream off with a
    MigrateFrame.  _route quarantines it and re-routes with it attached
    as the successor's KV donor (``migrate=True``)."""

    def __init__(self, worker_id: str, migrated: bool = False,
                 delivered_tokens: int = 0):
        super().__init__(
            f"worker {worker_id[:8]} draining"
            + (" (mid-stream handoff)" if migrated else ""))
        self.worker_id = worker_id
        self.migrated = migrated
        self.delivered_tokens = delivered_tokens


class _StreamStalled(Exception):
    """The worker stopped making token progress past the stall budget
    while holding the transport open (the gray failure): _route tears the
    stream down, quarantines the worker as ``wedged`` and fails over."""

    def __init__(self, worker_id: str, phase: str):
        super().__init__(
            f"worker {worker_id[:8]} stalled (no {phase} progress)")
        self.worker_id = worker_id
        self.phase = phase  # "ttft" | "decode"


class _StreamCtx:
    """Client-side state of ONE streamed response, surviving failover:
    the prepared response, every character already delivered, and the
    OpenAI envelope (id, created, chunk ordinal)."""

    __slots__ = ("out", "sent_text", "rid", "created", "nth", "winner")

    def __init__(self, shape: str):
        self.out: web.StreamResponse | None = None
        self.sent_text = ""
        self.rid = ("chatcmpl-" if shape == "openai-chat" else "cmpl-") \
            + os.urandom(12).hex()
        self.created = int(time.time())
        self.nth = 0
        # The worker that served the stream (a hedge may have won).
        self.winner = ""


class Gateway:
    def __init__(self, peer, port: int = 9001, host: str = "0.0.0.0",
                 trace_buffer: int = 64, request_timeout: float = 600.0,
                 admission_max_inflight: int = 0,
                 retry_after_s: float = 1.0, kv_ship: bool = False,
                 gossip=None, tenant_quotas=None, flight_recorder: int = 32,
                 trace_ttl: float = 0.0, metrics_exemplars: bool = False,
                 slo_ttft_ms: float = 0.0, slo_decode_ms: float = 0.0,
                 stream_stall_ms: float = 0.0, hedge_ttft_ms: float = 0.0,
                 profile_dir: str = "", spec_pipeline: str = "off",
                 spec_draft_path: str = "", device=None):
        self.peer = peer
        self.port = port
        self.host = host
        # The replicated gateway: the GossipNode sharing affinity pins and
        # quarantines with the other replicas (None: all process-local),
        # and the per-tenant token buckets that replace the global shed.
        self.gossip = gossip
        self.tenant_quotas = tenant_quotas
        self.kv_ship = bool(kv_ship)
        # Budget per request (X-Request-Timeout may lower it), admission
        # cap (0 = off), Retry-After hint on shed 503s.
        self.request_timeout = max(0.1, float(request_timeout))
        self.admission_max_inflight = max(0, int(admission_max_inflight))
        self.retry_after_s = max(0.0, float(retry_after_s))
        self._inflight = 0
        self._server: web.Server | None = None
        self.app = web.Application(middlewares=[self._log_middleware])
        r = self.app.router
        r.add_post("/api/chat", self.handle_chat)
        r.add_post("/api/generate", self.handle_generate)
        r.add_get("/api/health", self.handle_health)
        r.add_get("/api/tags", self.handle_tags)
        r.add_get("/api/version", self.handle_version)
        r.add_post("/api/show", self.handle_show)
        r.add_get("/api/ps", self.handle_ps)
        r.add_post("/api/embed", self.handle_embed)
        r.add_post("/api/embeddings", self.handle_embeddings)
        r.add_post("/api/pull", self.handle_pull)
        r.add_post("/v1/chat/completions", self.handle_openai_chat)
        r.add_post("/v1/completions", self.handle_openai_completions)
        r.add_get("/v1/models", self.handle_openai_models)
        r.add_post("/v1/embeddings", self.handle_openai_embeddings)
        r.add_get("/metrics", self.handle_metrics)
        r.add_get("/debug/trace", self.handle_trace)
        r.add_get("/debug/trace/{trace_id}", self.handle_trace_stitched)
        r.add_get("/debug/flightrecorder", self.handle_flightrecorder)
        r.add_get("/metrics/cluster", self.handle_metrics_cluster)
        r.add_get("/debug/profile", self.handle_profile)
        for route in ("/api/delete", "/api/create", "/api/copy", "/api/push"):
            r.add_route("*", route, self.handle_unsupported)
        # (path, status) -> count / summed seconds, fed by the middleware.
        self._req_count: dict[tuple[str, int], int] = {}
        self._req_seconds: dict[tuple[str, int], float] = {}
        # Streamed time-to-first-frame histogram (seconds), from admission.
        self._ttfb_le = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
        self._ttfb_buckets = [0] * (len(self._ttfb_le) + 1)
        self._ttfb_sum = 0.0
        self._ttfb_count = 0
        # Only registered routes become path label values.
        self._known_paths = {rt.canonical for rt in r.routes()}
        self._path_guard = LabelGuard(allowed=self._known_paths)
        self.obs = NodeObs(trace_capacity=trace_buffer, node="gateway",
                           trace_ttl=trace_ttl, exemplars=metrics_exemplars)
        self.collector = TraceCollector(peer, self.obs)
        self.flight = FlightRecorder(capacity=flight_recorder)
        # Observations the rolling p99 needs before it captures, and the
        # stitches allowed in flight at once (a shed storm must not fan
        # out one stitch per request).
        self._flight_min_count = 30
        self._flight_inflight = 0
        self._flight_max_inflight = 4
        self._flight_tasks: set[asyncio.Task] = set()
        # Back-offs already seen: the next one is an edge.
        self._autotune_backoffs_seen = BACKOFF_LOG.snapshot()[0]
        self.cluster = ClusterScraper(peer)
        self.slo = SloEngine(ttft_ms=float(slo_ttft_ms),
                             decode_ms=float(slo_decode_ms))
        self.profile_dir = str(profile_dir or "")
        self._profiling = False
        # Pooled inference streams (one handshake serves many requests);
        # 8 per worker matches typical per-worker concurrency.
        self._stream_pool = StreamPool(max_per_key=8)
        # Per-phase CPU attribution of the request path (perf_counter_ns
        # sums); ``requests`` counts routed inference / embed requests.
        self._perf = {"route_ns": 0, "serde_ns": 0, "io_wait_ns": 0,
                      "requests": 0}
        self._robust = {"failovers": 0, "replayed_chunks": 0, "shed": 0,
                        "budget_exhausted": 0,
                        "stalled_streams": 0, "wedge_quarantines": 0,
                        "hedge_launched": 0, "hedge_won": 0,
                        "hedge_cancelled": 0}
        self.stream_stall_ms = max(0.0, float(stream_stall_ms))
        self.hedge_ttft_ms = max(0.0, float(hedge_ttft_ms))
        # Prefix affinity: conversation fingerprint -> (worker_id, ts), a
        # bounded LRU.
        self._affinity: OrderedDict[str, tuple[str, float]] = OrderedDict()
        self._affinity_hits = 0
        self._affinity_evicted = 0
        self._affinity_repointed = 0
        self._kv_hints = 0
        # Continuations whose pin came from the gossip map rather than this
        # process's own LRU (the cross-replica hit count).
        self._gossip_affinity_hits = 0
        # Per-tenant inflight (weighted-fair admission): tenant -> count.
        self._tenant_inflight: dict[str, int] = {}
        # The speculative pipeline: "off", "gateway" (draft here from
        # spec_draft_path, on ``device``: the card unless the CPU is asked
        # for) or "worker" (pure ack credits).  The drafter loads on the
        # first remote-draft stream.
        if spec_pipeline not in ("off", "gateway", "worker"):
            raise ValueError(f"spec_pipeline must be off|gateway|worker, "
                             f"got {spec_pipeline!r}")
        self.spec_pipeline = spec_pipeline
        self.spec_draft_path = str(spec_draft_path or "")
        self.spec_device = device
        self._spec_drafter = None
        self._spec_drafter_tried = False
        self._spec_stats = {"chunks": 0, "acks": 0, "nacks": 0,
                            "accepted": 0, "offered": 0}
        # The depth controller's warm start per worker: (rtt, step) EWMAs.
        self._spec_wire: dict[str, tuple[float, float]] = {}

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        pm = self.peer.peer_manager
        if pm is not None:
            # Affinity hygiene rides the manager's eviction hook, chained:
            # the DHT's eviction registered first and must keep firing.
            prev = pm.on_peer_removed

            def _on_removed(peer_id: str) -> None:
                if prev is not None:
                    prev(peer_id)
                self._affinity_drop_worker(peer_id)

            pm.on_peer_removed = _on_removed
            if self.gossip is not None:
                # Our observation of a drain enters the replicated map, so
                # the other replicas stop routing to the worker within one
                # round.
                prev_drain = pm.on_draining

                def _on_draining(peer_id: str) -> None:
                    if prev_drain is not None:
                        prev_drain(peer_id)
                    self.gossip.record_quarantine(peer_id)

                pm.on_draining = _on_draining
        if self.gossip is not None:
            # Another replica's quarantine quarantines the worker here
            # (mark_draining is idempotent, versions cannot regress);
            # affinity entries are read on a local miss.
            from crowdllama_tpu_torch.swarm.gossip import QUARANTINE_PREFIX

            def _on_entry(entry) -> None:
                if (entry.tombstone
                        or not entry.key.startswith(QUARANTINE_PREFIX)):
                    return
                pm2 = self.peer.peer_manager
                if pm2 is not None:
                    pm2.mark_draining(entry.key[len(QUARANTINE_PREFIX):])

            self.gossip.on_entry = _on_entry
        self._server = web.Server(self.app, self.host, self.port)
        await self._server.start()
        self.port = self._server.port
        log.info("gateway listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None
        for t in list(self._flight_tasks):
            t.cancel()
        await asyncio.gather(*self._flight_tasks, return_exceptions=True)
        # Late put()s of in-flight requests close their streams.
        self._stream_pool.close()

    # ------------------------------------------------------- stream pool

    def _pool_get(self, worker_id: str):
        return self._stream_pool.get(worker_id)

    def _pool_put(self, worker_id: str, s) -> None:
        """Return a stream whose last exchange completed cleanly."""
        self._stream_pool.put(worker_id, s)

    async def _dial(self, worker_id: str, acc: dict | None = None,
                    timeout: float | None = None, trace_id: str = ""):
        """A fresh stream; ``timeout`` caps dial + handshake at the
        request's remaining budget.  ``trace_id`` rides a relay splice's
        connect frame, so the relay records a relay_splice span the
        collector can stitch."""
        t0 = time.perf_counter_ns()
        contact = await self.peer.dht.find_peer(worker_id)
        if contact is None:
            raise LookupError(f"worker {worker_id[:8]} not resolvable")
        hs = (HANDSHAKE_TIMEOUT if timeout is None
              else max(0.05, min(HANDSHAKE_TIMEOUT, timeout)))
        s = await self.peer.host.new_stream(contact, INFERENCE_PROTOCOL,
                                            timeout=hs, trace_id=trace_id)
        if acc is not None:
            acc["dial_ns"] = acc.get("dial_ns", 0) \
                + time.perf_counter_ns() - t0
        return s

    # ------------------------------------------------- budgets and shedding

    def _budget(self, request: web.Request) -> float:
        """Seconds of budget: the ceiling, lowered by a valid
        ``X-Request-Timeout`` header."""
        hdr = request.headers.get("X-Request-Timeout", "")
        if hdr:
            try:
                v = float(hdr)
            except ValueError:
                v = 0.0
            if v > 0:
                return min(v, self.request_timeout)
        return self.request_timeout

    def _shed_headers(self) -> dict:
        # Jittered Retry-After in [base, 2 * base] whole seconds, so shed
        # clients do not all come back at one instant.
        base = self.retry_after_s
        return {"Retry-After": str(max(1, round(random.uniform(base,
                                                               2 * base))))}

    def _shed_response(self, shape: str, model: str,
                       message: str) -> web.Response:
        """503 + Retry-After, recorded as a one-span ``shed`` trace."""
        self._robust["shed"] += 1
        tid = new_trace_id()
        self.obs.trace.record(tid, "shed", 0, parent=GATEWAY_ROOT_SPAN,
                              detail=message[:120], model=model)
        self.obs.trace.finish(tid, 1, status=503)
        self._flight_capture(tid, ["shed"])
        headers = self._shed_headers()
        if shape.startswith("openai"):
            return self._openai_error(message, 503, "server_error",
                                      headers=headers)
        return web.json_response({"error": message, "model": model},
                                 status=503, headers=headers)

    # ------------------------------------------------- hot-path attribution

    def _encode_frame(self, msg, acc: dict | None = None) -> bytes:
        """Encode a request once per attempt (a stale pooled stream's
        redial reuses the bytes)."""
        t0 = time.perf_counter_ns()
        frame = wire.encode_frame(msg)
        dt = time.perf_counter_ns() - t0
        self._perf["serde_ns"] += dt
        if acc is not None:
            acc["serde_ns"] = acc.get("serde_ns", 0) + dt
        return frame

    async def _send_frame(self, s, frame: bytes,
                          acc: dict | None = None) -> None:
        # write() buffers (and seals inline, counted by the secure layer);
        # only the drain is socket wait.
        s.writer.write(frame)
        t0 = time.perf_counter_ns()
        await s.writer.drain()
        dt = time.perf_counter_ns() - t0
        self._perf["io_wait_ns"] += dt
        if acc is not None:
            acc["io_wait_ns"] = acc.get("io_wait_ns", 0) + dt

    async def _recv_pb(self, s, timeout: float = 600,
                       acc: dict | None = None):
        t0 = time.perf_counter_ns()
        payload = await wire.read_frame_payload(s.reader, timeout=timeout)
        t1 = time.perf_counter_ns()
        # The native strict decoder serves the GenerateResponse arm (the
        # per-chunk case); every other shape goes through the codec.
        reply = wire.decode_payload_fast(payload)
        t2 = time.perf_counter_ns()
        self._perf["io_wait_ns"] += t1 - t0
        self._perf["serde_ns"] += t2 - t1
        if acc is not None:
            acc["io_wait_ns"] = acc.get("io_wait_ns", 0) + (t1 - t0)
            acc["serde_ns"] = acc.get("serde_ns", 0) + (t2 - t1)
        return reply

    def hotpath_snapshot(self) -> dict:
        """Point-in-time hot-path counters (diff two snapshots)."""
        aead_ns, aead_ops = secure.aead_stats()
        pm = self.peer.peer_manager
        return {
            "requests": self._perf["requests"],
            "route_us": self._perf["route_ns"] / 1e3,
            "serde_us": self._perf["serde_ns"] / 1e3,
            "io_wait_us": self._perf["io_wait_ns"] / 1e3,
            "aead_us": aead_ns / 1e3,  # process-wide (net/secure.py)
            "aead_ops": aead_ops,
            "pool_hits": self._stream_pool.hits,
            "pool_misses": self._stream_pool.misses,
            "route_snapshot_rebuilds": (
                pm.route_snapshot_rebuilds if pm is not None else 0),
        }

    # ---------------------------------------------------------- middleware

    @web.middleware
    async def _log_middleware(self, request: web.Request, handler):
        t0 = time.monotonic()
        status = 0
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            # The router's 404 / 405 arrive raised: record their status.
            status = e.status
            raise
        finally:
            dt = time.monotonic() - t0
            log.info("%s %s -> %.0fms", request.method, request.path,
                     dt * 1000)
            key = (self._path_guard.value(request.path), status)
            self._req_count[key] = self._req_count.get(key, 0) + 1
            self._req_seconds[key] = self._req_seconds.get(key, 0.0) + dt

    # ------------------------------------------------------------ handlers

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        """POST /api/chat: the Ollama chat API."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        model = body.get("model", "")
        messages = body.get("messages", [])
        if not model or not isinstance(messages, list) or not messages:
            return web.json_response(
                {"error": "model and messages are required"}, status=400)
        stream = bool(body.get("stream", False))
        options = body.get("options", {}) or {}
        return await self._route(request, model, stream, options,
                                 messages=messages, shape="chat")

    async def handle_generate(self, request: web.Request
                              ) -> web.StreamResponse:
        """POST /api/generate: the Ollama completion API."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        model = body.get("model", "")
        prompt = body.get("prompt", "")
        if not model or not prompt:
            return web.json_response(
                {"error": "model and prompt are required"}, status=400)
        stream = bool(body.get("stream", False))
        options = body.get("options", {}) or {}
        return await self._route(request, model, stream, options,
                                 prompt=prompt, shape="generate")

    async def handle_health(self, request: web.Request) -> web.Response:
        """GET /api/health: the per-worker health map."""
        pm = self.peer.peer_manager
        workers = {}
        if pm is not None:
            for p in pm.get_workers():
                r = p.resource
                workers[p.peer_id] = {
                    "is_healthy": p.is_healthy,
                    "last_seen": time.time() - (time.monotonic()
                                                - p.last_seen),
                    "failed_attempts": p.failed_attempts,
                    "supported_models": r.supported_models,
                    "tokens_throughput": r.tokens_throughput,
                    "load": r.load,
                    "accelerator": r.accelerator,
                    "tpu_chip_count": r.tpu_chip_count,
                    "ici_topology": r.ici_topology,
                    "version": r.version,
                }
        return web.json_response({
            "status": "ok",
            "peer_id": self.peer.peer_id,
            "worker_count": len(workers),
            "workers": workers,
        })

    async def handle_tags(self, request: web.Request) -> web.Response:
        """GET /api/tags: the models healthy workers serve."""
        pm = self.peer.peer_manager
        models: dict[str, dict] = {}
        if pm is not None:
            for p in pm.get_healthy_peers():
                if not p.is_worker:
                    continue
                for m in p.resource.supported_models:
                    models.setdefault(m, {"name": m, "model": m})
        return web.json_response({"models": list(models.values())})

    async def handle_version(self, request: web.Request) -> web.Response:
        return web.json_response({"version": VERSION})

    async def handle_show(self, request: web.Request) -> web.Response:
        """POST /api/show: the registry config and the swarm's view."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        name = body.get("model") or body.get("name") or ""
        if not name:
            return web.json_response({"error": "model is required"},
                                     status=400)
        pm = self.peer.peer_manager
        serving = [p.peer_id for p in (pm.get_healthy_peers() if pm else [])
                   if p.is_worker and name in p.resource.supported_models]
        details: dict = {"format": "safetensors"}
        model_info: dict = {}
        try:
            from crowdllama_tpu_torch.models.config import get_config

            cfg = get_config(name)
            fam = cfg.family
            details.update({
                "family": fam,
                "families": [fam],
                "parameter_size": f"{cfg.param_count() / 1e9:.1f}B",
            })
            model_info = {
                "general.architecture": fam,
                "general.parameter_count": cfg.param_count(),
                f"{fam}.context_length": cfg.max_context_length,
                f"{fam}.embedding_length": cfg.hidden_size,
                f"{fam}.block_count": cfg.num_layers,
                f"{fam}.attention.head_count": cfg.num_heads,
                f"{fam}.attention.head_count_kv": cfg.num_kv_heads,
                f"{fam}.vocab_size": cfg.vocab_size,
            }
            if cfg.is_moe:
                model_info[f"{fam}.expert_count"] = cfg.num_experts
                model_info[f"{fam}.expert_used_count"] = (
                    cfg.num_experts_per_tok)
        except KeyError:
            if not serving:
                return web.json_response(
                    {"error": f"model {name!r} not found"}, status=404)
        return web.json_response({
            "model": name,
            "details": details,
            "model_info": model_info,
            "workers_serving": serving,
        })

    async def handle_ps(self, request: web.Request) -> web.Response:
        """GET /api/ps: the models loaded across the swarm."""
        pm = self.peer.peer_manager
        models: dict[str, dict] = {}
        if pm is not None:
            for p in pm.get_healthy_peers():
                if not p.is_worker:
                    continue
                for m in p.resource.supported_models:
                    entry = models.setdefault(m, {
                        "name": m, "model": m, "workers": 0,
                        "tokens_throughput": 0.0,
                    })
                    entry["workers"] += 1
                    entry["tokens_throughput"] += p.resource.tokens_throughput
        return web.json_response({"models": list(models.values())})

    async def handle_embed(self, request: web.Request) -> web.Response:
        """POST /api/embed: {model, input: str | [str]} ->
        {model, embeddings: [[...]]}."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        model = body.get("model", "")
        inputs = body.get("input", "")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not model or not isinstance(inputs, list) or not inputs \
                or not all(isinstance(t, str) for t in inputs):
            return web.json_response(
                {"error": "model and input are required"}, status=400)
        truncate = bool(body.get("truncate", True))
        resp, status = await self._route_embed(model, inputs, truncate)
        return web.json_response(resp, status=status)

    async def handle_embeddings(self, request: web.Request) -> web.Response:
        """POST /api/embeddings: the legacy {model, prompt} ->
        {embedding: [...]}."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        model = body.get("model", "")
        prompt = body.get("prompt", "")
        if not model or not prompt or not isinstance(prompt, str):
            return web.json_response(
                {"error": "model and prompt (a string) are required"},
                status=400)
        resp, status = await self._route_embed(
            model, [prompt], bool(body.get("truncate", True)))
        if status == 200:
            resp = {"embedding": resp["embeddings"][0]}
        return web.json_response(resp, status=status)

    async def _route_embed(self, model: str, inputs: list[str],
                           truncate: bool = True) -> tuple[dict, int]:
        msg = create_embed_request(model, inputs, truncate=truncate)
        tid = new_trace_id()
        msg.trace_id = tid
        msg.parent_span = GATEWAY_ROOT_SPAN
        t0 = time.monotonic()
        self._perf["requests"] += 1
        acc: dict = {}
        self.obs.trace.begin(tid, node="gateway", model=model,
                             path="/api/embed")
        aead0 = secure.aead_stats()[0]
        status = 503
        served_by = ""
        try:
            tried: set[str] = set()
            last_err = "no workers available for model"
            for _attempt in range(2):  # retry once on the next-best worker
                worker = self._find_worker(model, exclude=tried,
                                           require_embeddings=True, acc=acc)
                if worker is None:
                    break
                tried.add(worker.peer_id)
                try:
                    reply = await self._roundtrip(worker.peer_id, msg,
                                                  acc=acc)
                    resp = extract_embed_response(reply)
                    if resp.error.startswith("invalid:"):
                        # A client error (no retry elsewhere): 400.
                        status = 400
                        served_by = worker.peer_id
                        return {"error":
                                resp.error[len("invalid:"):].strip(),
                                "model": model}, 400
                    if resp.error:
                        raise RuntimeError(resp.error)
                    status = 200
                    served_by = worker.peer_id
                    return {
                        "model": model,
                        "embeddings": [list(e.values)
                                       for e in resp.embeddings],
                        "total_duration": resp.total_duration,
                        "prompt_eval_count": resp.prompt_tokens,
                        "worker_id": resp.worker_id,
                    }, 200
                except Exception as e:
                    last_err = str(e)
                    log.warning("embed via %s failed: %s",
                                worker.peer_id[:8], e)
            return {"error": f"embeddings failed: {last_err}",
                    "model": model}, 503
        finally:
            acc["aead_ns"] = max(0, secure.aead_stats()[0] - aead0)
            self._finish_trace(tid, acc, model, t0, status, served_by)

    async def _roundtrip(self, worker_id: str, msg, timeout: float = 600,
                         acc: dict | None = None,
                         frame: bytes | None = None):
        """Request / reply over a pooled (or fresh) stream; a stale pooled
        stream gets one fresh redial with the same encoded bytes."""
        if frame is None:
            frame = self._encode_frame(msg, acc=acc)
        s = self._pool_get(worker_id)
        if s is not None:
            try:
                await self._send_frame(s, frame, acc=acc)
                reply = await self._recv_pb(s, timeout=timeout, acc=acc)
                self._pool_put(worker_id, s)
                return reply
            except asyncio.CancelledError:
                s.close()
                raise
            except Exception as e:
                s.close()
                log.debug("pooled stream to %s stale (%s); redialing",
                          worker_id[:8], e)
        s = await self._dial(worker_id, acc=acc, trace_id=msg.trace_id)
        try:
            await self._send_frame(s, frame, acc=acc)
            reply = await self._recv_pb(s, timeout=timeout, acc=acc)
        except BaseException:
            s.close()
            raise
        self._pool_put(worker_id, s)
        return reply

    async def handle_pull(self, request: web.Request) -> web.Response:
        """POST /api/pull.  Resolution order: a healthy worker already
        serves the model -> success at once; else the pull is proxied to
        the best worker (``net/model_share.py``'s ``pull`` op), which
        acquires the checkpoint from whichever peer shares it and
        hot-registers it; else 404 naming the failed swarm pull."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        name = body.get("model") or body.get("name") or ""
        if not name:
            return web.json_response({"error": "model is required"},
                                     status=400)

        def _success(extra_lines=()):
            if not body.get("stream", True):
                # Non-streaming clients parse one JSON body.
                return web.json_response({"status": "success"})
            lines = [{"status": "pulling manifest"}, *extra_lines,
                     {"status": "success"}]
            return web.Response(
                text="".join(json.dumps(line) + "\n" for line in lines),
                content_type="application/x-ndjson")

        # The predicate routing uses: pull must not report success for a
        # model /api/chat would then refuse.
        if self._find_worker(name) is not None:
            return _success()

        pull_err = "no workers available"
        pm = self.peer.peer_manager
        target = pm.find_best_worker("") if pm else None
        if target is not None:
            from crowdllama_tpu_torch.net.model_share import request_pull

            try:
                contact = await self.peer.dht.find_peer(target.peer_id)
                if contact is None:
                    raise RuntimeError(
                        f"cannot resolve worker {target.peer_id[:8]}")
                path = await request_pull(self.peer.host, contact, name)
                return _success([{"status": f"pulled to {path} on worker "
                                            f"{target.peer_id[:8]}"}])
            except Exception as e:
                pull_err = str(e)
                log.warning("proxied pull of %s via %s failed: %s",
                            name, target.peer_id[:8], e)
        return web.json_response({
            "error": f"model {name!r} is not served by any worker and the "
                     f"swarm pull failed ({pull_err}); models are provided "
                     "by swarm workers (start one with "
                     f"--worker-mode --model {name})"}, status=404)

    async def handle_metrics(self, request: web.Request) -> web.Response:
        """GET /metrics: Prometheus text of the gateway and the swarm."""
        lines = ["# TYPE crowdllama_gateway_requests_total counter"]
        for (path, status), n in sorted(self._req_count.items()):
            lines.append(f'crowdllama_gateway_requests_total{{path="{path}",'
                         f'status="{status}"}} {n}')
        lines.append("# TYPE crowdllama_gateway_request_seconds_total counter")
        for (path, status), s in sorted(self._req_seconds.items()):
            lines.append(
                f'crowdllama_gateway_request_seconds_total{{path="{path}",'
                f'status="{status}"}} {s:.6f}')
        pm = self.peer.peer_manager
        if pm is not None:
            workers = pm.get_workers()
            healthy = [p for p in workers if p.is_healthy]
            lines += [
                "# TYPE crowdllama_workers_total gauge",
                f"crowdllama_workers_total {len(workers)}",
                "# TYPE crowdllama_workers_healthy gauge",
                f"crowdllama_workers_healthy {len(healthy)}",
                "# TYPE crowdllama_worker_throughput_tokens_per_sec gauge",
                "# TYPE crowdllama_worker_load gauge",
                "# TYPE crowdllama_worker_healthy gauge",
            ]
            for p in workers:
                pid = p.peer_id[:16]
                r = p.resource
                lines.append(f'crowdllama_worker_throughput_tokens_per_sec{{'
                             f'peer="{pid}"}} {r.tokens_throughput}')
                lines.append(f'crowdllama_worker_load{{peer="{pid}"}} '
                             f'{r.load}')
                lines.append(f'crowdllama_worker_healthy{{peer="{pid}"}} '
                             f'{1 if p.is_healthy else 0}')
        # Streamed time to first frame, present at zero from the start.
        lines.append("# TYPE crowdllama_gateway_ttfb_seconds histogram")
        acc = 0
        for le, n in zip(self._ttfb_le, self._ttfb_buckets):
            acc += n
            lines.append(f'crowdllama_gateway_ttfb_seconds_bucket{{le="{le}"}}'
                         f" {acc}")
        lines.append(f'crowdllama_gateway_ttfb_seconds_bucket{{le="+Inf"}} '
                     f"{self._ttfb_count}")
        lines.append(
            f"crowdllama_gateway_ttfb_seconds_sum {self._ttfb_sum:.6f}")
        lines.append(
            f"crowdllama_gateway_ttfb_seconds_count {self._ttfb_count}")
        r = self._robust
        for name, kind, value in (
                ("crowdllama_gateway_stream_pool_hits_total", "counter",
                 self._stream_pool.hits),
                ("crowdllama_gateway_stream_pool_misses_total", "counter",
                 self._stream_pool.misses),
                ("crowdllama_gateway_affinity_hits_total", "counter",
                 self._affinity_hits),
                ("crowdllama_gateway_affinity_evicted_total", "counter",
                 self._affinity_evicted),
                ("crowdllama_gateway_affinity_repointed_total", "counter",
                 self._affinity_repointed),
                ("crowdllama_gateway_kv_hints_total", "counter",
                 self._kv_hints),
                ("crowdllama_gateway_gossip_affinity_hits_total", "counter",
                 self._gossip_affinity_hits),
                ("crowdllama_gateway_failovers_total", "counter",
                 r["failovers"]),
                ("crowdllama_gateway_replayed_chunks_total", "counter",
                 r["replayed_chunks"]),
                ("crowdllama_gateway_shed_total", "counter", r["shed"]),
                ("crowdllama_gateway_budget_exhausted_total", "counter",
                 r["budget_exhausted"]),
                ("crowdllama_gateway_pool_evicted_dead_total", "counter",
                 self._stream_pool.evicted_dead),
                ("crowdllama_stall_aborted_streams_total", "counter",
                 r["stalled_streams"]),
                ("crowdllama_wedge_quarantines_total", "counter",
                 r["wedge_quarantines"]),
                ("crowdllama_hedge_launched_total", "counter",
                 r["hedge_launched"]),
                ("crowdllama_hedge_won_total", "counter", r["hedge_won"]),
                ("crowdllama_hedge_cancelled_total", "counter",
                 r["hedge_cancelled"]),
                ("crowdllama_draft_chunk_sent_total", "counter",
                 self._spec_stats["chunks"]),
                ("crowdllama_draft_chunk_acks_total", "counter",
                 self._spec_stats["acks"]),
                ("crowdllama_draft_chunk_nacked_total", "counter",
                 self._spec_stats["nacks"])):
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {value}")
        lines.append("# TYPE crowdllama_draft_chunk_tokens_total counter")
        for outcome in ("offered", "accepted"):
            lines.append(f'crowdllama_draft_chunk_tokens_total{{outcome='
                         f'"{outcome}"}} {self._spec_stats[outcome]}')
        # Per-phase microseconds; rate(phase) / rate(requests) is the
        # per-request cost.
        hp = self.hotpath_snapshot()
        lines.append("# TYPE crowdllama_gateway_hotpath_us_total counter")
        for phase in ("route_us", "serde_us", "aead_us", "io_wait_us"):
            lines.append(f'crowdllama_gateway_hotpath_us_total{{phase='
                         f'"{phase[:-3]}"}} {hp[phase]:.1f}')
        lines.append("# TYPE crowdllama_gateway_hotpath_requests_total counter")
        lines.append(
            f"crowdllama_gateway_hotpath_requests_total {hp['requests']}")
        lines.append("# TYPE crowdllama_route_snapshot_rebuilds_total counter")
        lines.append(f"crowdllama_route_snapshot_rebuilds_total "
                     f"{hp['route_snapshot_rebuilds']}")
        # The swarm-uniform families, as a worker's ObsServer renders them.
        lines.extend(self.obs.metrics.expose())
        engine = getattr(self.peer, "engine", None)
        if engine is not None:
            try:
                lines.extend(engine_gauge_lines(engine.obs_gauges()))
            except Exception as e:
                log.debug("engine gauges unavailable: %s", e)
        lines.extend(ENGINE_TELEMETRY.expose())
        lines.extend(device_memory_lines())
        lines.extend(host_stat_lines(self.peer.host))
        lines.extend(native_metric_lines())
        lines.extend(self.slo.expose())
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")

    async def handle_metrics_cluster(self, request: web.Request
                                     ) -> web.Response:
        """GET /metrics/cluster: every worker's families, re-labeled
        ``worker=``, and the rollups (``?family=`` narrows the scrape)."""
        families = tuple(request.query.getall("family", []))
        text = await self.cluster.render(families)
        return web.Response(text=text, content_type="text/plain")

    async def handle_profile(self, request: web.Request) -> web.Response:
        """GET /debug/profile?seconds=N: a ``torch.profiler`` window over
        this process (the card's kernels too when it has one), opened and
        closed on the event loop's thread as the JAX gateway opens its
        ``jax.profiler`` window, exported as a Chrome trace under the
        artifact dir.  501 without ``--profile-dir``; 409 while a capture
        runs."""
        if not self.profile_dir:
            return web.json_response(
                {"error": "profiling disabled: start the gateway with "
                          "--profile-dir to enable /debug/profile"},
                status=501)
        if self._profiling:
            return web.json_response(
                {"error": "a profile capture is already in flight"},
                status=409)
        try:
            seconds = float(request.query.get("seconds", "3") or 3)
        except ValueError:
            seconds = 3.0
        seconds = min(60.0, max(0.1, seconds))
        path = os.path.join(self.profile_dir, f"profile-{int(time.time())}")

        self._profiling = True
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            # Starting and stopping a session block: off the event loop.
            await asyncio.to_thread(prof.start)
            try:
                await asyncio.sleep(seconds)
            finally:
                await asyncio.to_thread(prof.stop)
            os.makedirs(path, exist_ok=True)
            await asyncio.to_thread(prof.export_chrome_trace,
                                    os.path.join(path, "trace.json"))
        except Exception as e:
            return web.json_response(
                {"error": f"profiler capture failed: {e}"}, status=500)
        finally:
            self._profiling = False
        return web.json_response({"artifact": path, "seconds": seconds})

    async def handle_trace(self, request: web.Request) -> web.Response:
        """GET /debug/trace: this node's span ring (``?trace_id=``,
        ``?limit=N``)."""
        try:
            limit = max(0, int(request.query.get("limit", "0") or 0))
        except ValueError:
            limit = 0
        return web.json_response(self.obs.trace.snapshot(
            trace_id=request.query.get("trace_id", ""), limit=limit))

    async def handle_trace_stitched(self, request: web.Request
                                    ) -> web.Response:
        """GET /debug/trace/<trace_id>: one span tree across nodes."""
        tid = request.match_info.get("trace_id", "")
        stitched = await self.collector.collect(tid)
        if stitched is None:
            return web.json_response(
                {"error": f"trace {tid!r} not found on any reachable node"},
                status=404)
        return web.json_response(stitched)

    async def handle_flightrecorder(self, request: web.Request
                                    ) -> web.Response:
        return web.json_response(self.flight.snapshot())

    async def handle_unsupported(self, request: web.Request) -> web.Response:
        """Model management has no meaning at the gateway."""
        return web.json_response({
            "error": f"{request.path} is not supported: models are owned by "
                     "swarm workers, not the gateway"}, status=501)

    # -------------------------------------------------------------- routing

    def _find_worker(self, model: str, exclude: set[str] = frozenset(),
                     require_embeddings: bool = False,
                     acc: dict | None = None):
        pm = self.peer.peer_manager
        if pm is None:
            return None
        t0 = time.perf_counter_ns()
        try:
            return pm.find_best_worker(model, exclude=exclude,
                                       require_embeddings=require_embeddings)
        finally:
            dt = time.perf_counter_ns() - t0
            self._perf["route_ns"] += dt
            if acc is not None:
                acc["route_ns"] = acc.get("route_ns", 0) + dt

    # --------------------------------------------------- OpenAI-compat v1

    @staticmethod
    def _openai_error(message: str, status: int,
                      err_type: str = "invalid_request_error",
                      headers: dict | None = None):
        return web.json_response(
            {"error": {"message": message, "type": err_type,
                       "param": None, "code": None}}, status=status,
            headers=headers)

    @staticmethod
    def _openai_options(body: dict) -> dict:
        """OpenAI top-level params -> Ollama options.  Raises ValueError
        on wrong-typed params; an explicit ``null`` takes OpenAI's
        default."""
        def num(key, default, cast):
            v = body.get(key)
            return default if v is None else cast(v)

        stops = body.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        elif not (isinstance(stops, list)
                  and all(isinstance(x, str) for x in stops)):
            raise ValueError("stop must be a string or list of strings")
        if num("n", 1, int) != 1:
            raise ValueError("only n=1 is supported")
        return {
            "num_predict": (num("max_completion_tokens", 0, int)
                            or num("max_tokens", 0, int)),
            "temperature": num("temperature", 1.0, float),
            "top_p": num("top_p", 1.0, float),
            "seed": num("seed", 0, int),
            "stop": stops,
        }

    @staticmethod
    def _openai_message_text(content) -> str:
        """A message's content: a string, or text parts joined."""
        if isinstance(content, str):
            return content
        if isinstance(content, list):
            parts = []
            for p in content:
                if isinstance(p, dict) and p.get("type") == "text":
                    parts.append(str(p.get("text", "")))
                elif not isinstance(p, dict):
                    raise ValueError("invalid content part")
                else:
                    raise ValueError(
                        f"unsupported content part type "
                        f"{p.get('type')!r} (text only)")
            return "".join(parts)
        raise ValueError("message content must be a string or parts list")

    async def handle_openai_chat(self, request: web.Request):
        """POST /v1/chat/completions."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return self._openai_error("invalid JSON body", 400)
        model = body.get("model", "")
        messages = body.get("messages", [])
        if not model or not isinstance(messages, list) or not messages:
            return self._openai_error("model and messages are required", 400)
        try:
            options = self._openai_options(body)
            messages = [
                {"role": str(m.get("role", "user")),
                 "content": self._openai_message_text(m.get("content", ""))}
                for m in messages if isinstance(m, dict)]
        except (ValueError, TypeError) as e:
            return self._openai_error(str(e), 400)
        if not messages:
            return self._openai_error("messages are required", 400)
        return await self._route(request, model,
                                 bool(body.get("stream", False)), options,
                                 messages=messages, shape="openai-chat")

    async def handle_openai_completions(self, request: web.Request):
        """POST /v1/completions."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return self._openai_error("invalid JSON body", 400)
        model = body.get("model", "")
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                return self._openai_error(
                    "only a single string prompt is supported", 400)
            prompt = prompt[0]
        if not model or not prompt:
            return self._openai_error("model and prompt are required", 400)
        try:
            options = self._openai_options(body)
        except (ValueError, TypeError) as e:
            return self._openai_error(str(e), 400)
        return await self._route(request, model,
                                 bool(body.get("stream", False)), options,
                                 prompt=prompt, shape="openai-completion")

    async def handle_openai_models(self, request: web.Request):
        """GET /v1/models."""
        pm = self.peer.peer_manager
        names: set[str] = set()
        if pm is not None:
            for p in pm.get_healthy_peers():
                if p.is_worker:
                    names.update(p.resource.supported_models)
        now = int(time.time())
        return web.json_response({
            "object": "list",
            "data": [{"id": m, "object": "model", "created": now,
                      "owned_by": "crowdllama"} for m in sorted(names)],
        })

    async def handle_openai_embeddings(self, request: web.Request):
        """POST /v1/embeddings."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return self._openai_error("invalid JSON body", 400)
        model = body.get("model", "")
        inputs = body.get("input", "")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not model or not isinstance(inputs, list) or not inputs \
                or not all(isinstance(t, str) for t in inputs):
            return self._openai_error("model and input are required", 400)
        resp, status = await self._route_embed(model, inputs)
        if status != 200:
            return self._openai_error(
                str(resp.get("error", "failed")), status,
                "invalid_request_error" if status < 500 else "server_error")
        return web.json_response({
            "object": "list",
            "model": model,
            "data": [{"object": "embedding", "index": i, "embedding": e}
                     for i, e in enumerate(resp["embeddings"])],
            "usage": {"prompt_tokens": resp.get("prompt_eval_count", 0),
                      "total_tokens": resp.get("prompt_eval_count", 0)},
        })

    # --------------------------------------------------- prefix affinity

    _AFFINITY_TTL_S = 600.0
    _AFFINITY_MAX = 4096
    _AFFINITY_LOAD_CAP = 0.9

    @staticmethod
    def _affinity_key(model: str, messages, prompt: str):
        """(conversation fingerprint, is a continuation).  The key hashes
        model + the first message's head + the first user message's head;
        affinity applies only to continuations (a second non-system turn),
        turn 1 only records where the conversation landed.
        /api/generate has no turns, so no key."""
        if not messages:
            return None, False
        m0 = messages[0]
        head = f"{m0.get('role', '')}:{str(m0.get('content', ''))[:256]}"
        users = [m for m in messages if m.get("role", "") != "system"]
        if users:
            head += f"|u0:{str(users[0].get('content', ''))[:256]}"
        return (hashlib.sha1(f"{model}|{head}".encode()).hexdigest(),
                len(users) >= 2)

    def _affinity_get(self, akey: str | None, model: str):
        """The remembered worker of this conversation, if it still routes
        ``model`` and is not near saturation.  On a local miss the gossip
        map is read: a conversation whose earlier turns went through
        another replica still routes to the worker holding its KV (the pin
        is seeded into the local LRU)."""
        if akey is None:
            return None
        entry = self._affinity.get(akey)
        if entry is None or time.monotonic() - entry[1] > self._AFFINITY_TTL_S:
            self._affinity.pop(akey, None)
            entry = None
            if self.gossip is not None:
                remote = self.gossip.lookup_affinity(
                    akey, max_age_s=self._AFFINITY_TTL_S)
                if remote is not None:
                    self._affinity_put(akey, remote[0])
                    self._gossip_affinity_hits += 1
                    entry = self._affinity.get(akey)
            if entry is None:
                return None
        self._affinity.move_to_end(akey)
        pm = self.peer.peer_manager
        cand = pm.is_routable(entry[0], model) if pm is not None else None
        if (cand is not None
                and getattr(cand.resource, "load", 0.0)
                < self._AFFINITY_LOAD_CAP):
            return cand
        return None

    def _affinity_put(self, akey: str | None, worker_id: str) -> None:
        if akey is None:
            return
        if akey not in self._affinity and \
                len(self._affinity) >= self._AFFINITY_MAX:
            self._affinity.popitem(last=False)
            self._affinity_evicted += 1
        self._affinity[akey] = (worker_id, time.monotonic())
        self._affinity.move_to_end(akey)
        if self.gossip is not None:
            # Mirrored, so the other replicas route this conversation's
            # continuations here too.
            self.gossip.record_affinity(akey, worker_id)

    def _affinity_drop_worker(self, worker_id: str,
                              successor: str = "") -> None:
        """Entries pinned to a leaving worker re-point to its migration
        successor, or go."""
        if not worker_id:
            return
        now = time.monotonic()
        for akey in [k for k, v in self._affinity.items()
                     if v[0] == worker_id]:
            if successor:
                self._affinity[akey] = (successor, now)
                self._affinity_repointed += 1
                if self.gossip is not None:
                    self.gossip.record_affinity(akey, successor)
            else:
                del self._affinity[akey]
                if self.gossip is not None:
                    self.gossip.drop_affinity(akey)

    def _kv_donor_for(self, akey: str | None, model: str,
                      chosen_worker: str) -> str:
        """The remembered worker as a page donor for a continuation that
        lands elsewhere ("" when kv_ship is off or it no longer routes).
        On a local miss, a pin another replica gossiped is as good."""
        if not self.kv_ship or akey is None:
            return ""
        entry = self._affinity.get(akey)
        if entry is None or time.monotonic() - entry[1] > self._AFFINITY_TTL_S:
            entry = None
            if self.gossip is not None:
                remote = self.gossip.lookup_affinity(
                    akey, max_age_s=self._AFFINITY_TTL_S)
                if remote is not None:
                    entry = (remote[0], time.monotonic())
            if entry is None:
                return ""
        if entry[0] == chosen_worker:
            return ""
        pm = self.peer.peer_manager
        if pm is None or pm.is_routable(entry[0], model) is None:
            return ""
        return entry[0]

    async def _route(self, request, model, stream, options,
                     messages=None, prompt="",
                     shape="chat") -> web.StreamResponse:
        """The admission gate and inflight accounting around
        _route_admitted: shedding happens before a trace id is minted or
        a worker touched.  With tenant quotas the shed is per tenant: a
        token bucket bounds each tenant's rate across the cluster (other
        replicas' admits arrive as gossiped digests and drain the same
        buckets), and under inflight pressure a tenant at or above its
        weighted fair share of the cap is shed while lighter tenants are
        admitted."""
        tq = self.tenant_quotas
        mx = self.obs.metrics
        tenant = self._tenant_of(request) if tq is not None else ""
        if self.admission_max_inflight \
                and self._inflight >= self.admission_max_inflight:
            if tq is not None:
                tq.shed_total += 1
                mx.tenant_inc(mx.tenant_shed, tenant)
            return self._shed_response(
                shape, model,
                f"overloaded: {self._inflight} requests in flight "
                f"(admission cap {self.admission_max_inflight})")
        if tq is not None:
            if not tq.try_admit(tenant):
                mx.tenant_inc(mx.tenant_shed, tenant)
                return self._shed_response(
                    shape, model,
                    f"tenant {tenant!r} over quota "
                    f"({tq.quotas.get(tenant, tq.quotas.get('default', 0))}"
                    f" req/s)")
            cap = self.admission_max_inflight
            if cap:
                active = {t for t, n in self._tenant_inflight.items()
                          if n > 0}
                share = tq.fair_share(tenant, cap, active)
                if self._tenant_inflight.get(tenant, 0) >= share:
                    mx.tenant_inc(mx.tenant_shed, tenant)
                    return self._shed_response(
                        shape, model,
                        f"tenant {tenant!r} over fair share "
                        f"({share:.1f} of {cap} inflight)")
            mx.tenant_inc(mx.tenant_admitted, tenant)
        self._inflight += 1
        if tq is not None:
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1
            mx.tenant_inflight[tenant] = self._tenant_inflight[tenant]
        try:
            return await self._route_admitted(
                request, model, stream, options, messages=messages,
                prompt=prompt, shape=shape)
        finally:
            self._inflight -= 1
            if tq is not None:
                self._tenant_inflight[tenant] -= 1
                mx.tenant_inflight[tenant] = self._tenant_inflight[tenant]

    def _tenant_of(self, request: web.Request) -> str:
        """The tenant key: the X-Tenant header through the label guard
        (a client varying the header cannot mint unbounded buckets or
        series)."""
        raw = request.headers.get("X-Tenant", "") or "default"
        return self.obs.metrics.tenant_guard.value(raw)

    async def _route_admitted(self, request, model, stream, options,
                              messages=None, prompt="",
                              shape="chat") -> web.StreamResponse:
        t_build = time.perf_counter_ns()
        stops = options.get("stop") or []
        req_kwargs = dict(
            model=model,
            prompt=prompt,
            stream=stream,
            messages=messages or (),
            max_tokens=int(options.get("num_predict", 0)),
            temperature=float(options.get("temperature", 0.0)),
            top_p=float(options.get("top_p", 1.0)),
            # Negative seeds mean "random": 0 (unseeded); oversize values
            # clamp into uint64.
            seed=min(max(0, int(options.get("seed", 0))),
                     0xFFFFFFFFFFFFFFFF),
            stop=[stops] if isinstance(stops, str) else
            [str(x) for x in stops],
            top_k=min(max(0, int(options.get("top_k", 0) or 0)), 2**31 - 1),
            repeat_penalty=max(0.0, float(
                options.get("repeat_penalty", 1.0) or 1.0)),
        )
        msg = create_generate_request(**req_kwargs)
        self._perf["serde_ns"] += time.perf_counter_ns() - t_build
        # The trace id every hop downstream inherits.
        tid = new_trace_id()
        msg.trace_id = tid
        msg.parent_span = GATEWAY_ROOT_SPAN
        # The speculative pipeline: a streamed generation opens the
        # VerifyResult sub-protocol (a worker that cannot verify nacks
        # every chunk and the stream runs plain).
        if stream and self.spec_pipeline != "off":
            msg.generate_request.remote_draft = True
        t0 = time.monotonic()  # TTFB counts from admission, retries in
        budget = self._budget(request)
        deadline = t0 + budget
        self._perf["requests"] += 1
        acc: dict = {}

        def native_frame(kv_donor: str = "",
                         migrate: bool = False) -> bytes | None:
            """The request's wire frame from the admission scalars by the
            native encoder (the codec's bytes for ``msg``), or None: the
            attempt then encodes ``msg`` with the codec."""
            t_enc = time.perf_counter_ns()
            try:
                frame = wire.encode_genreq_frame(
                    **req_kwargs, kv_donor=kv_donor, migrate=migrate,
                    trace_id=tid, parent_span=GATEWAY_ROOT_SPAN)
            except wire.WireError:
                return None  # oversize: the codec raises the same error
            dt = time.perf_counter_ns() - t_enc
            self._perf["serde_ns"] += dt
            acc["serde_ns"] = acc.get("serde_ns", 0) + dt
            return frame

        # Encoded once at admission; an attempt with a donor or a
        # migration encodes its own.
        base_frame = native_frame()
        self.obs.trace.begin(tid, node="gateway", model=model,
                             path=request.path, stream=stream)
        aead0 = secure.aead_stats()[0]
        status = 503
        served_by = ""
        sctx = _StreamCtx(shape)
        budget_out = False
        prev_worker = ""
        died_at = 0.0
        try:
            tr = time.perf_counter_ns()
            akey, continuation = self._affinity_key(model, messages, prompt)
            dt = time.perf_counter_ns() - tr
            self._perf["route_ns"] += dt
            acc["route_ns"] = acc.get("route_ns", 0) + dt
            tried: set[str] = set()
            last_err = "no workers available for model"
            attempt = 0
            max_attempts = 2  # retry once on the next-best worker
            # A drain hands the stream off with the drained worker as the
            # successor's KV donor, and earns one extra attempt.
            forced_donor = ""
            drained_worker = ""
            drain_extra_granted = False
            while attempt < max_attempts:
                attempt += 1
                now = time.monotonic()
                if now >= deadline:
                    budget_out = True
                    break
                worker = None
                used_affinity = False
                tr = time.perf_counter_ns()
                affine = (self._affinity_get(akey, model)
                          if continuation else None)
                dt_aff = time.perf_counter_ns() - tr
                self._perf["route_ns"] += dt_aff
                acc["route_ns"] = acc.get("route_ns", 0) + dt_aff
                if affine is not None and affine.peer_id not in tried:
                    worker = affine
                    used_affinity = True
                if worker is None:
                    worker = self._find_worker(model, exclude=tried, acc=acc)
                if worker is None:
                    break
                tried.add(worker.peer_id)
                gr = msg.generate_request
                gr.kv_donor = ""
                gr.migrate = False
                if forced_donor and forced_donor != worker.peer_id:
                    gr.kv_donor = forced_donor
                    gr.migrate = True
                elif continuation and not used_affinity:
                    donor = self._kv_donor_for(akey, model, worker.peer_id)
                    if donor:
                        gr.kv_donor = donor
                        self._kv_hints += 1
                        self.obs.trace.record(
                            tid, "kv_hint", 0, parent=GATEWAY_ROOT_SPAN,
                            donor=donor[:8], worker=worker.peer_id[:8])
                if sctx.out is not None:
                    # Mid-stream failover: the client already holds
                    # sent_text; the next worker replays, _forward trims.
                    self._robust["failovers"] += 1
                    self.obs.trace.record(
                        tid, "failover",
                        int(max(0.0, now - died_at) * 1e9),
                        parent=GATEWAY_ROOT_SPAN,
                        from_worker=prev_worker[:8],
                        to_worker=worker.peer_id[:8])
                    log.warning(
                        "failing stream over %s -> %s (replaying %d "
                        "delivered chars)", prev_worker[:8],
                        worker.peer_id[:8], len(sctx.sent_text))
                if sctx.out is not None and gr.remote_draft:
                    # A failover replay runs plain: the draft window died
                    # with the worker.
                    gr.remote_draft = False
                frame = None
                if not gr.remote_draft:
                    # The native encoder carries no remote_draft field.
                    frame = (base_frame if not gr.kv_donor
                             and not gr.migrate
                             else native_frame(gr.kv_donor, gr.migrate))
                try:
                    resp = await self._forward(request, worker.peer_id, msg,
                                               stream, shape, t0, acc=acc,
                                               ctx=sctx, deadline=deadline,
                                               frame=frame)
                    winner_id = sctx.winner or worker.peer_id
                    self._affinity_put(akey, winner_id)
                    if drained_worker and drained_worker != winner_id:
                        self._affinity_drop_worker(drained_worker,
                                                   successor=winner_id)
                    if used_affinity and winner_id == worker.peer_id:
                        self._affinity_hits += 1
                    served_by = winner_id
                    status = resp.status
                    return resp
                except _StreamStarted as e:
                    # The client side failed: nobody is listening.
                    winner_id = sctx.winner or worker.peer_id
                    self._affinity_put(akey, winner_id)
                    if used_affinity and winner_id == worker.peer_id:
                        self._affinity_hits += 1
                    log.warning("stream to client aborted mid-flight: %s",
                                e.cause)
                    served_by = winner_id
                    status = e.response.status
                    return e.response
                except _BudgetExhausted as e:
                    last_err = str(e) or "request budget exhausted"
                    budget_out = True
                    break
                except _WorkerDraining as e:
                    last_err = str(e)
                    pm = self.peer.peer_manager
                    if pm is not None:
                        pm.mark_draining(e.worker_id)
                    forced_donor = e.worker_id
                    drained_worker = e.worker_id
                    if not drain_extra_granted:
                        drain_extra_granted = True
                        max_attempts += 1
                    if e.migrated:
                        self.obs.metrics.migrated_streams += 1
                    self.obs.trace.record(
                        tid, "migrate", 0, parent=GATEWAY_ROOT_SPAN,
                        from_worker=e.worker_id[:8],
                        mid_stream=e.migrated,
                        delivered_tokens=e.delivered_tokens)
                    prev_worker = e.worker_id
                    died_at = time.monotonic()
                    log.info(
                        "worker %s draining; re-routing with KV handoff "
                        "(mid_stream=%s, delivered_tokens=%d)",
                        e.worker_id[:8], e.migrated, e.delivered_tokens)
                except _StreamStalled as e:
                    # The gray failure: quarantine as wedged (it may still
                    # answer health probes) and fail over.
                    last_err = str(e)
                    self._robust["stalled_streams"] += 1
                    pm = self.peer.peer_manager
                    if pm is not None and pm.mark_draining(e.worker_id,
                                                           reason="wedged"):
                        self._robust["wedge_quarantines"] += 1
                    self.obs.trace.record(
                        tid, "wedged", 0, parent=GATEWAY_ROOT_SPAN,
                        worker=e.worker_id[:8], phase=e.phase)
                    prev_worker = e.worker_id
                    died_at = time.monotonic()
                    log.warning(
                        "worker %s stalled (%s phase); quarantined as "
                        "wedged, failing stream over", e.worker_id[:8],
                        e.phase)
                except Exception as e:
                    # A worker-side failure, pre- or mid-stream.
                    last_err = str(e)
                    prev_worker = worker.peer_id
                    died_at = time.monotonic()
                    log.warning("worker %s failed: %s", worker.peer_id[:8],
                                e)
            if budget_out:
                self._robust["budget_exhausted"] += 1
            if sctx.out is not None:
                # Headers already out: end the stream with an error frame.
                status = sctx.out.status
                detail = (f"request budget exhausted after {budget:.1f}s"
                          if budget_out else f"inference failed: {last_err}")
                served_by = prev_worker
                return await self._terminal_error_frame(
                    sctx, shape, model, detail)
            if budget_out:
                status = 504
                detail = (f"deadline exceeded: request budget "
                          f"{budget:.1f}s exhausted ({last_err})")
                if shape.startswith("openai"):
                    return self._openai_error(detail, 504, "server_error")
                return web.json_response(
                    {"error": detail, "model": model}, status=504)
            if "overloaded" in last_err:
                # The worker's own admission rejection: the same 503 +
                # Retry-After as the gateway's cap.
                status = 503
                return self._shed_response(
                    shape, model, f"inference failed: {last_err}")
            if shape.startswith("openai"):
                return self._openai_error(
                    f"inference failed: {last_err}", 503, "server_error")
            return web.json_response(
                {"error": f"inference failed: {last_err}", "model": model},
                status=503)
        finally:
            acc["aead_ns"] = max(0, secure.aead_stats()[0] - aead0)
            self._finish_trace(tid, acc, model, t0, status, served_by)

    def _finish_trace(self, tid: str, acc: dict, model: str, t0: float,
                      status: int, worker_id: str = "") -> None:
        """One routed request's phase timings into its trace record and
        the request_seconds histogram (aead is a process-wide delta over
        the request's window)."""
        total_ns = int((time.monotonic() - t0) * 1e9)
        tr = self.obs.trace
        for phase in _GW_PHASES:
            tr.record(tid, phase, acc.get(phase + "_ns", 0),
                      parent=GATEWAY_ROOT_SPAN)
        for phase in _GW_OPT_PHASES:
            if acc.get(phase + "_ns"):
                tr.record(tid, phase, acc[phase + "_ns"],
                          parent=GATEWAY_ROOT_SPAN)
        tr.finish(tid, total_ns, status=status,
                  worker=worker_id[:8] if worker_id else "")
        hist = self.obs.metrics.request_seconds.labels(model)
        total_s = total_ns / 1e9
        # Judged against the p99 of everything BEFORE this request.
        reasons = self._flight_reasons(tid, hist, total_s, status)
        hist.observe(total_s, exemplar=tid)
        if reasons:
            self._flight_capture(tid, reasons)

    def _flight_reasons(self, tid: str, hist, total_s: float,
                        status: int) -> list[str]:
        """Why this request belongs in the flight recorder (empty: it does
        not)."""
        reasons: list[str] = []
        if hist.count >= self._flight_min_count \
                and total_s > hist.quantile(0.99):
            reasons.append("p99_latency")
        if status >= 500:
            reasons.append(f"status_{status}")
        if status == 504:
            reasons.append("budget_exhausted")
        if self.slo.enabled:
            # Edge-triggered: the request that tips the SLO into fast burn.
            before = self.slo.fast_burn_episodes_total
            if self.slo.fast_burn() \
                    and self.slo.fast_burn_episodes_total > before:
                reasons.append("slo_fast_burn")
        backoffs, _ = BACKOFF_LOG.snapshot()
        if backoffs > self._autotune_backoffs_seen:
            # Edge-triggered: the first request after an autopilot
            # back-off.
            self._autotune_backoffs_seen = backoffs
            reasons.append("autotune_backoff")
        rec = self.obs.trace.get(tid)
        if rec is not None:
            names = {s.get("name", "") for s in rec.get("spans", [])}
            for name in ("failover", "migrate", "wedged", "kv_hint"):
                if name in names:
                    reasons.append(name)
        return reasons

    def _flight_capture(self, tid: str, reasons: list[str]) -> None:
        """Stitch and capture off the request path."""
        if (self.flight.get(tid) is not None
                or self._flight_inflight >= self._flight_max_inflight):
            return
        self._flight_inflight += 1

        async def _go() -> None:
            try:
                stitched = await self.collector.collect(tid)
            except Exception as e:
                log.debug("flight-recorder stitch for %s failed: %s",
                          tid, e)
                return
            finally:
                self._flight_inflight -= 1
            if stitched is None:
                return
            final = list(reasons)
            if "autotune_backoff" in final:
                # Which dial move tripped the fast-burn guard.
                last = BACKOFF_LOG.snapshot()[1]
                if last:
                    stitched = dict(stitched)
                    stitched["autotune_backoff"] = dict(last)
            if "kv_hint" in final:
                # Kept only when the worker's fetch fell back.
                final.remove("kv_hint")
                if any(s.get("name") == "kv_fetch"
                       and (s.get("meta", {}).get("fallback")
                            or s.get("meta", {}).get("error"))
                       for s in stitched.get("spans", [])):
                    final.append("kv_ship_fallback")
            if final:
                self.flight.capture(tid, final, stitched)

        task = asyncio.ensure_future(_go())
        self._flight_tasks.add(task)
        task.add_done_callback(self._flight_tasks.discard)

    def _observe_ttfb(self, dt: float, tid: str = "") -> None:
        for i, le in enumerate(self._ttfb_le):
            if dt <= le:
                self._ttfb_buckets[i] += 1
                break
        else:
            self._ttfb_buckets[-1] += 1
        self._ttfb_sum += dt
        self._ttfb_count += 1
        self.obs.metrics.ttft_seconds.observe(dt, exemplar=tid)
        self.slo.observe_ttft(dt)

    async def _terminal_error_frame(self, ctx: _StreamCtx, shape: str,
                                    model: str,
                                    message: str) -> web.StreamResponse:
        """Every attempt exhausted after headers went out: a terminal
        error frame (NDJSON error line, or SSE error event + [DONE])."""
        out = ctx.out
        try:
            if shape.startswith("openai"):
                line = json.dumps({"error": {
                    "message": message, "type": "server_error"}}).encode()
                await out.write(b"data: " + line + b"\n\n")
                await out.write(b"data: [DONE]\n\n")
            else:
                line = json.dumps({
                    "model": model,
                    "created_at": _now_rfc3339(),
                    "done": True, "done_reason": "error",
                    "error": message,
                }).encode()
                await out.write(line + b"\n")
            await out.write_eof()
        except Exception:
            pass  # nobody is listening
        return out

    # ------------------------------------- gray-failure immunity plane

    def _stall_budget(self, phase: str) -> float:
        """Seconds of token silence tolerated in ``phase`` (0.0 = off);
        the live SLO objective raises the floor."""
        if self.stream_stall_ms <= 0:
            return 0.0
        ms = self.stream_stall_ms
        tr = self.slo.trackers.get(phase)
        if tr is not None and tr.objective_ms > ms:
            ms = tr.objective_ms
        return ms / 1000.0

    def _hedge_threshold(self) -> float:
        """Seconds of first-token silence before a hedge (0.0 = off): the
        live TTFT p95 raises the floor once it has mass, else the SLO
        TTFT objective."""
        if self.hedge_ttft_ms <= 0:
            return 0.0
        thr = self.hedge_ttft_ms / 1000.0
        hist = self.obs.metrics.ttft_seconds
        if hist.count >= self._flight_min_count:
            thr = max(thr, hist.quantile(0.95))
        else:
            tr = self.slo.trackers.get("ttft")
            if tr is not None:
                thr = max(thr, tr.objective_ms / 1000.0)
        return thr

    def _classify_frame(self, raw, worker_id: str):
        """One inference-stream frame; a drain or handoff raises
        _WorkerDraining."""
        if raw.WhichOneof("message") == "migrate_frame":
            raise _WorkerDraining(
                worker_id, migrated=True,
                delivered_tokens=raw.migrate_frame.delivered_tokens)
        resp = extract_generate_response(raw)
        if resp.done and resp.done_reason == "draining":
            raise _WorkerDraining(worker_id)
        return resp

    async def _open_stream(self, worker_id: str, msg, frame: bytes,
                           deadline: float | None, stall_ttft: float,
                           acc: dict, use_pool: bool = True,
                           vsink: list | None = None):
        """Send ``frame`` on a pooled (one fresh redial when stale) or
        fresh stream and read the FIRST response frame: ``(stream,
        first_resp)``, the caller owning the stream.  Receives are
        clamped to ``stall_ttft`` when the watchdog is armed, so a silent
        worker surfaces as _StreamStalled (no redial).  A cancel (a lost
        hedge race) closes the stream.  With ``vsink`` the VerifyResult
        frames a remote-draft worker sends before its first text frame
        (the handshake) are appended there instead."""
        def remaining() -> float:
            return (deadline - time.monotonic()) if deadline is not None \
                else 600.0

        def _recv_timeout() -> float:
            t = max(0.05, min(600.0, remaining()))
            return min(t, stall_ttft) if stall_ttft > 0 else t

        async def _first(s):
            while True:
                raw = await self._recv_pb(s, timeout=_recv_timeout(),
                                          acc=acc)
                if (vsink is not None
                        and raw.WhichOneof("message") == "verify_result"):
                    vsink.append(raw.verify_result)
                    continue
                return self._classify_frame(raw, worker_id)

        s = self._pool_get(worker_id) if use_pool else None
        if s is not None:
            try:
                await self._send_frame(s, frame, acc=acc)
                return s, await _first(s)
            except (asyncio.CancelledError, _WorkerDraining):
                # A draining reject is an answer, not a stale stream.
                s.close()
                raise
            except asyncio.TimeoutError as e:
                s.close()
                if remaining() <= 0:
                    raise _BudgetExhausted(
                        "budget exhausted on pooled attempt") from e
                if stall_ttft > 0:
                    raise _StreamStalled(worker_id, "ttft") from e
                raise
            except Exception as e:
                s.close()
                if remaining() <= 0:
                    raise _BudgetExhausted(
                        "budget exhausted on pooled attempt") from e
                log.debug("pooled stream to %s stale (%s); redialing",
                          worker_id[:8], e)
        s = await self._dial(worker_id, acc=acc,
                             timeout=(remaining()
                                      if deadline is not None else None),
                             trace_id=msg.trace_id)
        try:
            await self._send_frame(s, frame, acc=acc)
            return s, await _first(s)
        except BaseException as e:
            s.close()
            if (isinstance(e, (asyncio.TimeoutError, OSError))
                    and remaining() <= 0):
                raise _BudgetExhausted(
                    "budget exhausted during dial/first frame") from e
            if isinstance(e, asyncio.TimeoutError) and stall_ttft > 0:
                raise _StreamStalled(worker_id, "ttft") from e
            raise

    async def _hedge_race(self, primary_id: str, msg, frame: bytes,
                          deadline: float | None, stall_ttft: float,
                          acc: dict, hedge_thr: float):
        """Give the primary ``hedge_thr`` seconds to produce a first
        frame; past it, race the same request on the second-best worker
        and keep whichever first frame lands first.  Exactly once: nothing
        reaches the client before one winner is chosen, and every loser
        is closed (hedge_launched == hedge_won + hedge_cancelled).
        Returns ``(stream, first_resp, winner_worker_id)``."""
        tid = msg.trace_id
        p_task = asyncio.ensure_future(self._open_stream(
            primary_id, msg, frame, deadline, stall_ttft, acc))
        tasks: dict[asyncio.Task, str] = {p_task: primary_id}
        launched = False
        try:
            done, _ = await asyncio.wait({p_task}, timeout=hedge_thr)
            if not done:
                # Never pooled: a cancelled leg may be abandoned mid-frame.
                alt = self._find_worker(msg.generate_request.model,
                                        exclude={primary_id}, acc=acc)
                if alt is not None:
                    launched = True
                    self._robust["hedge_launched"] += 1
                    self.obs.trace.record(
                        tid, "hedge", 0, parent=GATEWAY_ROOT_SPAN,
                        primary=primary_id[:8], hedge=alt.peer_id[:8])
                    tasks[asyncio.ensure_future(self._open_stream(
                        alt.peer_id, msg, frame, deadline, stall_ttft,
                        acc, use_pool=False))] = alt.peer_id
            winner = None
            primary_err: BaseException | None = None
            while tasks and winner is None:
                done, _ = await asyncio.wait(
                    set(tasks), return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    wid = tasks.pop(t)
                    err = t.exception()
                    if err is None:
                        if winner is None:
                            winner = (await t, wid)
                        else:
                            (await t)[0].close()  # a same-round loser
                        continue
                    if isinstance(err, _WorkerDraining):
                        # A loser's drain still quarantines it.
                        pm = self.peer.peer_manager
                        if pm is not None:
                            pm.mark_draining(err.worker_id)
                    if wid == primary_id:
                        primary_err = err
            if winner is None:
                # Both legs failed: the hedge did not win; surface the
                # primary's error as an unhedged attempt would.
                if launched:
                    self._robust["hedge_cancelled"] += 1
                if primary_err is not None:
                    raise primary_err
                raise RuntimeError("hedged dispatch failed on every leg")
            (s, first_resp), wid = winner
            if launched:
                if wid == primary_id:
                    self._robust["hedge_cancelled"] += 1
                else:
                    self._robust["hedge_won"] += 1
            return s, first_resp, wid
        finally:
            for t in tasks:
                t.cancel()
            if tasks:
                reaped = await asyncio.gather(*tasks,
                                              return_exceptions=True)
                for r in reaped:
                    if isinstance(r, tuple):
                        r[0].close()

    async def _forward(self, request, worker_id: str, msg, stream: bool,
                       shape: str, t0: float,
                       acc: dict | None = None,
                       ctx: _StreamCtx | None = None,
                       deadline: float | None = None,
                       frame: bytes | None = None) -> web.StreamResponse:
        """Send the request to ``worker_id`` and relay the reply as Ollama
        NDJSON (``chat`` / ``generate``) or OpenAI SSE (``openai-*``).
        ``t0`` is the admission time (TTFB), ``acc`` the request's phase
        accumulator.  On a failover call (``ctx.out`` prepared) the reply
        is replayed and trimmed against ``ctx.sent_text``.  Every
        dial / recv is clamped to what is left before ``deadline``.
        ``frame`` is ``msg`` already encoded (None: encode it here)."""
        if acc is None:
            acc = {}
        if ctx is None:
            ctx = _StreamCtx(shape)
        openai = shape.startswith("openai")

        def remaining() -> float:
            return (deadline - time.monotonic()) if deadline is not None \
                else 600.0

        def _recv_timeout(stall: float = 0.0) -> float:
            t = max(0.05, min(600.0, remaining()))
            return min(t, stall) if stall > 0 else t

        def render(resp, final: bool) -> dict:
            if openai:
                d = self._openai_json(resp, shape, final, stream, ctx.rid,
                                      ctx.created, first=ctx.nth == 0)
                ctx.nth += 1
                return d
            return self._ollama_json(resp, shape == "chat", final=final)

        def classify(raw):
            # worker_id late-bound: a hedge win reassigns it.
            return self._classify_frame(raw, worker_id)

        if not stream:
            resp = classify(await self._roundtrip(
                worker_id, msg, timeout=_recv_timeout(), acc=acc,
                frame=frame))
            if resp.done_reason == "error":
                raise RuntimeError(resp.response)
            return web.json_response(render(resp, final=True))

        # Streamed: the FIRST frame is read before headers go out, so a
        # worker that dies at once is still retryable by _route.
        stall_ttft = self._stall_budget("ttft")
        stall_decode = self._stall_budget("decode")
        if remaining() <= 0:
            raise _BudgetExhausted("budget exhausted before dial")
        if frame is None:
            frame = self._encode_frame(msg, acc=acc)
        # A remote-draft stream interleaves VerifyResult frames with its
        # text frames: they feed the draft pump and never reach the
        # client; it is not hedged (a raced duplicate would consume the
        # draft window twice) and not pooled back (one-shot on the worker
        # too).
        rd = bool(msg.generate_request.remote_draft)
        vsink: list | None = [] if rd else None
        # The hedge only on a stream's first attempt: a replay already has
        # client bytes out.
        hedge_thr = (self._hedge_threshold() if ctx.out is None and not rd
                     else 0.0)
        if hedge_thr > 0:
            s, first, worker_id = await self._hedge_race(
                worker_id, msg, frame, deadline, stall_ttft, acc, hedge_thr)
        else:
            s, first = await self._open_stream(
                worker_id, msg, frame, deadline, stall_ttft, acc,
                vsink=vsink)
        ctx.winner = worker_id
        pump = None
        if rd:
            pump = self._spec_pump(s, msg, acc, worker_id)
            for vr in vsink:
                await pump.on_verify(vr)
        # Pooled back only once the terminal frame was read.
        clean = False
        try:
            if first.done_reason == "error":
                raise RuntimeError(first.response)
            if ctx.out is None:
                self._observe_ttfb(time.monotonic() - t0, tid=msg.trace_id)
                out = web.StreamResponse(
                    status=200,
                    headers={"Content-Type": ("text/event-stream" if openai
                                              else "application/x-ndjson")})
                await out.prepare(request)
                ctx.out = out
            out = ctx.out

            async def write_frame(payload: dict) -> None:
                # A client-side write failure is final (_StreamStarted).
                line = json.dumps(payload).encode()
                tw = time.perf_counter_ns()
                try:
                    if openai:
                        await out.write(b"data: " + line + b"\n\n")
                    else:
                        await out.write(line + b"\n")
                except Exception as e:
                    raise _StreamStarted(out, e) from e
                acc["stream_flush_ns"] = acc.get("stream_flush_ns", 0) \
                    + time.perf_counter_ns() - tw

            # Replay trim (failover): the first len(sent_text) characters
            # of the new reply were delivered already; skip them by count.
            skip = len(ctx.sent_text)
            replay_pos = 0
            diverged = False
            resp = first
            # Gap between frames ~ the worker's decode step + the wire.
            t_prev = time.perf_counter_ns()
            while True:
                if resp.done_reason == "error":
                    raise RuntimeError(resp.response)
                text = resp.response
                trimmed_empty = False
                if skip > 0 and text:
                    take = min(skip, len(text))
                    if (not diverged
                            and ctx.sent_text[replay_pos:replay_pos + take]
                            != text[:take]):
                        diverged = True
                        log.warning(
                            "failover replay diverged from delivered text "
                            "at char %d (request %s); resuming by count",
                            replay_pos, ctx.rid)
                    replay_pos += take
                    skip -= take
                    text = text[take:]
                    resp.response = text
                    self._robust["replayed_chunks"] += 1
                    trimmed_empty = not text
                if resp.done or not trimmed_empty:
                    ctx.sent_text += text
                    await write_frame(render(resp, final=resp.done))
                if resp.done:
                    clean = True
                    break
                if remaining() <= 0:
                    raise _BudgetExhausted("budget exhausted mid-stream")
                try:
                    while True:
                        raw = await self._recv_pb(
                            s, timeout=_recv_timeout(stall_decode), acc=acc)
                        if (pump is None or raw.WhichOneof("message")
                                != "verify_result"):
                            break
                        await pump.on_verify(raw.verify_result)
                    resp = classify(raw)
                except asyncio.TimeoutError as e:
                    if remaining() <= 0:
                        raise _BudgetExhausted(
                            "budget exhausted mid-stream") from e
                    if stall_decode > 0:
                        # Frames stopped with the transport open: fail
                        # over, the replay trim resumes the client.
                        raise _StreamStalled(worker_id, "decode") from e
                    raise
                t_now = time.perf_counter_ns()
                self.obs.metrics.decode_step_seconds.observe(
                    (t_now - t_prev) / 1e9, exemplar=msg.trace_id)
                self.slo.observe_decode((t_now - t_prev) / 1e9)
                t_prev = t_now
            try:
                if openai:
                    await out.write(b"data: [DONE]\n\n")
                await out.write_eof()
            except Exception as e:
                raise _StreamStarted(out, e) from e
            return out
        finally:
            if pump is not None:
                st = self._spec_stats
                st["chunks"] += pump.chunks_sent
                st["acks"] += pump.acks_sent
                st["nacks"] += pump.nacks
                st["accepted"] += pump.tokens_accepted
                st["offered"] += pump.tokens_offered
                if pump.ctrl.rtt_ewma > 0.0 and pump.ctrl.step_ewma > 0.0:
                    self._spec_wire[worker_id] = (pump.ctrl.rtt_ewma,
                                                  pump.ctrl.step_ewma)
            if clean and pump is None:
                self._pool_put(worker_id, s)
            else:
                s.close()

    def _drafter(self):
        """The gateway's draft model, loaded on the first remote-draft
        stream; None in "worker" mode or when the checkpoint is unusable
        (the pump then sends pure ack credits)."""
        if self.spec_pipeline != "gateway":
            return None
        if self._spec_drafter is None and not self._spec_drafter_tried:
            self._spec_drafter_tried = True
            if not self.spec_draft_path:
                log.warning("spec_pipeline=gateway with no draft "
                            "checkpoint; degrading to ack pacing")
            else:
                try:
                    from crowdllama_tpu_torch.gateway.draft import (
                        GatewayDrafter,
                    )

                    self._spec_drafter = GatewayDrafter.from_checkpoint(
                        self.spec_draft_path, device=self.spec_device)
                    log.info("gateway draft model loaded from %s",
                             self.spec_draft_path)
                except Exception as e:
                    log.warning("gateway draft load failed (%s); "
                                "degrading to ack pacing", e)
        return self._spec_drafter

    def _spec_pump(self, s, msg, acc: dict, worker_id: str):
        """The stream's draft pump, writing to ``s``, its depth controller
        warm-started from the last stream to the same worker."""
        from crowdllama_tpu_torch.gateway.draft import SpecPipelinePump

        async def send(frame: bytes) -> None:
            await self._send_frame(s, frame, acc=acc)

        pump = SpecPipelinePump(model=msg.generate_request.model, send=send,
                                drafter=self._drafter())
        wire_est = self._spec_wire.get(worker_id)
        if wire_est is not None:
            pump.ctrl.rtt_ewma, pump.ctrl.step_ewma = wire_est
        return pump

    @staticmethod
    def _ollama_json(resp, chat: bool, final: bool) -> dict:
        """A GenerateResponse as Ollama JSON."""
        d: dict = {
            "model": resp.model,
            "created_at": _now_rfc3339(),
            "done": resp.done,
        }
        if chat:
            d["message"] = {"role": "assistant", "content": resp.response}
        else:
            d["response"] = resp.response
        if final:
            d["done_reason"] = resp.done_reason or "stop"
            d["total_duration"] = resp.total_duration
            d["prompt_eval_count"] = resp.prompt_tokens
            d["eval_count"] = resp.completion_tokens
            d["worker_id"] = resp.worker_id
        return d

    @staticmethod
    def _openai_json(resp, shape: str, final: bool, stream: bool,
                     rid: str, created: int, first: bool = False) -> dict:
        """A GenerateResponse as OpenAI JSON (chat.completion[.chunk] /
        text_completion)."""
        chat = shape == "openai-chat"
        finish = ({"stop": "stop", "length": "length"}.get(
            resp.done_reason or "stop", "stop") if final else None)
        if chat:
            if stream:
                delta: dict = {}
                if first:
                    # The role arrives on the opening delta.
                    delta["role"] = "assistant"
                    delta["content"] = ""
                if resp.response:
                    delta["content"] = resp.response
                choice: dict = {"index": 0, "delta": delta,
                                "finish_reason": finish}
            else:
                choice = {"index": 0,
                          "message": {"role": "assistant",
                                      "content": resp.response},
                          "finish_reason": finish}
            obj = "chat.completion.chunk" if stream else "chat.completion"
        else:
            choice = {"index": 0, "text": resp.response,
                      "finish_reason": finish}
            obj = "text_completion"
        d = {"id": rid, "object": obj, "created": created,
             "model": resp.model, "choices": [choice]}
        if final:
            d["usage"] = {
                "prompt_tokens": resp.prompt_tokens,
                "completion_tokens": resp.completion_tokens,
                "total_tokens": resp.prompt_tokens + resp.completion_tokens,
            }
        return d
