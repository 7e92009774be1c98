"""The swarm node: a torch worker, or a consumer in front of a gateway.

Counterpart of ``crowdllama_tpu/peer/peer.py``: one node object owning
the stream host, the DHT node, the capability metadata, the peer manager
and the engine seam.  It serves the metadata
stream and the DHT ``metadata`` op, runs the metadata refresh / publish /
advertise loops (re-bootstrapping when the routing table empties) and
serves the inference stream: llama.v1 requests in a loop per stream, so
a gateway's stream pool amortizes the handshake.

A worker's advertised metadata is the engine's live telemetry;
``gpu_model``, ``vram_gb`` and ``accelerator`` come from ``torch.cuda``
for the device the engine serves on (the TPU-only fields keep their
defaults).  A consumer (``worker_mode=False``) runs no model: its engine
is ``FakeEngine(models=[])``, it advertises ``worker_mode=false`` with
node ``"consumer"`` on its ``NodeObs``, and it runs discovery, the peer
manager and the metadata handlers so its gateway (``gateway/``) can
route.

NAT traversal (``net/relay.py``): a worker the bootstrap node cannot dial
back (or any worker under ``relay_mode="always"``) registers with a relay
and advertises the relay's address, failing over to any
``relay_capable`` swarm peer; a directly reachable worker hosts a
``RelayService`` itself; under ``"auto"`` the re-probe moves a worker
between the two as its reachability changes; a consumer's dial-back
probe confirms its own port so its dials to relayed workers try
connection reversal first.

A remote-draft stream (the gateway-drafted speculative pipeline): a
reader task drains the gateway's ``DraftChunk`` frames into a
``DraftFeed`` that the scheduler paces on, when the engine can verify
remote drafts (``supports_remote_draft``); on any other engine
(``FakeEngine``, a plain runner) it nacks each chunk, so the gateway's
pump degrades to plain streaming.

KV shipping, donor side: a ``kv_fetch_request`` is answered with the
engine's exported pages in ``KvPages`` frames of about 4 MiB each, errors
in band; a draining worker keeps serving fetches as its migrated streams'
donor.  The replicated gateway: a consumer's ``GossipNode``
(``swarm/gossip.py``) attaches itself as ``gossip_node``, and inbound
``gossip_frame`` messages go to it (a node without one ignores them).

Swarm model sharing (``net/model_share.py``): a worker serves
``MODEL_PROTOCOL`` (its checkpoints' manifests and files, and the
``pull`` trigger, unless ``allow_swarm_pull`` is off) and
:meth:`Peer.pull_model` acquires a model from a worker that advertises
it, then hot-registers it on the engine.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.core import llama_v1 as pb
from crowdllama_tpu_torch.core.spec_pipeline import DraftFeed
from crowdllama_tpu_torch.core import wire
from crowdllama_tpu_torch.core.messages import (
    create_embed_response,
    genresp_frame_bytes,
    kv_pages_msg,
    metrics_snapshot_msg,
    trace_spans_msg,
    verify_result_msg,
)
from crowdllama_tpu_torch.core.protocol import (
    INFERENCE_PROTOCOL,
    METADATA_PROTOCOL,
    metadata_key,
    namespace_key,
)
from crowdllama_tpu_torch.core.resource import Resource
from crowdllama_tpu_torch.engine.engine import Engine
from crowdllama_tpu_torch.net.discovery import (
    discover_peers,
    new_host_and_dht,
    request_peer_metadata,
)
from crowdllama_tpu_torch.net import relay
from crowdllama_tpu_torch.net.host import STREAM_POOL_IDLE_S, Contact, Stream
from crowdllama_tpu_torch.obs import NodeObs
from crowdllama_tpu_torch.obs.http import node_metric_lines
from crowdllama_tpu_torch.peermanager.manager import (
    PeerHealthConfig,
    PeerManager,
)
from crowdllama_tpu_torch.testing import faults
from crowdllama_tpu_torch.utils.aio import run_every
from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey
from crowdllama_tpu_torch.version import VERSION

log = logging.getLogger("crowdllama.torch.peer")


def _engine_device(engine):
    """The torch device ``engine`` serves on (a MultiEngine's first
    child's), or None for an engine without one (FakeEngine)."""
    dev = getattr(engine, "device", None)
    if dev is None:
        children = getattr(engine, "_engines", None)
        if children:
            dev = getattr(next(iter(children.values())), "device", None)
    return dev


def device_capabilities(device) -> dict:
    """Resource fields for the device an engine serves on: the card's
    name and total memory in GiB from ``torch.cuda``, or ``"cpu"``."""
    if device is None:
        return {}
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"accelerator": device.type, "gpu_model": "", "vram_gb": 0}
    index = device.index if device.index is not None else 0
    name = torch.cuda.get_device_name(index)
    total = torch.cuda.get_device_properties(index).total_memory
    return {"accelerator": name.lower().replace(" ", "-"),
            "gpu_model": name, "vram_gb": int(round(total / (1 << 30)))}


def _single_process() -> bool:
    """Whether a pull may hot-register a second engine: a swarm pull's
    second engine is one multi-process leader-replicated serving cannot
    represent (parallel/replicated.py), so the pull is refused at the
    service on a multi-process cluster."""
    from crowdllama_tpu_torch.parallel import multihost

    return multihost.process_count() == 1


class Peer:
    """One swarm node: a worker serving ``engine``, or a consumer."""

    def __init__(self, key: Ed25519PrivateKey, config: Configuration,
                 engine: Engine, worker_mode: bool = True):
        self.config = config
        self.key = key
        self.engine = engine
        self.worker_mode = bool(worker_mode)
        self.host = None
        self.dht = None
        self.resource = Resource(worker_mode=self.worker_mode,
                                 version=VERSION)
        self.peer_manager: PeerManager | None = None
        self.relay_client = None  # net/relay.py RelayClient when relaying
        self.relay_service = None  # RelayService when hosting one
        self._tasks: list[asyncio.Task] = []
        self._draining = False
        # Replicated gateway plane: a consumer's GossipNode attaches here
        # and the serve loop hands it inbound gossip frames.
        self.gossip_node = None
        self._capabilities = (device_capabilities(_engine_device(engine))
                              if self.worker_mode else {})
        self.obs = NodeObs(trace_capacity=config.trace_buffer or 64,
                           node="worker" if self.worker_mode else "consumer",
                           trace_ttl=config.trace_ttl or 0.0,
                           exemplars=bool(config.metrics_exemplars))

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self.host, self.dht = await new_host_and_dht(
            self.key, listen_host=self.config.listen_host,
            listen_port=self.config.listen_port)
        self.resource.peer_id = self.host.peer_id
        self.update_metadata()
        self.host.set_stream_handler(METADATA_PROTOCOL,
                                     self._handle_metadata_stream)
        # Health probes and discovery prefer the pooled KAD "metadata" op;
        # the read-to-EOF stream above stays served as the fallback.
        self.dht.metadata_provider = self._metadata_snapshot
        self.host.set_stream_handler(INFERENCE_PROTOCOL,
                                     self._handle_inference_stream)
        if self.worker_mode:
            from crowdllama_tpu_torch.core.protocol import MODEL_PROTOCOL
            from crowdllama_tpu_torch.net.model_share import (
                ModelShareService,
            )

            self._model_share = ModelShareService(
                model_dir=self.engine.model_dir, pull=self.pull_model,
                allow_pull=(getattr(self.config, "allow_swarm_pull", True)
                            and _single_process()))
            self.host.set_stream_handler(MODEL_PROTOCOL,
                                         self._model_share.handle)
        shard_service = getattr(self.engine, "shard_service", None)
        if shard_service is not None:
            from crowdllama_tpu_torch.core.protocol import SHARD_PROTOCOL

            # Sharded-model member: serve our shard to group leaders.
            self.host.set_stream_handler(SHARD_PROTOCOL, shard_service.handle)
        self.engine.obs = self.obs
        self.engine.attach_peer(self)
        self.peer_manager = PeerManager(
            self_peer_id=self.host.peer_id,
            config=PeerHealthConfig(intervals=self.config.intervals),
            metadata_fetcher=self._fetch_peer_metadata,
            discovery=self._run_discovery,
            on_peer_removed=self.dht.evict_peer)
        self.dht.peer_seen = self.peer_manager.mark_seen
        if self.config.bootstrap_peers:
            n = await self.dht.bootstrap(self.config.bootstrap_peers)
            log.info("bootstrapped to %d/%d peers", n,
                     len(self.config.bootstrap_peers))
        await self._setup_relay()
        self.peer_manager.start()
        iv = self.config.intervals
        self.dht.start_maintenance(provider_check=iv.dht_provider_check,
                                   bucket_refresh=iv.dht_bucket_refresh)
        self._tasks = [
            asyncio.create_task(
                run_every(iv.metadata_refresh, self.update_metadata, log,
                          logging.DEBUG), name="peer-metadata-refresh"),
            asyncio.create_task(
                run_every(iv.metadata_publish, self._publish_metadata, log,
                          logging.DEBUG), name="peer-publish"),
            asyncio.create_task(
                run_every(iv.advertise, self._advertise, log, logging.DEBUG),
                name="peer-advertise"),
        ]
        if self.worker_mode and self.config.relay_mode == "auto":
            self._tasks.append(asyncio.create_task(
                run_every(iv.relay_reprobe, self._reprobe_relay, log,
                          logging.DEBUG), name="peer-relay-reprobe"))
        log.info("peer %s up (%s) on %s", self.host.peer_id[:8],
                 "worker" if self.worker_mode else "consumer",
                 self.host.contact.addr)

    async def _setup_relay(self) -> None:
        """NAT traversal: a worker the bootstrap node cannot dial back
        registers for reverse streams through it (failing over to any
        relay_capable swarm peer) and advertises the relay's address; a
        directly reachable worker hosts a RelayService and advertises
        relay_capable, so relay capacity grows with the swarm's public
        members."""
        if self.config.relay_mode == "off":
            return
        if not self.worker_mode:
            # A consumer never relays, but a dial-back-confirmed listen
            # port lets its dials to relayed workers try connection
            # reversal: the worker dials back and the data path skips the
            # relay.
            if self.config.bootstrap_peers:
                try:
                    self.host.reverse_dialable = await relay.dialback_probe(
                        self.host, self.config.bootstrap_peers[0])
                except Exception as e:
                    log.debug("consumer dialback probe unavailable (%s)", e)
            return
        if not self.config.bootstrap_peers:
            self._start_relay_service()
            return
        relay_addr = self.config.bootstrap_peers[0]
        if self.config.relay_mode == "auto":
            try:
                if await relay.dialback_probe(self.host, relay_addr):
                    self.host.reverse_dialable = True
                    self._start_relay_service()
                    return
            except Exception as e:
                # No relay service at the bootstrap node: relaying through
                # it is impossible either way, so stay direct rather than
                # stall startup on a doomed registration.
                log.debug("dialback probe unavailable (%s); staying "
                          "direct", e)
                return
        await self._register_relay(relay_addr)

    async def _register_relay(self, relay_addr: str) -> bool:
        """Register for reverse streams via ``relay_addr`` (with failover
        candidates); False when the registration cannot start."""
        log.info("worker not directly reachable: relaying via %s", relay_addr)
        # Stop advertising the direct address BEFORE registering, so no
        # peer learns a bogus direct contact.
        self.host.hello_dialable = False
        client = relay.RelayClient(self.host, relay_addr,
                                   candidates=self._relay_candidates,
                                   on_relay_change=self._on_relay_change)
        try:
            await client.start()
        except Exception:
            await client.stop()  # the reconnect loop too
            self.host.hello_dialable = True  # direct-only beats dead
            log.exception("relay registration failed; staying direct")
            return False
        self.relay_client = client
        self.host.reverse_dialable = False  # confirmed not dialable
        if self.relay_service is not None:
            # A NATed node cannot relay for others.
            self.relay_service.close()
            self.relay_service = None
            self.resource.relay_capable = False
        self._on_relay_change(client.relay_addr)
        return True

    def _start_relay_service(self) -> None:
        """Host a RelayService for NATed swarm members."""
        if self.relay_service is None:
            self.relay_service = relay.RelayService(self.host)
            # Traced splices record relay_splice spans into this node's
            # ring, so the trace collector can fetch the relay hop.
            self.relay_service.obs = self.obs
            self.resource.relay_capable = True
            log.info("hosting relay service for NATed peers")

    def _relay_candidates(self) -> list[str]:
        """Failover relay addresses: the bootstrap peers first, then every
        healthy peer advertising relay_capable (resolved through the local
        routing table, no network round trip)."""
        cands = list(self.config.bootstrap_peers)
        try:
            capable = {
                p.peer_id for p in self.peer_manager.get_healthy_peers()
                if getattr(p.resource, "relay_capable", False)}
            for c in self.dht.table.contacts():
                if c.peer_id in capable and not c.relay:
                    cands.append(f"{c.host}:{c.port}")
        except Exception as e:
            log.debug("relay candidate scan failed: %s", e)
        seen: set[str] = set()
        return [a for a in cands if not (a in seen or seen.add(a))]

    def _on_relay_change(self, relay_addr: str) -> None:
        """(Re-)advertise the current relay contact: fires on every
        successful registration, failover to a new relay included."""
        rhost, _, rport = relay_addr.rpartition(":")
        self.host.relay_contact = Contact(
            peer_id=self.host.peer_id, host=rhost or "127.0.0.1",
            port=int(rport), relay=True)
        self.resource.reachability = "relay"
        self.update_metadata()

    async def _reprobe_relay(self) -> None:
        """``relay_mode="auto"`` tracks reachability both ways: a relaying
        worker whose port became reachable drops the relay, and a direct
        worker whose port stopped being reachable goes back to relaying
        (otherwise a transiently open NAT would strand the worker
        advertising a dead direct address)."""
        if self.config.relay_mode != "auto":
            return
        if self.relay_client is not None:
            try:
                reachable = await relay.dialback_probe(
                    self.host, self.relay_client.relay_addr)
            except Exception:
                return  # relay gone mid-probe: the client fails over
            if not reachable:
                return
            log.info("direct dialback succeeded; dropping relay %s",
                     self.relay_client.relay_addr)
            await self.relay_client.stop()
            self.relay_client = None
            self.host.relay_contact = None
            self.host.hello_dialable = True
            self.host.reverse_dialable = True
            self.resource.reachability = "direct"
            self._start_relay_service()
            self.update_metadata()
            await self._publish_metadata()
            return
        cands = self._relay_candidates()
        if not cands:
            return
        try:
            reachable = await relay.dialback_probe(self.host, cands[0])
        except Exception:
            return  # no relay service reachable to probe through
        if reachable:
            self.host.reverse_dialable = True
            return
        log.info("direct dialback stopped succeeding; returning to relay")
        if await self._register_relay(cands[0]):
            await self._publish_metadata()

    async def stop_advertising(self) -> None:
        """Stop the publish/advertise/refresh loops without closing
        streams: the swarm stops learning about this peer while in-flight
        requests keep being served."""
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []

    async def drain(self) -> int:
        """Graceful drain: flip to ``draining`` and hand off in-flight
        generation; idempotent.  The engine's migration is requested
        first (the scheduler claims every stream at its next safe point),
        then the advertised metadata flips to ``draining`` with one forced
        provide, then the migration is awaited.  New GenerateRequests get
        the typed ``draining`` reject from here on, but the serve loops
        stay up: the node keeps answering KvFetchRequests as the donor of
        the streams it migrated.  Returns how many requests were
        migrated."""
        if self._draining:
            return 0
        self._draining = True
        self.resource.draining = True
        self.resource.draining_reason = "drain"
        self.resource.touch()
        self.obs.metrics.drain_inc("initiated")
        t0 = time.perf_counter_ns()
        migrating = asyncio.ensure_future(self.engine.migrate())
        await self.stop_advertising()
        if self.dht is not None and self.host is not None:
            try:
                await self.dht.reconnect_if_needed()
                await asyncio.wait_for(
                    self.dht.provide(metadata_key(self.host.peer_id.encode()),
                                     min_interval=0), timeout=5.0)
            except Exception as e:
                log.warning("drain metadata publish failed: %s", e)
        migrated = await migrating
        self.obs.trace.record(f"drain-{self.peer_id[:8]}", "drain",
                              time.perf_counter_ns() - t0, migrated=migrated)
        log.info("peer %s draining: %d in-flight requests migrated",
                 self.peer_id[:8], migrated)
        return migrated

    async def pull_model(self, model: str) -> str:
        """Acquire ``model`` from a swarm peer and serve it: resolve the
        healthy workers advertising it, stream a checkpoint from the first
        that has one (each file SHA-256-verified, net/model_share.py), then
        hot-register it on the engine (``MultiEngine.add_model``).
        Returns the local checkpoint path."""
        from crowdllama_tpu_torch.net.model_share import (
            fetch_model,
            safe_model_dirname,
        )

        safe_model_dirname(model)  # reject path-traversal names up front
        if model in (self.engine.models or []):
            return self.engine.model_dir(model) or ""
        if self.peer_manager is None:
            raise RuntimeError("peer not started")
        candidates = [
            p for p in self.peer_manager.get_healthy_peers()
            if p.is_worker and model in p.resource.supported_models
            and p.peer_id != self.peer_id]
        if not candidates:
            raise RuntimeError(f"no swarm peer advertises model {model!r}")
        last_err: Exception | None = None
        for cand in candidates:
            try:
                contact = await self.dht.find_peer(cand.peer_id)
                if contact is None:
                    raise RuntimeError(f"cannot resolve {cand.peer_id[:8]}")
                dest = await fetch_model(self.host, contact, model,
                                         self.config.models_dir)
                break
            except Exception as e:  # source without a checkpoint, wire error
                log.warning("pull of %s from %s failed: %s", model,
                            cand.peer_id[:8], e)
                last_err = e
        else:
            raise RuntimeError(f"pull failed from every source: {last_err}")
        add = getattr(self.engine, "add_model", None)
        if add is None:
            # Succeeding here would let /api/pull report success for a
            # model /api/chat then refuses.
            raise RuntimeError(
                f"checkpoint downloaded to {dest} but this worker's engine "
                f"cannot hot-register models; restart with --model {model} "
                f"--model-path {dest}")
        await add(model, str(dest))
        return str(dest)

    async def stop(self) -> None:
        await self.stop_advertising()
        # Departure publish before the teardown: peers that re-probe in
        # the window see draining=true and deroute.
        if self.dht is not None and self.host is not None:
            self.resource.draining = True
            self.resource.touch()
            try:
                await asyncio.wait_for(
                    self.dht.provide(metadata_key(self.host.peer_id.encode()),
                                     min_interval=0), timeout=2.0)
            except Exception as e:
                log.debug("departure publish failed: %s", e)
        if self.relay_client is not None:
            await self.relay_client.stop()
            self.relay_client = None
        if self.relay_service is not None:
            self.relay_service.close()
            self.relay_service = None
        if self.peer_manager is not None:
            await self.peer_manager.stop()
        if self.dht is not None:
            await self.dht.stop_maintenance()
        if self.host is not None:
            await self.host.close()

    @property
    def peer_id(self) -> str:
        return self.host.peer_id if self.host else ""

    # ------------------------------------------------------------ metadata

    def update_metadata(self) -> None:
        """Refresh the advertised Resource from live engine telemetry."""
        d = self.engine.describe()
        r = self.resource
        r.supported_models = list(d.get("models", []))
        r.tokens_throughput = float(d.get("throughput", 0.0))
        r.load = float(d.get("load", 0.0))
        r.version = VERSION
        r.worker_mode = self.worker_mode
        r.max_context_length = self.config.max_context_length
        r.embeddings = bool(d.get("embeddings", True))
        for k, v in self._capabilities.items():
            setattr(r, k, v)
        sg = d.get("shard_group")
        if sg is not None:
            r.shard_group = sg
        r.touch()

    async def _publish_metadata(self) -> None:
        """Provide this peer's stable metadata key (refreshed in place)."""
        await self.dht.reconnect_if_needed()
        await self.dht.provide(metadata_key(self.host.peer_id.encode()),
                               min_interval=self.config.intervals.reprovide)

    async def _advertise(self) -> None:
        """Provide the namespace rendezvous key; the network re-provide is
        rate-limited to ``intervals.reprovide``."""
        await self.dht.reconnect_if_needed()
        await self.dht.provide(namespace_key(),
                               min_interval=self.config.intervals.reprovide)

    # ------------------------------------------------------------- streams

    def _metadata_snapshot(self) -> bytes:
        """Current Resource JSON (refreshed, so probes see live load)."""
        self.update_metadata()
        return self.resource.to_json()

    async def _handle_metadata_stream(self, stream: Stream) -> None:
        """Serve Resource JSON and close."""
        stream.writer.write(self._metadata_snapshot())
        await stream.writer.drain()
        stream.writer.write_eof()
        if self.peer_manager is not None:
            self.peer_manager.mark_seen(stream.remote_peer_id)

    async def _handle_inference_stream(self, stream: Stream) -> None:
        """Serve inference requests on one stream until the client closes
        or idles out.  A streamed generate request gets one frame per
        chunk, done on the last; everything else one reply frame."""
        while await self._serve_one_inference(stream):
            pass

    async def _serve_one_inference(self, stream: Stream) -> bool:
        """One request/reply exchange; False ends the stream's loop."""
        try:
            # The idle window outlasts the gateway pool's (plus slack).
            msg = await wire.read_length_prefixed_pb(
                stream.reader,
                timeout=max(self.config.intervals.stream_read_timeout,
                            STREAM_POOL_IDLE_S + 5.0))
        except (wire.WireError, pb.DecodeError, asyncio.TimeoutError,
                OSError) as e:
            log.debug("inference stream read ended: %s", e)
            return False
        tid = msg.trace_id
        which = msg.WhichOneof("message")
        try:
            if which == "embed_request":
                reply = await self.engine.handle(msg, worker_id=self.peer_id)
                reply.trace_id = tid
                await wire.write_length_prefixed_pb(stream.writer, reply)
                return True
            if which == "kv_fetch_request":
                await self._serve_kv_fetch(stream, msg)
                return True
            if which == "trace_fetch":
                await self._serve_trace_fetch(stream, msg)
                return True
            if which == "metrics_fetch":
                await self._serve_metrics_fetch(stream, msg)
                return True
            if which == "gossip_frame":
                # Replicated gateway anti-entropy: merge, and answer with
                # our own frame when the sender asks to sync.  A node
                # without a gossip node ignores the frame.
                if self.gossip_node is not None:
                    reply = await self.gossip_node.handle_frame(msg)
                    if reply is not None:
                        reply.trace_id = tid
                        await wire.write_length_prefixed_pb(stream.writer,
                                                            reply)
                return True
            if which == "draft_chunk":
                # A DraftChunk outside a remote-draft stream: nack it
                # terminally so the sender's pump stops.
                dc = msg.draft_chunk
                nack = verify_result_msg(
                    chunk_id=dc.chunk_id, position=dc.position, accepted=0,
                    tokens=[], done=True, draft_k=0, depth_hint=1)
                nack.trace_id = tid
                await wire.write_length_prefixed_pb(stream.writer, nack)
                return True
            if which != "generate_request":
                raise ValueError("expected GenerateRequest")
            req = msg.generate_request
            if self._draining:
                # Typed reject: the gateway fails over without spending its
                # failover budget; the stream stays open.
                self.obs.metrics.drain_inc("rejected_requests")
                await wire.write_frame_bytes(stream.writer, genresp_frame_bytes(
                    model=req.model, response="", worker_id=self.peer_id,
                    done=True, done_reason="draining", trace_id=tid))
                return True
            if req.stream:
                return await self._serve_streamed(stream, msg)
            reply = await self.engine.handle(msg, worker_id=self.peer_id)
            reply.trace_id = tid
            t0 = time.perf_counter_ns()
            await wire.write_length_prefixed_pb(stream.writer, reply)
            if tid:
                self.obs.trace.record(tid, "stream_flush",
                                      time.perf_counter_ns() - t0,
                                      parent=msg.parent_span)
            return True
        except faults.StallStream as e:
            # Injected gray failure: hold the transport open, write nothing
            # again, until the client gives up and closes its end.
            log.warning("fault injection stalled inference stream: %s", e)
            try:
                await asyncio.wait_for(stream.reader.read(), timeout=600.0)
            except Exception:
                pass
            stream.close()
            return False
        except faults.KillStream as e:
            # Injected worker death: drop the transport with no error frame.
            log.warning("fault injection killed inference stream: %s", e)
            stream.close()
            return False
        except Exception as e:
            log.warning("inference failed: %s", e)
            if which == "embed_request":
                # "invalid:" marks a client error (no retry elsewhere); a
                # capability gap stays retryable.
                prefix = "invalid: " if isinstance(e, ValueError) else ""
                detail = str(e) or (
                    "this worker's engine does not support embeddings"
                    if isinstance(e, NotImplementedError) else repr(e))
                err = create_embed_response(
                    model=msg.embed_request.model, embeddings=[],
                    worker_id=self.peer_id, error=prefix + detail)
                err.trace_id = tid
                err_frame = wire.encode_frame(err)
            else:
                err_frame = genresp_frame_bytes(
                    model=(msg.generate_request.model
                           if which == "generate_request" else ""),
                    response=f"error: {e}", worker_id=self.peer_id,
                    done=True, done_reason="error", trace_id=tid)
            try:
                await wire.write_frame_bytes(stream.writer, err_frame)
            except Exception:
                return False  # writer dead: end the stream's serve loop
            return True

    async def _serve_streamed(self, stream: Stream, msg) -> bool:
        """A streamed generate request: the engine's encoded frames through
        a ``FrameBatcher`` (the first frame inline, later frames coalesced
        per loop tick into one sealed write).  On a remote-draft request a
        reader task meanwhile feeds the gateway's DraftChunk credits to the
        engine's ``DraftFeed`` (or nacks them when it cannot verify)."""
        tid = msg.trace_id
        remote_draft = bool(msg.generate_request.remote_draft)
        feed = reader_task = None
        if remote_draft:
            feed = DraftFeed()
            reader_task = asyncio.get_running_loop().create_task(
                self._read_draft_chunks(
                    stream, feed, tid,
                    bool(getattr(self.engine, "supports_remote_draft",
                                 False))))
        flush_ns = 0
        batcher = wire.FrameBatcher(stream.writer)
        try:
            async for frame in self.engine.handle_streaming_frames(
                    msg, worker_id=self.peer_id, draft_feed=feed):
                t0 = time.perf_counter_ns()
                batcher.write(frame)
                await batcher.drain()
                flush_ns += time.perf_counter_ns() - t0
            t0 = time.perf_counter_ns()
            await batcher.flush()
            flush_ns += time.perf_counter_ns() - t0
        finally:
            if reader_task is not None:
                reader_task.cancel()
                try:
                    await reader_task
                except (asyncio.CancelledError, Exception):
                    pass
                feed.close()
        if tid:
            self.obs.trace.record(tid, "stream_flush", flush_ns,
                                  parent=msg.parent_span)
        # A remote-draft stream is one-shot: the cancelled reader may have
        # left part of a DraftChunk in the receive buffer.
        return not remote_draft

    async def _read_draft_chunks(self, stream: Stream, feed: DraftFeed,
                                 tid: str, consume: bool) -> None:
        """Reader side of a remote-draft stream: each DraftChunk is pushed
        into ``feed`` (one pipeline credit), or, when the engine cannot
        verify (``consume`` False), nacked at once so the gateway streams
        unpaced.  A transport error closes the feed: the scheduler frees
        the stream and the generation finishes on its own."""
        try:
            while True:
                msg = await wire.read_length_prefixed_pb(stream.reader,
                                                         timeout=600.0)
                if msg.WhichOneof("message") != "draft_chunk":
                    continue
                dc = msg.draft_chunk
                await faults.inject("spec.draft_chunk", worker=self.peer_id,
                                    chunk_id=int(dc.chunk_id))
                if consume:
                    feed.push(dc.chunk_id, dc.position, list(dc.tokens))
                    continue
                await faults.inject("spec.verify", worker=self.peer_id,
                                    chunk_id=int(dc.chunk_id))
                nack = verify_result_msg(
                    chunk_id=dc.chunk_id, position=dc.position, accepted=0,
                    tokens=[], done=False, draft_k=0, depth_hint=1)
                if tid:
                    nack.trace_id = tid
                # Whole-frame write: the batcher seals complete frames, so
                # interleaving with the response frames is safe.
                await wire.write_length_prefixed_pb(stream.writer, nack)
        except asyncio.CancelledError:
            raise
        except faults.KillStream as e:
            # Injected worker death mid-verify: drop the transport with no
            # error frame.
            log.warning("fault injection killed draft reader: %s", e)
            stream.close()
            feed.close()
        except Exception as e:
            log.debug("draft chunk reader ended: %s", e)
            feed.close()

    def _node_label(self) -> str:
        return f"{self.obs.trace.node or 'peer'}:{self.peer_id[:8]}"

    async def _serve_trace_fetch(self, stream: Stream, msg) -> None:
        """The trace collector's span-fragment fetch: this node's JSON
        record of the trace, or ``found=false``."""
        trace_id = msg.trace_fetch.trace_id
        rec = self.obs.trace.get(trace_id) if trace_id else None
        if rec is None:
            out = trace_spans_msg(trace_id, node=self._node_label(),
                                  found=False)
        else:
            out = trace_spans_msg(trace_id, node=self._node_label(),
                                  payload=json.dumps(rec).encode("utf-8"),
                                  found=True)
        out.trace_id = trace_id
        await wire.write_length_prefixed_pb(stream.writer, out)

    async def _serve_metrics_fetch(self, stream: Stream, msg) -> None:
        """The gateway's cluster-scrape fetch: ``node_metric_lines``,
        prefix-filtered by ``families`` (TYPE headers follow their
        family)."""
        node = self._node_label()
        try:
            lines = node_metric_lines(self)
            prefixes = tuple(msg.metrics_fetch.families)
            if prefixes:
                lines = [ln for ln in lines
                         if ln.split()[-2 if ln.startswith("# TYPE") else 0]
                         .startswith(prefixes)]
            out = metrics_snapshot_msg(
                node=node, payload="\n".join(lines).encode("utf-8"),
                found=True)
        except Exception as e:  # a sick node still answers, flagged
            log.warning("metrics snapshot failed: %s", e)
            out = metrics_snapshot_msg(node=node, found=False, error=str(e))
        out.trace_id = msg.trace_id
        await wire.write_length_prefixed_pb(stream.writer, out)

    _KV_FRAME_BYTES = 4 * 1024 * 1024  # page payload per KvPages frame

    async def _serve_kv_fetch(self, stream: Stream, msg) -> None:
        """A peer's paged-KV fetch, donor side: the engine's exported pages
        stream out in KvPages frames of about ``_KV_FRAME_BYTES`` (at least
        one page pair a frame); every failure is reported in band
        (``KvPages.error``) and the fetcher falls back to plain prefill.
        The export pins pages only for its device->host gather, so a slow
        receiver holds no pool pages.  A traced fetch records the
        ``kv_export`` span."""
        req = msg.kv_fetch_request
        tid = msg.trace_id
        await faults.inject("kv.serve", worker=self.peer_id, model=req.model)
        t0 = time.perf_counter_ns()
        try:
            payload = await asyncio.wait_for(
                self.engine.export_kv_pages(
                    req.model, list(req.chain_hashes), int(req.page_size)),
                timeout=max(1.0, self.config.kv_ship_timeout))
        except faults.KillStream:
            raise
        except Exception as e:
            payload, err = None, f"kv export failed: {e}"
        else:
            err = "" if payload is not None else "kv export unavailable"
        if payload is None or payload["matched"] == 0:
            out = kv_pages_msg(pb.KvPages(model=req.model, matched=0,
                                          done=True, error=err))
            out.trace_id = tid
            await wire.write_length_prefixed_pb(stream.writer, out)
            return
        k_pages, v_pages = payload["k_pages"], payload["v_pages"]
        k_scales, v_scales = payload["k_scales"], payload["v_scales"]
        matched = payload["matched"]
        sent_bytes = 0
        start = 0
        while start < matched:
            end, size = start, 0
            while end < matched and (size < self._KV_FRAME_BYTES
                                     or end == start):
                size += len(k_pages[end]) + len(v_pages[end])
                if k_scales:
                    size += len(k_scales[end]) + len(v_scales[end])
                end += 1
            frame = pb.KvPages(model=req.model, matched=matched, start=start,
                               kv_dtype=payload["kv_dtype"],
                               done=end >= matched)
            frame.k_pages.extend(k_pages[start:end])
            frame.v_pages.extend(v_pages[start:end])
            if k_scales:
                frame.k_scales.extend(k_scales[start:end])
                frame.v_scales.extend(v_scales[start:end])
            out = kv_pages_msg(frame)
            out.trace_id = tid
            await wire.write_length_prefixed_pb(stream.writer, out)
            sent_bytes += size
            start = end
        self.obs.metrics.kv_ship_inc("bytes", sent_bytes)
        self.obs.metrics.kv_ship_inc("fetches")
        if tid:
            self.obs.trace.record(tid, "kv_export",
                                  time.perf_counter_ns() - t0,
                                  pages=matched, bytes=sent_bytes)

    # ----------------------------------------------------------- discovery

    async def _fetch_peer_metadata(self, peer_id: str) -> Resource:
        contact = await self.dht.find_peer(peer_id)
        if contact is None:
            raise LookupError(f"peer {peer_id[:8]} not resolvable")
        raw = await self.dht.request_metadata(contact)
        if raw is not None:
            resource = Resource.from_json(raw.encode())
            if resource.peer_id and resource.peer_id != contact.peer_id:
                raise ValueError(
                    f"metadata peer_id {resource.peer_id[:8]} does not "
                    f"match peer {contact.peer_id[:8]}")
            return resource
        return await request_peer_metadata(
            self.host, contact, timeout=self.config.intervals.metadata_timeout)

    async def _run_discovery(self, skip: set[str]) -> list[Resource]:
        return await discover_peers(self.host, self.dht,
                                    intervals=self.config.intervals,
                                    skip_peer_ids=skip)
