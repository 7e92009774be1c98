"""Peer discovery over the DHT: rendezvous advertise + metadata fetch.

Counterpart of ``crowdllama_tpu/net/discovery.py``: build a host and its
DHT node, fetch a peer's Resource JSON over the metadata stream with a
deadline, discover peers (providers of the namespace key, then each one's
metadata, freshness-gated), and advertise the namespace key on a ticker.
"""

from __future__ import annotations

import asyncio
import logging

from crowdllama_tpu_torch.config import Intervals
from crowdllama_tpu_torch.core.protocol import METADATA_PROTOCOL, namespace_key
from crowdllama_tpu_torch.core.resource import Resource
from crowdllama_tpu_torch.net.dht import DHTNode
from crowdllama_tpu_torch.net.host import Contact, Host
from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

log = logging.getLogger("crowdllama.torch.net.discovery")

MAX_METADATA_SIZE = 1 * 1024 * 1024


async def new_host_and_dht(
    key: Ed25519PrivateKey,
    listen_host: str = "0.0.0.0",
    listen_port: int = 0,
    advertise_host: str | None = None,
) -> tuple[Host, DHTNode]:
    """Build and start a host plus a DHT node in server mode."""
    host = Host(key, listen_host=listen_host, listen_port=listen_port,
                advertise_host=advertise_host)
    dht = DHTNode(host, server_mode=True)
    await host.start()
    return host, dht


async def request_peer_metadata(host: Host, target: Contact,
                                timeout: float | None = None) -> Resource:
    """Open a metadata stream and read the peer's Resource JSON to its
    authenticated end (the serving side writes it and closes), bounded by
    ``timeout``."""
    timeout = (timeout if timeout is not None
               else Intervals.default().metadata_timeout)

    async def _fetch() -> Resource:
        stream = await host.new_stream(target, METADATA_PROTOCOL)
        try:
            chunks: list[bytes] = []
            total = 0
            while total <= MAX_METADATA_SIZE:
                chunk = await stream.reader.read(64 * 1024)
                if not chunk:
                    break
                chunks.append(chunk)
                total += len(chunk)
            if total > MAX_METADATA_SIZE:
                raise ValueError("metadata exceeds size cap")
            resource = Resource.from_json(b"".join(chunks))
            if resource.peer_id and resource.peer_id != target.peer_id:
                raise ValueError(
                    f"metadata peer_id {resource.peer_id[:8]} does not match "
                    f"stream peer {target.peer_id[:8]}")
            return resource
        finally:
            stream.close()

    return await asyncio.wait_for(_fetch(), timeout)


async def discover_peers(host: Host, dht: DHTNode,
                         intervals: Intervals | None = None, limit: int = 32,
                         skip_peer_ids: set[str] | None = None
                         ) -> list[Resource]:
    """Find namespace providers and fetch fresh metadata from each.
    ``skip_peer_ids`` (the peer manager's known peers) is applied inside
    ``find_providers``, before its limit, so the limit bounds NEW
    providers per round."""
    intervals = intervals or Intervals.default()
    skip = skip_peer_ids or set()
    providers = await dht.find_providers(namespace_key(), limit=limit,
                                         skip=skip)

    async def _one(contact: Contact) -> Resource | None:
        if contact.peer_id in skip or contact.peer_id == host.peer_id:
            return None
        try:
            resource = await request_peer_metadata(
                host, contact, timeout=intervals.metadata_timeout)
        except Exception as e:
            log.debug("metadata fetch from %s failed: %s",
                      contact.peer_id[:8], e)
            return None
        if resource.age_seconds > intervals.metadata_max_age:
            log.debug("rejecting stale metadata from %s (age %.0fs)",
                      contact.peer_id[:8], resource.age_seconds)
            return None
        if not resource.peer_id:
            resource.peer_id = contact.peer_id
        return resource

    fetched = await asyncio.gather(*(_one(c) for c in providers))
    return [r for r in fetched if r is not None]


class Advertiser:
    """Periodic namespace provider advertisement: re-provide the
    rendezvous key on a ticker, re-bootstrapping first if the routing
    table went empty."""

    def __init__(self, dht: DHTNode, intervals: Intervals | None = None):
        self.dht = dht
        self.intervals = intervals or Intervals.default()
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(), name="advertiser")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            try:
                await self.dht.reconnect_if_needed()
                await self.dht.provide(namespace_key())
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.debug("advertise failed: %s", e)
            await asyncio.sleep(self.intervals.advertise)
