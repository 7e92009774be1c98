"""The bootstrap node's CLI: ``python -m crowdllama_tpu_torch.cli.dht
start | version``.

Counterpart of ``crowdllama_tpu/cli/dht.py``: a long-running rendezvous
node on a well-known port (9000 by default) with its own identity key,
the port's DHT server, and a ``RelayService`` through which NATed workers
register (``net/relay.py``).  It logs its routing-table, stream and relay
counts every 15 seconds and exits 0 on SIGINT or
SIGTERM.  It runs no model and needs no card.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.config import Intervals
from crowdllama_tpu_torch.core.protocol import DEFAULT_DHT_PORT, namespace_key
from crowdllama_tpu_torch.logutil import new_app_logger
from crowdllama_tpu_torch.net.discovery import new_host_and_dht
from crowdllama_tpu_torch.net.relay import RelayService
from crowdllama_tpu_torch.utils.keys import KeyManager
from crowdllama_tpu_torch.version import version_string

log = logging.getLogger("crowdllama.torch.dht-server")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crowdllama-tpu-torch-dht",
                                description="DHT bootstrap/rendezvous server")
    sub = p.add_subparsers(dest="command")
    start = sub.add_parser("start")
    start.add_argument("--port", type=int, default=DEFAULT_DHT_PORT)
    start.add_argument("--host", default="0.0.0.0")
    start.add_argument("--key-path", default="")
    start.add_argument("--verbose", action="store_true")
    sub.add_parser("version")
    return p


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.command == "version":
        print(version_string())
        return 0
    if args.command == "start":
        new_app_logger("crowdllama-dht", args.verbose)
        logging.basicConfig(
            stream=sys.stderr,
            level=logging.DEBUG if args.verbose else logging.INFO)
        native.ensure_built()
        try:
            asyncio.run(run_server(args.host, args.port, args.key_path))
        except KeyboardInterrupt:
            pass
        return 0
    p.print_help()
    return 1


def stats_line(h, dht, relay: RelayService) -> str:
    """One stats log line: routing table, providers, streams, relay."""
    return ("routing table: %d peers | namespace providers: %d | streams "
            "in=%d out=%d rejected=%d | relayed workers: %d | by proto: %s"
            % (len(dht.table), len(dht.providers.get(namespace_key())),
               h.stats["streams_in"], h.stats["streams_out"],
               h.stats["rejected"], relay.registered_count,
               dict(h.stats_by_protocol)))


async def run_server(host: str, port: int, key_path: str,
                     stats_interval: float = 15.0) -> None:
    key = KeyManager(key_path or None).get_or_create_private_key("dht")
    h, dht = await new_host_and_dht(key, listen_host=host, listen_port=port)
    relay = RelayService(h)
    iv = Intervals.default()
    # Liveness probes evict crashed providers promptly.
    dht.start_maintenance(provider_check=iv.dht_provider_check,
                          bucket_refresh=iv.dht_bucket_refresh)
    log.info("dht server %s listening on %s:%d (%s; native %s)",
             h.peer_id[:12], host, h.listen_port, version_string(),
             "on" if native.native_enabled() else "off")

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)

    async def stats_loop() -> None:
        while True:
            await asyncio.sleep(stats_interval)
            log.info("%s", stats_line(h, dht, relay))
            if h.stats_by_addr_class:
                log.info("inbound peers by address class: %s",
                         dict(h.stats_by_addr_class))

    stats = asyncio.create_task(stats_loop())
    try:
        await stop.wait()
    finally:
        stats.cancel()
        log.info("%s", stats_line(h, dht, relay))
        log.info("inbound peers by address class: %s",
                 dict(h.stats_by_addr_class))
        relay.close()
        await dht.stop_maintenance()
        await h.close()


if __name__ == "__main__":
    sys.exit(main())
