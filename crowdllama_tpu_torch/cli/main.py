"""Worker CLI: ``python -m crowdllama_tpu_torch.cli.main start --worker-mode``.

Counterpart of the worker path of ``crowdllama_tpu/cli/main.py``
``run_node``: the node's identity key (``KeyManager``), the engine (the
port's ``MultiEngine`` over the comma-separated ``--model`` list, or
``FakeEngine`` for ``--engine fake``), ``engine.start()``, the ``Peer``,
the optional IPC server (``CROWDLLAMA_TPU_SOCKET``) and a clean stop:
SIGTERM drains (in-flight streams migrate to the swarm, then the worker
stays up as a drained peer for ``--drain-timeout`` or until a second
signal); SIGINT finishes in-flight requests in place.

The engine serves on the card; without CUDA the worker refuses to start
unless ``--device cpu`` is given.  Consumer mode (the gateway) is not
ported and is refused with a message.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.utils.keys import KeyManager
from crowdllama_tpu_torch.version import version_string

log = logging.getLogger("crowdllama.torch.cli")

CONSUMER_REFUSED = ("error: consumer mode (the gateway) is not ported to "
                    "crowdllama_tpu_torch yet; start a worker with "
                    "--worker-mode, or run the gateway from crowdllama_tpu")
NO_CUDA = ("error: no CUDA device available; the worker serves on the card "
           "(pass --device cpu to serve on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crowdllama-tpu-torch",
                                description="PyTorch/CUDA swarm worker")
    sub = p.add_subparsers(dest="command")
    start = sub.add_parser("start", help="run a swarm node")
    start.add_argument("--worker-mode", action="store_true",
                       help="serve inference (the only mode ported)")
    Configuration.add_flags(start)
    sub.add_parser("version", help="print version")
    return p


def make_engine(cfg: Configuration):
    """``FakeEngine`` for ``--engine fake``, else the port's
    ``MultiEngine`` (one child per model name) on ``cfg.device``."""
    from crowdllama_tpu_torch.engine.engine import FakeEngine
    from crowdllama_tpu_torch.engine.multi import MultiEngine

    names = [m.strip() for m in cfg.model.split(",") if m.strip()]
    if cfg.engine_backend == "fake":
        return FakeEngine(models=names)
    # "cuda" names the card the runner resolves (and refuses without).
    return MultiEngine(cfg, device="cpu" if cfg.device == "cpu" else None)


async def run_worker(cfg: Configuration) -> None:
    """Engine + peer (+ IPC) until SIGINT/SIGTERM."""
    from crowdllama_tpu_torch.ipc.server import IPCServer
    from crowdllama_tpu_torch.peer.peer import Peer

    key = KeyManager(cfg.key_path or None).get_or_create_private_key("worker")
    engine = make_engine(cfg)
    log.info("starting worker node (%s)", version_string())
    await engine.start()
    peer = Peer(key, cfg, engine=engine)
    try:
        await peer.start()
    except BaseException:
        await peer.stop()
        await engine.stop()
        raise
    ipc = None
    if cfg.ipc_socket:
        ipc = IPCServer(cfg.ipc_socket, engine, peer=peer)
        await ipc.start()

    stop = asyncio.Event()
    got_sig: list[int] = []
    loop = asyncio.get_running_loop()

    def _on_signal(signum: int) -> None:
        got_sig.append(signum)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, _on_signal, sig)
    try:
        await stop.wait()
    finally:
        log.info("shutting down")
        if signal.SIGTERM in got_sig:
            # SIGTERM = live-migration drain: advertise draining, migrate
            # in-flight streams, stay up through the drain window.
            migrated = await peer.drain()
            if migrated:
                log.info("migrated %d in-flight streams; staying up for "
                         "%.0fs (signal again to exit now)", migrated,
                         cfg.drain_timeout)
                stop.clear()
                try:
                    await asyncio.wait_for(stop.wait(), cfg.drain_timeout)
                except asyncio.TimeoutError:
                    pass
        else:
            await peer.stop_advertising()
            if not await engine.drain(cfg.drain_timeout):
                log.warning("drain timed out after %.0fs; dropping "
                            "in-flight requests", cfg.drain_timeout)
        if ipc is not None:
            await ipc.stop()
        await peer.stop()
        await engine.stop()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(version_string())
        return 0
    if args.command != "start":
        build_parser().print_help()
        return 2
    if not args.worker_mode:
        print(CONSUMER_REFUSED, file=sys.stderr)
        return 2
    cfg = Configuration.from_flags(args)
    logging.basicConfig(
        stream=sys.stderr, level=logging.DEBUG if cfg.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if cfg.engine_backend != "fake" and cfg.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print(NO_CUDA, file=sys.stderr)
            return 2
    try:
        asyncio.run(run_worker(cfg))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
