"""Node CLI: ``python -m crowdllama_tpu_torch.cli.main start [--worker-mode]
| version | network-status | trace | top | run | pull | list | show | rm |
distill-draft``.

Counterpart of ``crowdllama_tpu/cli/main.py``.  ``start --worker-mode``
runs a worker: the node's identity key (``KeyManager``), the engine (the
port's ``MultiEngine`` over the comma-separated ``--model`` list, or
``FakeEngine`` for ``--engine fake``), the ``Peer``, with
``--worker-metrics-port`` its ``ObsServer``, and the optional IPC server
(``CROWDLLAMA_TPU_SOCKET``).  Plain ``start`` runs a consumer: a ``Peer``
in consumer mode over ``FakeEngine(models=[])`` and its ``Gateway`` on
``--gateway-port``, with the replicated gateway's ``GossipNode`` when
``--gateway-peers``, ``--gossip-snapshot`` or ``--tenant-quota`` is given
(the map is snapshotted on shutdown).  A worker started with
``--autotune`` and ``--gateway-peers`` joins that gossip plane for its
autopilot's ``tune/<model>`` points.  SIGTERM on a worker drains
(in-flight streams migrate to the swarm, then it stays up as a drained
peer for ``--drain-timeout`` or until a second signal); SIGINT, and any
signal on a consumer, finishes in-flight requests in place.

A worker's engine serves on the card; without CUDA it refuses to start
unless ``--device cpu`` is given.  ``start --worker-mode
--dist-coordinator HOST:PORT --dist-num-processes N --dist-process-id I``
runs one worker over N processes (``parallel/multihost.py``): process 0
runs the node and every other process replays its engine's frames
(``parallel/replicated.py run_follower``) and exits 0 on the leader's
STOP; a consumer, ``--shard-count`` above 1 or a model list exits 2.  A consumer runs no model, so it needs
no card.  ``network-status``, ``trace``, ``top``, ``run`` and ``list
--gateway`` talk to a gateway over the port's HTTP client
(``net/http.py``).

Model management, as the JAX CLI's: ``pull MODEL --bootstrap-peers ...``
fetches a checkpoint from a swarm worker that advertises it (every file
SHA-256-verified, ``net/model_share.py``) into ``--models-dir`` (default
``CROWDLLAMA_TPU_MODELS_DIR`` or ``~/.crowdllama-tpu/models``) and
prints its path; ``list``, ``show`` and ``rm`` manage that directory.
``distill-draft`` trains a draft model for ``--spec-decode draft``
(``train/distill.py``) on the card, or with ``--device cpu`` on the CPU,
and writes a native checkpoint ``--spec-draft-path`` serves.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import re
import signal
import sys

from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.config import Configuration
from crowdllama_tpu_torch.logutil import new_app_logger
from crowdllama_tpu_torch.utils.keys import KeyManager
from crowdllama_tpu_torch.version import version_string

log = logging.getLogger("crowdllama.torch.cli")

NO_CUDA = ("error: no CUDA device available; the worker serves on the card "
           "(pass --device cpu to serve on the CPU)")
GATEWAY = "http://127.0.0.1:9001"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crowdllama-tpu-torch",
                                description="PyTorch/CUDA swarm node")
    sub = p.add_subparsers(dest="command")
    start = sub.add_parser("start", help="run a swarm node")
    start.add_argument("--worker-mode", action="store_true",
                       help="serve inference (default: consumer/gateway "
                            "mode)")
    Configuration.add_flags(start)
    sub.add_parser("version", help="print version")
    status = sub.add_parser("network-status",
                            help="probe a gateway's health endpoint")
    status.add_argument("--gateway", default=GATEWAY)
    trace = sub.add_parser(
        "trace", help="fetch a cross-node stitched trace from a gateway "
                      "and print it as a waterfall")
    trace.add_argument("trace_id", help="trace id (from a response header, "
                                        "exemplar, or /debug/flightrecorder)")
    trace.add_argument("--gateway", default=GATEWAY)
    top = sub.add_parser(
        "top", help="live per-worker swarm table from a gateway's "
                    "/metrics/cluster scrape")
    top.add_argument("--gateway", default=GATEWAY)
    top.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                     help="refresh every N seconds (default: one shot)")
    run = sub.add_parser(
        "run", help="chat with a model through a gateway (ollama-run style)")
    run.add_argument("model", help="model name (see /api/tags)")
    run.add_argument("prompt", nargs="?", default="",
                     help="one-shot prompt; omit for an interactive REPL")
    run.add_argument("--gateway", default=GATEWAY)
    run.add_argument("--temperature", type=float, default=0.7)
    run.add_argument("--top-p", type=float, default=0.95)
    run.add_argument("--max-tokens", type=int, default=0)
    pull = sub.add_parser(
        "pull", help="fetch a model's checkpoint from a swarm peer "
                     "(hash-verified safetensors transfer)")
    pull.add_argument("model", help="model name advertised by some worker")
    pull.add_argument("--bootstrap-peers", required=True,
                      help="comma-separated host:port bootstrap addresses")
    pull.add_argument("--models-dir", default="",
                      help="destination root (default ~/.crowdllama-tpu/models)")
    pull.add_argument("--key-path", default="")
    lst = sub.add_parser("list", help="list local checkpoints (or the "
                                      "swarm's models with --gateway)")
    lst.add_argument("--models-dir", default="")
    lst.add_argument("--gateway", default="",
                     help="query this gateway's /api/tags instead")
    show = sub.add_parser("show", help="model config + local checkpoint "
                                       "details")
    show.add_argument("model")
    show.add_argument("--models-dir", default="")
    rm = sub.add_parser("rm", help="delete a local pulled checkpoint")
    rm.add_argument("model")
    rm.add_argument("--models-dir", default="")
    distill = sub.add_parser(
        "distill-draft",
        help="distill a small draft model from a main model's logits for "
             "--spec-decode draft (train/distill.py)")
    distill.add_argument("--teacher", default="tiny-test",
                         help="main-model registry name")
    distill.add_argument("--teacher-path", default="",
                         help="teacher checkpoint dir (empty = random init, "
                              "matching a checkpoint-less serving node on "
                              "the same device)")
    distill.add_argument("--out", required=True,
                         help="checkpoint dir to write (becomes "
                              "--spec-draft-path)")
    distill.add_argument("--draft-layers", type=int, default=2)
    distill.add_argument("--steps", type=int, default=1200)
    distill.add_argument("--batch", type=int, default=16)
    distill.add_argument("--seq-len", type=int, default=64)
    distill.add_argument("--corpus-seqs", type=int, default=256,
                         help="teacher-rollout sequences to synthesize")
    distill.add_argument("--corpus", default="",
                         help="optional text file: seeds rollout prefixes "
                              "(the prompt distribution) and joins the "
                              "corpus as raw chunks")
    distill.add_argument("--max-prefix", type=int, default=32,
                         help="longest rollout prefix length")
    distill.add_argument("--sample-temperature", type=float, default=0.0,
                         help="rollout sampling temperature (0 = greedy, "
                              "the verify-time trajectory distribution)")
    distill.add_argument("--no-tie-embeddings", action="store_true",
                         help="random-init embed/lm_head instead of "
                              "copying the teacher's")
    distill.add_argument("--lr", type=float, default=3e-3)
    distill.add_argument("--kl-weight", type=float, default=0.5)
    distill.add_argument("--kl-temperature", type=float, default=2.0)
    distill.add_argument("--seed", type=int, default=0)
    distill.add_argument("--verbose", action="store_true")
    distill.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                         help="train on the card (default) or the CPU")
    return p


def make_engine(cfg: Configuration):
    """``FakeEngine`` for ``--engine fake``, a ``ShardedEngine`` member for
    ``--shard-count`` above 1, else the port's ``MultiEngine`` (one child
    per model name), on ``cfg.device``."""
    from crowdllama_tpu_torch.engine.engine import FakeEngine
    from crowdllama_tpu_torch.engine.multi import MultiEngine

    names = [m.strip() for m in cfg.model.split(",") if m.strip()]
    if cfg.engine_backend == "fake":
        return FakeEngine(models=names)
    # "cuda" names the card the engine resolves (and refuses without).
    device = "cpu" if cfg.device == "cpu" else None
    if len(names) > 1 and cfg.shard_count > 1:
        raise ValueError("multi-model workers cannot combine with "
                         "--shard-count (shard one model per worker group)")
    if cfg.shard_count > 1:
        from crowdllama_tpu_torch.engine.sharded import ShardedEngine

        return ShardedEngine(cfg, device=device)
    return MultiEngine(cfg, device=device)


def make_gossip(cfg: Configuration, peer):
    """The consumer's (GossipNode or None, TenantQuotas or None): a node
    when it has replicas to gossip with, a snapshot to keep (a bounced
    single gateway rehydrates its affinity map) or quotas to share."""
    from crowdllama_tpu_torch.swarm.gossip import (
        GossipNode,
        TenantQuotas,
        parse_tenant_quotas,
    )

    quotas = None
    if cfg.tenant_quota:
        quotas = TenantQuotas(parse_tenant_quotas(cfg.tenant_quota),
                              node_id=peer.peer_id)
    gossip = None
    if cfg.gateway_peers or cfg.gossip_snapshot_path or quotas:
        gossip = GossipNode(peer, peers=cfg.gateway_peers,
                            interval=cfg.gossip_interval,
                            snapshot_path=cfg.gossip_snapshot_path,
                            quotas=quotas)
    return gossip, quotas


def make_gateway(cfg: Configuration, peer, gossip=None, tenant_quotas=None):
    from crowdllama_tpu_torch.gateway.gateway import Gateway

    return Gateway(peer, port=cfg.gateway_port,
                   trace_buffer=cfg.trace_buffer,
                   request_timeout=cfg.request_timeout,
                   admission_max_inflight=cfg.admission_max_inflight,
                   retry_after_s=cfg.retry_after_s, kv_ship=cfg.kv_ship,
                   gossip=gossip, tenant_quotas=tenant_quotas,
                   flight_recorder=cfg.flight_recorder,
                   trace_ttl=cfg.trace_ttl,
                   metrics_exemplars=cfg.metrics_exemplars,
                   slo_ttft_ms=cfg.slo_ttft_ms,
                   slo_decode_ms=cfg.slo_decode_ms,
                   stream_stall_ms=cfg.stream_stall_ms,
                   hedge_ttft_ms=cfg.hedge_ttft_ms,
                   profile_dir=cfg.profile_dir,
                   spec_pipeline=cfg.gateway_spec_pipeline,
                   spec_draft_path=cfg.spec_draft_path,
                   device="cpu" if cfg.device == "cpu" else None)


async def run_node(cfg: Configuration, worker_mode: bool = True) -> None:
    """Worker: engine + peer (+ ObsServer).  Consumer: peer + gateway.
    Either may add IPC.  Runs until SIGINT/SIGTERM."""
    from crowdllama_tpu_torch.engine.engine import FakeEngine
    from crowdllama_tpu_torch.ipc.server import IPCServer
    from crowdllama_tpu_torch.obs.http import ObsServer
    from crowdllama_tpu_torch.peer.peer import Peer

    component = "worker" if worker_mode else "consumer"
    key = KeyManager(cfg.key_path or None).get_or_create_private_key(
        component)
    # A consumer never runs inference locally.
    engine = make_engine(cfg) if worker_mode else FakeEngine(models=[])
    log.info("starting %s node (%s)", component, version_string())
    await engine.start()
    peer = Peer(key, cfg, engine=engine, worker_mode=worker_mode)
    gateway = gossip = obs_server = ipc = None
    try:
        await peer.start()
        if not worker_mode:
            gossip, quotas = make_gossip(cfg, peer)
            gateway = make_gateway(cfg, peer, gossip, quotas)
            if gossip is not None:
                gossip.metrics = gateway.obs.metrics
                await gossip.start()
            await gateway.start()
        else:
            if cfg.autotune and cfg.gateway_peers:
                # The autopilot's warm-start plane: the worker joins the
                # gateways' gossip (its peer dispatches gossip frames),
                # and the join sync pulls the swarm's operating points.
                from crowdllama_tpu_torch.swarm.gossip import GossipNode

                gossip = GossipNode(peer, peers=cfg.gateway_peers,
                                    interval=cfg.gossip_interval)
                await gossip.start()
                engine.set_gossip(gossip)
            if cfg.worker_metrics_port:
                obs_server = ObsServer(peer, host=cfg.listen_host,
                                       port=cfg.worker_metrics_port)
                await obs_server.start()
        if cfg.ipc_socket:
            ipc = IPCServer(cfg.ipc_socket, engine, peer=peer)
            await ipc.start()
    except BaseException:
        if gossip is not None:
            await gossip.stop(save=False)
        for part in (ipc, obs_server, gateway, peer, engine):
            if part is not None:
                await part.stop()
        raise

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
        if signal.SIGTERM in got_sig and worker_mode:
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
        for part in (ipc, obs_server):
            if part is not None:
                await part.stop()
        if gossip is not None:
            # The map (affinity pins, quarantines) lands in the snapshot
            # file, and the restarted gateway rehydrates it.
            await gossip.stop(save=True)
        if gateway is not None:
            await gateway.stop()
        await peer.stop()
        await engine.stop()


# ------------------------------------------------------ model commands


def _distill_draft(args) -> int:
    """Train and save a speculative draft checkpoint (train/distill.py);
    prints the flags that load it back into a serving node."""
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.verbose else logging.INFO)
    from crowdllama_tpu_torch.train.distill import (
        DistillConfig,
        distill_draft,
    )

    dc = DistillConfig(
        teacher=args.teacher, teacher_path=args.teacher_path,
        draft_layers=args.draft_layers, steps=args.steps, batch=args.batch,
        seq_len=args.seq_len, corpus_seqs=args.corpus_seqs,
        corpus_path=args.corpus, sample_temperature=args.sample_temperature,
        max_prefix=args.max_prefix,
        tie_embeddings=not args.no_tie_embeddings,
        lr=args.lr, kl_weight=args.kl_weight,
        kl_temperature=args.kl_temperature, seed=args.seed, out=args.out,
        device=args.device)
    if dc.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: no CUDA device available; distillation runs on "
                  "the card (pass --device cpu to train on the CPU)",
                  file=sys.stderr)
            return 2
    result = distill_draft(dc)
    print(f"checkpoint: {result['checkpoint']}")
    print(f"final loss: {result['losses'][-1]:.4f}  "
          f"greedy agreement: {result['agreement']:.3f}")
    print("serve with: python -m crowdllama_tpu_torch.cli.main start "
          "--worker-mode "
          f"--model {args.teacher} --spec-decode draft "
          f"--spec-draft-path {result['checkpoint']}")
    return 0


async def _pull(args) -> int:
    """Standalone swarm pull: discover a peer advertising the model, fetch
    its checkpoint with hash verification, print the local path."""
    from crowdllama_tpu_torch.net.discovery import (
        discover_peers,
        new_host_and_dht,
    )
    from crowdllama_tpu_torch.net.model_share import fetch_model

    logging.basicConfig(stream=sys.stderr, level=logging.INFO)
    cfg = Configuration.from_environment()
    models_dir = args.models_dir or cfg.models_dir
    key = KeyManager(args.key_path or None).get_or_create_private_key("pull")
    host, dht = await new_host_and_dht(key, listen_host="127.0.0.1")
    try:
        boots = [a.strip() for a in args.bootstrap_peers.split(",")
                 if a.strip()]
        await dht.bootstrap(boots)
        resources = await discover_peers(host, dht)
        sources = [r for r in resources
                   if r.worker_mode and args.model in r.supported_models]
        if not sources:
            print(f"no swarm peer advertises model {args.model!r} "
                  f"(discovered {len(resources)} peers)", file=sys.stderr)
            return 1
        last_err = None
        for r in sources:
            contact = await dht.find_peer(r.peer_id)
            if contact is None:
                last_err = RuntimeError(
                    f"cannot resolve peer {r.peer_id[:8]}")
                continue
            try:
                dest = await fetch_model(host, contact, args.model,
                                         models_dir)
                print(dest)
                return 0
            except Exception as e:
                last_err = e
                log.warning("pull from %s failed: %s", r.peer_id[:8], e)
        print(f"pull failed from every source: {last_err}", file=sys.stderr)
        return 1
    finally:
        await host.close()


def _models_root(args):
    from pathlib import Path

    cfg = Configuration.from_environment()
    return Path(args.models_dir or cfg.models_dir).expanduser()


def _dir_size(d) -> int:
    return sum(p.stat().st_size for p in d.rglob("*") if p.is_file())


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _list_local(args) -> int:
    """``list``: local checkpoints under the models dir."""
    root = _models_root(args)
    rows = []
    if root.is_dir():
        for d in sorted(root.iterdir()):
            if d.is_dir() and not d.name.endswith(".partial"):
                st = list(d.glob("*.safetensors"))
                if st:
                    rows.append((d.name, _fmt_bytes(_dir_size(d)), len(st)))
    if not rows:
        print(f"no local checkpoints under {root}")
        return 0
    w = max(len(r[0]) for r in rows)
    print(f"{'NAME'.ljust(w)}  SIZE        SHARDS")
    for name, size, shards in rows:
        print(f"{name.ljust(w)}  {size:<10}  {shards}")
    return 0


async def _list(args) -> int:
    """``list --gateway``: the swarm's served models via /api/tags."""
    try:
        _, raw = await _get(f"{args.gateway}/api/tags", 5)
        body = json.loads(raw)
    except Exception as e:
        print(f"gateway unreachable: {e}", file=sys.stderr)
        return 1
    models = body.get("models", [])
    if not models:
        print("no models served by the swarm")
        return 0
    for m in models:
        print(m.get("name", m.get("model", "?")))
    return 0


def _show(args) -> int:
    """``show MODEL``: registry config + local checkpoint details."""
    from crowdllama_tpu_torch.models.config import get_config, list_models
    from crowdllama_tpu_torch.net.model_share import dest_under_root

    try:
        cfg = get_config(args.model)
    except KeyError:
        cfg = None
    if cfg is not None:
        print(f"model:        {cfg.name} (family {cfg.family})")
        print(f"layers:       {cfg.num_layers}")
        print(f"hidden:       {cfg.hidden_size} "
              f"(heads {cfg.num_heads}/{cfg.num_kv_heads} kv)")
        print(f"context:      {cfg.max_context_length}")
        if cfg.is_moe:
            print(f"experts:      {cfg.num_experts} "
                  f"(top-{cfg.num_experts_per_tok})")
    else:
        print(f"model:        {args.model} (not in the builtin registry; "
              f"known: {', '.join(list_models())})")
    try:
        d = dest_under_root(_models_root(args), args.model)
    except ValueError as e:
        print(f"invalid model name: {e}", file=sys.stderr)
        return 1
    if d.is_dir() and list(d.glob("*.safetensors")):
        print(f"checkpoint:   {d} ({_fmt_bytes(_dir_size(d))})")
    else:
        print("checkpoint:   none local (use `crowdllama-tpu pull`)")
    return 0


def _rm(args) -> int:
    """``rm MODEL``: delete a local pulled checkpoint (name-validated and
    containment-checked like every other models-dir path)."""
    import shutil

    from crowdllama_tpu_torch.net.model_share import dest_under_root

    try:
        d = dest_under_root(_models_root(args), args.model)
    except ValueError as e:
        print(f"invalid model name: {e}", file=sys.stderr)
        return 1
    if not d.is_dir():
        print(f"no local checkpoint for {args.model!r} under {d.parent}",
              file=sys.stderr)
        return 1
    shutil.rmtree(d)
    print(f"removed {d}")
    return 0


# ----------------------------------------------------- gateway commands


async def _get(url: str, timeout: float):
    """(status, body bytes) of one GET."""
    from crowdllama_tpu_torch.net import http

    async with http.request("GET", url, timeout=timeout) as resp:
        return resp.status, await asyncio.wait_for(resp.read(), timeout)


async def _network_status(gateway: str) -> int:
    try:
        _, raw = await _get(f"{gateway}/api/health", 5)
        body = json.loads(raw)
    except Exception as e:
        print(f"gateway unreachable: {e}", file=sys.stderr)
        return 1
    print(f"gateway: {gateway}")
    print(f"peer id: {body.get('peer_id', '?')}")
    workers = body.get("workers", {})
    print(f"workers: {len(workers)}")
    for pid, w in workers.items():
        mark = "healthy" if w.get("is_healthy") else "unhealthy"
        print(f"  {pid[:12]} [{mark}] "
              f"models={','.join(w.get('supported_models', []))} "
              f"tput={w.get('tokens_throughput', 0)} "
              f"accel={w.get('accelerator', '?')}")
    return 0


async def _trace(args) -> int:
    """``trace <trace_id>``: the gateway's stitched trace as a waterfall."""
    from crowdllama_tpu_torch.obs.collector import render_waterfall

    try:
        status, raw = await _get(
            f"{args.gateway}/debug/trace/{args.trace_id}", 15)
        body = json.loads(raw)
    except Exception as e:
        print(f"gateway unreachable: {e}", file=sys.stderr)
        return 1
    if status != 200:
        print(f"error: {body.get('error', status)}", file=sys.stderr)
        return 1
    print(render_waterfall(body))
    return 0


def _parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Prometheus text -> [(family, labels, value)], enough for ``top``."""
    out: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? (\S+)",
                     line)
        if m is None:
            continue
        name, _, inner, value = m.groups()
        labels: dict = {}
        for part in (inner or "").split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        try:
            out.append((name, labels, float(value)))
        except ValueError:
            continue
    return out


_TOP_COLUMNS = {
    "crowdllama_worker_throughput_tokens_per_sec": "tok/s",
    "crowdllama_worker_load": "load",
    "crowdllama_worker_healthy": "ok",
    "crowdllama_engine_batch_occupancy": "occ",
    "crowdllama_engine_kv_cache_utilization": "kv",
    "crowdllama_engine_pending_depth": "pend",
    "crowdllama_engine_active_slots": "act",
    "crowdllama_autotune_moves_total": "moves",
}


def render_top(text: str) -> str:
    """A ``/metrics/cluster`` exposition as the per-worker table: the
    gateway's routing view (``peer``) joined with each worker's scraped
    engine gauges (``worker``, the same 16-character peer-id head)."""
    rows: dict[str, dict] = {}
    rollups: dict[str, float] = {}
    for name, labels, value in _parse_exposition(text):
        if name.startswith("crowdllama_cluster_"):
            rollups[name[len("crowdllama_cluster_"):]] = value
            continue
        wid = labels.get("peer") or labels.get("worker")
        if not wid:
            continue
        row = rows.setdefault(wid, {})
        if name in _TOP_COLUMNS:
            row[_TOP_COLUMNS[name]] = value
        elif name == "crowdllama_engine_duty_cycle":
            # The busiest dispatch class is the one that matters.
            row["duty"] = max(row.get("duty", 0.0), value)
        elif name == "crowdllama_autotune_dial":
            row.setdefault("dials", {})[labels.get("dial", "")] = value
    lines = [
        f"workers {rollups.get('workers_total', 0):g} "
        f"(scraped {rollups.get('workers_scraped', 0):g})   "
        f"tok/s {rollups.get('tokens_per_second', 0):g}   "
        f"occupancy {rollups.get('batch_occupancy', 0):.2f}   "
        f"kv {rollups.get('kv_cache_utilization', 0):.2f}   "
        f"inflight {rollups.get('inflight', 0):g}",
        f"{'WORKER':<18}{'OK':>3}{'LOAD':>7}{'TOK/S':>8}{'ACT':>5}"
        f"{'PEND':>6}{'OCC':>6}{'KV':>6}{'DUTY':>6}  {'DIALS':<20}",
    ]
    for wid in sorted(rows):
        r = rows[wid]
        dials = r.get("dials") or {}
        if dials:
            dial_col = (f"K{dials.get('megastep_k', 0):g}"
                        f"/k{dials.get('draft_k', 0):g}"
                        f"/B{dials.get('step_token_budget', 0):g}"
                        f"/C{dials.get('prefill_chunk', 0):g}"
                        f" m{r.get('moves', 0):g}")
        else:
            dial_col = "-"
        lines.append(
            f"{wid:<18}{'y' if r.get('ok', 0) else 'n':>3}"
            f"{r.get('load', 0.0):>7.2f}{r.get('tok/s', 0.0):>8.1f}"
            f"{r.get('act', 0.0):>5.0f}{r.get('pend', 0.0):>6.0f}"
            f"{r.get('occ', 0.0):>6.2f}{r.get('kv', 0.0):>6.2f}"
            f"{r.get('duty', 0.0):>6.2f}  {dial_col:<20}")
    if not rows:
        lines.append("(no workers visible)")
    return "\n".join(lines)


async def _top(args) -> int:
    """``top``: one GET /metrics/cluster per refresh (``--watch N``
    loops until ^C)."""
    while True:
        try:
            status, raw = await _get(f"{args.gateway}/metrics/cluster", 30)
        except Exception as e:
            print(f"gateway unreachable: {e}", file=sys.stderr)
            return 1
        if status != 200:
            print(f"error: HTTP {status}", file=sys.stderr)
            return 1
        if args.watch > 0:
            print("\x1b[2J\x1b[H", end="")  # clear between frames
        print(render_top(raw.decode("utf-8")))
        if args.watch <= 0:
            return 0
        try:
            await asyncio.sleep(args.watch)
        except (KeyboardInterrupt, asyncio.CancelledError):
            return 0


async def _run_chat(args) -> int:
    """``run <model> [prompt]``: an NDJSON client of the gateway's
    /api/chat, printing tokens as they arrive; one-shot with a prompt,
    a REPL without."""
    from crowdllama_tpu_torch.net import http

    history: list[dict] = []
    options = {"temperature": args.temperature, "top_p": args.top_p}
    if args.max_tokens:
        options["num_predict"] = args.max_tokens

    async def turn(content: str) -> bool:
        history.append({"role": "user", "content": content})
        try:
            async with http.request(
                    "POST", f"{args.gateway}/api/chat",
                    json={"model": args.model, "messages": history,
                          "stream": True, "options": options},
                    timeout=600) as resp:
                if resp.status != 200:
                    body = await resp.text()
                    print(f"error: {body.strip()}", file=sys.stderr)
                    history.pop()
                    return False
                parts = []
                async for line in resp.lines():
                    if not line.strip():
                        continue
                    frame = json.loads(line)
                    if frame.get("done_reason") == "error":
                        print(f"\nerror: "
                              f"{frame.get('error', 'worker failed')}",
                              file=sys.stderr)
                        history.pop()
                        return False
                    text = frame.get("message", {}).get("content", "")
                    if text:
                        parts.append(text)
                        print(text, end="", flush=True)
                    if frame.get("done"):
                        break
                print()
                history.append({"role": "assistant",
                                "content": "".join(parts)})
                return True
        except (OSError, asyncio.TimeoutError, http.ClientError,
                json.JSONDecodeError) as e:
            print(f"gateway error: {e or type(e).__name__}", file=sys.stderr)
            history.pop()
            return False

    if args.prompt:
        return 0 if await turn(args.prompt) else 1
    print(f"chatting with {args.model} via {args.gateway} "
          "(/bye or Ctrl-D to exit)", file=sys.stderr)
    # stdin on a daemon thread, one line per turn (the event keeps ">>> "
    # from interleaving with streamed tokens; the default executor would
    # hang Ctrl-C, joining a thread blocked in input()).
    import threading

    loop = asyncio.get_running_loop()
    lines: asyncio.Queue[str | None] = asyncio.Queue()
    ready = threading.Event()

    def reader() -> None:
        while True:
            ready.wait()
            ready.clear()
            try:
                line = input(">>> ")
            except (EOFError, KeyboardInterrupt):
                loop.call_soon_threadsafe(lines.put_nowait, None)
                return
            loop.call_soon_threadsafe(lines.put_nowait, line)

    threading.Thread(target=reader, daemon=True).start()
    while True:
        ready.set()
        line = await lines.get()
        if line is None:
            print(file=sys.stderr)
            return 0
        line = line.strip()
        if line in ("/bye", "/exit", "/quit"):
            return 0
        if line:
            await turn(line)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(version_string())
        return 0
    if args.command == "network-status":
        return asyncio.run(_network_status(args.gateway))
    if args.command == "trace":
        return asyncio.run(_trace(args))
    if args.command == "top":
        return asyncio.run(_top(args))
    if args.command == "run":
        try:
            return asyncio.run(_run_chat(args))
        except KeyboardInterrupt:
            print(file=sys.stderr)
            return 0
    if args.command == "pull":
        try:
            return asyncio.run(_pull(args))
        except KeyboardInterrupt:
            return 1
    if args.command == "list":
        return asyncio.run(_list(args)) if args.gateway else _list_local(args)
    if args.command == "show":
        return _show(args)
    if args.command == "rm":
        return _rm(args)
    if args.command == "distill-draft":
        return _distill_draft(args)
    if args.command != "start":
        build_parser().print_help()
        return 2
    cfg = Configuration.from_flags(args)
    new_app_logger("crowdllama", cfg.verbose)
    logging.getLogger().setLevel(
        logging.DEBUG if cfg.verbose else logging.INFO)
    logging.basicConfig(stream=sys.stderr)
    if cfg.dist_coordinator:
        # One worker over several processes (parallel/replicated.py):
        # process 0 runs the whole node, its engine broadcasting every
        # device-touching call, and every other process replays the frame
        # stream.  One engine's stream only: shapes that would start
        # other engines (a consumer, a sharded group, a model list) are
        # refused instead of waiting on the first collective.
        if (not args.worker_mode or cfg.shard_count > 1
                or "," in cfg.model):
            print("error: --dist-coordinator serves exactly one "
                  "worker-mode model per cluster (no consumer mode, "
                  "--shard-count, or model lists)", file=sys.stderr)
            return 2
        # A swarm pull hot-registering a second engine would emit frames
        # the follower loop cannot represent.
        cfg.allow_swarm_pull = False
    if (args.worker_mode and cfg.engine_backend != "fake"
            and cfg.device == "cuda"):
        import torch

        if not torch.cuda.is_available():
            print(NO_CUDA, file=sys.stderr)
            return 2
    if cfg.dist_coordinator:
        from crowdllama_tpu_torch.parallel.multihost import (
            initialize_from_config,
            is_leader,
        )

        initialize_from_config(cfg)
        if not is_leader():
            from crowdllama_tpu_torch.parallel.replicated import run_follower

            run_follower(cfg)
            return 0
    # Build the native data plane before the loop runs: under a running
    # loop a first build goes to a background thread and the first
    # streams take the Python path.
    native.ensure_built()
    try:
        asyncio.run(run_node(cfg, worker_mode=args.worker_mode))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
