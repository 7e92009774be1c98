"""Seeded chaos soak over a torch swarm.

Counterpart of ``crowdllama_tpu/testing/soak.py``: boots a real loopback
swarm of the port's nodes (a bootstrap DHT node, N echo workers, one
consumer gateway), runs every prompt once fault-free (the control run),
then runs the same prompts again under a seeded :class:`FaultPlan` that
mixes every failure the request plane claims to survive:

- ``kill_stream``: a worker crash mid-stream (EOF, no error frame)
- ``stall_stream``: a gray failure, the transport open and silent (only
  the gateway's per-stream progress watchdog can see it)
- ``slow_stream``: a worker decoding at a fraction of its speed
- ``delay`` at the first token: a late TTFT, the hedge trigger
- ``drain``: live migration mid-stream
- ``error`` at ``host.new_stream``: dial-plane partition flaps

and checks the end-to-end invariants on EVERY stream:

1. byte-identical to its control run (no token lost or duplicated),
2. exactly one terminal frame, ``done_reason == "stop"``,
3. stalled-stream recovery bounded by the stall budget + failover slack,
4. counter conservation: ``hedge_launched == hedge_won +
   hedge_cancelled``, and the internal counters equal /metrics,
5. the flight recorder captured a ``reason=wedged`` trace.

The plan's rules fire at fixed pass indices (scaled to the number of
streams) and its jitter RNG is seeded, so a red soak replays with the
same seed.  The HTTP client is the port's own (``net/http.py``).

Run::

    python -m crowdllama_tpu_torch.testing.soak --seed 42 --streams 200
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

from crowdllama_tpu_torch.config import Configuration, Intervals
from crowdllama_tpu_torch.core.protocol import INFERENCE_PROTOCOL
from crowdllama_tpu_torch.engine.engine import FakeEngine
from crowdllama_tpu_torch.gateway.gateway import Gateway
from crowdllama_tpu_torch.net import http
from crowdllama_tpu_torch.net.discovery import new_host_and_dht
from crowdllama_tpu_torch.peer.peer import Peer
from crowdllama_tpu_torch.testing import faults
from crowdllama_tpu_torch.testing.faults import FaultPlan, FaultRule
from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey

MODEL = "tiny-test"
# Progress-watchdog budget (both phases).  The JAX soak's 500 ms sat close
# to an ordinary first token on a loaded CPU (dial, handshake and the
# first chunk; 250 ms of it injected on the delayed streams), so organic
# TTFT stalls were counted beside the two injected ones; the injected
# stalls never write again, so the budget costs only its own wait.
STALL_MS = 2000.0
HEDGE_TTFT_MS = 150.0  # hedge launch threshold
# A stalled stream must recover within the stall budget plus this much
# failover work (teardown + replay dial + re-stream + run-queue jitter).
FAILOVER_SLACK_S = 10.0
# The plan's pass indices are written for this many streams.
PLAN_STREAMS = 200


class SoakFailure(AssertionError):
    """An invariant did not hold; the JSON artifact records which."""


def _check(report: dict, name: str, ok: bool, detail: str) -> None:
    report["invariants"].append(
        {"name": name, "ok": bool(ok), "detail": detail})
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}")


def build_plan(seed: int, streams: int = PLAN_STREAMS,
               concurrency: int = 16) -> FaultPlan:
    """The mixed fault schedule as pass indices through the instrumented
    sites.  An echo prompt of ~13 words crosses ``engine.stream_chunk``
    ~15 times a stream.  At 200 streams and above the rules are the JAX
    soak's.  Below, every index is scaled to ``streams``, and the
    stream-killing faults (kill, stall, drain), in the JAX order, stay at
    least ``concurrency + 5`` passes apart: a stream has two attempts, a
    replay re-crosses every chunk index, and plain scaling puts a kill
    and a stall on one stream (at 64 streams one at a time, stream 30 of
    seed 11 is killed at chunk 4 and its replay stalled at chunk 6, and
    it ends in an error)."""
    f = min(1.0, streams / PLAN_STREAMS)

    def at(index: int) -> int:
        return int(round(index * f))

    # (action, chunk index, JAX pass index) of the stream-killing faults:
    # worker crashes pinned to chunk 4 (always MID-stream: the token-replay
    # failover path), gray failures silent at chunk 6 (long after the
    # first frame, so only the decode watchdog sees them), and one live
    # migration at chunk 2.  Single-shot rules: a replay re-crosses the
    # chunk, so one rule of several times would cascade onto one stream.
    disruptive = sorted(
        [("kill_stream", 4, 20 + 40 * i) for i in range(5)]
        + [("stall_stream", 6, 100), ("stall_stream", 6, 140),
           ("drain", 2, 170)], key=lambda e: e[2])
    spaced, prev = [], None
    for action, index, after in disruptive:
        after = at(after)
        if f < 1.0 and prev is not None:
            after = max(after, prev + concurrency + 5)
        prev = after
        spaced.append(FaultRule(site="engine.stream_chunk", action=action,
                                match={"index": index}, after=after,
                                times=1))
    return FaultPlan(seed=seed, rules=[
        # Late first tokens: a delay over the hedge threshold but under
        # the stall budget, so the hedge plane absorbs them.
        FaultRule(site="engine.stream_chunk", action="delay",
                  match={"index": 0}, delay_s=0.25, after=0, times=4),
        # Dial-plane partition flaps, absorbed by the pre-stream retry.
        FaultRule(site="host.new_stream",
                  match={"protocol": INFERENCE_PROTOCOL},
                  action="error", after=at(10), times=3),
        # A degraded worker pacing every chunk it serves for a while.
        FaultRule(site="engine.stream_chunk", action="slow_stream",
                  delay_s=0.002, jitter_s=0.003, after=at(300),
                  times=max(1, at(40))),
        *spaced,
    ])


async def _wait_for(cond, timeout=30.0, interval=0.1, what="condition"):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return
        await asyncio.sleep(interval)
    raise SoakFailure(f"timed out waiting for {what}")


async def _swarm(n_workers: int):
    """Bootstrap + N echo workers + a consumer gateway, all port nodes on
    loopback sockets."""
    boot_host, _ = await new_host_and_dht(
        Ed25519PrivateKey.generate(), listen_host="127.0.0.1")
    bootstrap = f"127.0.0.1:{boot_host.listen_port}"

    def cfg():
        return Configuration(listen_host="127.0.0.1",
                             bootstrap_peers=[bootstrap],
                             intervals=Intervals.default())

    workers = [Peer(Ed25519PrivateKey.generate(), cfg(),
                    engine=FakeEngine(models=[MODEL]), worker_mode=True)
               for _ in range(n_workers)]
    for w in workers:
        await w.start()
    consumer = Peer(Ed25519PrivateKey.generate(), cfg(),
                    engine=FakeEngine(models=[]), worker_mode=False)
    await consumer.start()
    gateway = Gateway(consumer, port=0, host="127.0.0.1",
                      stream_stall_ms=STALL_MS, hedge_ttft_ms=HEDGE_TTFT_MS)
    await gateway.start()

    await _wait_for(
        lambda: len({p.peer_id for p in
                     consumer.peer_manager.get_healthy_peers()
                     if p.is_worker}) == n_workers,
        what=f"all {n_workers} workers discovered")

    async def teardown():
        faults.clear()
        await gateway.stop()
        await consumer.stop()
        for w in workers:
            try:
                await w.stop()
            except Exception:
                pass
        await boot_host.close()

    return workers, consumer, gateway, gateway.port, teardown


async def _one_stream(url: str, idx: int) -> dict:
    """Drive one streamed chat; its content and terminal shape.  Never
    raises: a transport-level surprise is itself a violation the phase
    check reports."""
    body = {"model": MODEL, "stream": True,
            "messages": [{"role": "user",
                          "content": f"soak stream {idx:03d} tell the "
                                     "swarm a story about its peers "
                                     "and pages"}]}
    t0 = time.monotonic()
    try:
        async with http.request("POST", url, json=body,
                                timeout=60.0) as resp:
            status = resp.status
            raw = await resp.text()
    except Exception as e:  # noqa: BLE001 — recorded, judged later
        return {"idx": idx, "status": -1, "content": "", "terminals": 0,
                "done_reason": f"transport: {e}",
                "elapsed_s": time.monotonic() - t0}
    lines = [json.loads(l) for l in raw.splitlines() if l.strip()]
    return {
        "idx": idx,
        "status": status,
        "content": "".join(l.get("message", {}).get("content", "")
                           for l in lines),
        "terminals": sum(1 for l in lines if l.get("done")),
        "done_reason": lines[-1].get("done_reason") if lines else "empty",
        "error": next((l["error"] for l in lines if "error" in l), None),
        "elapsed_s": time.monotonic() - t0,
    }


async def _phase(url: str, n_streams: int, concurrency: int) -> list[dict]:
    sem = asyncio.Semaphore(concurrency)

    async def bounded(i):
        async with sem:
            return await _one_stream(url, i)

    return list(await asyncio.gather(
        *(bounded(i) for i in range(n_streams))))


def _judge(report: dict, control: list[dict], chaos: list[dict],
           plan: FaultPlan, gateway) -> None:
    """Apply every soak invariant; append to report['invariants']."""
    fired: dict[str, int] = {}
    for _site, _attrs, action in plan.log:
        fired[action] = fired.get(action, 0) + 1
    report["faults_fired"] = fired
    _check(report, "schedule_exhausted",
           fired.get("kill_stream") == 5 and fired.get("stall_stream") == 2
           and fired.get("drain") == 1 and fired.get("error") == 3,
           f"fired={fired}")

    bad_control = [r for r in control
                   if r["status"] != 200 or r["terminals"] != 1
                   or r["done_reason"] != "stop"]
    _check(report, "control_clean", not bad_control,
           f"{len(control) - len(bad_control)}/{len(control)} clean"
           + (f"; first bad: {bad_control[0]}" if bad_control else ""))

    bad_terminal = [r for r in chaos
                    if r["status"] != 200 or r["terminals"] != 1
                    or r["done_reason"] != "stop" or r.get("error")]
    _check(report, "exactly_one_clean_terminal_per_stream", not bad_terminal,
           f"{len(chaos) - len(bad_terminal)}/{len(chaos)} clean"
           + (f"; first bad: {bad_terminal[0]}" if bad_terminal else ""))

    by_idx = {r["idx"]: r for r in control}
    mismatched = [r["idx"] for r in chaos
                  if r["content"] != by_idx[r["idx"]]["content"]]
    _check(report, "byte_identical_zero_lost_or_dup_tokens", not mismatched,
           f"{len(chaos) - len(mismatched)}/{len(chaos)} byte-identical"
           + (f"; mismatched idx {mismatched[:5]}" if mismatched else ""))

    # The watchdog fires at the stall budget and failover replays from
    # there: no stream may take longer than budget + slack.
    bound = STALL_MS / 1000.0 + FAILOVER_SLACK_S
    slowest = max(r["elapsed_s"] for r in chaos)
    report["chaos_slowest_s"] = round(slowest, 3)
    report["recovery_bound_s"] = bound
    _check(report, "stalled_recovery_bounded",
           slowest <= bound,
           f"slowest stream {slowest:.2f}s <= {bound:.2f}s "
           f"(stall {STALL_MS:.0f}ms + failover slack)")

    r = gateway._robust
    report["gateway_counters"] = {k: r[k] for k in (
        "failovers", "replayed_chunks", "stalled_streams",
        "wedge_quarantines", "hedge_launched", "hedge_won",
        "hedge_cancelled")}
    _check(report, "hedge_conservation",
           r["hedge_launched"] == r["hedge_won"] + r["hedge_cancelled"]
           and r["hedge_launched"] >= 1,
           f"launched {r['hedge_launched']} == won {r['hedge_won']} + "
           f"cancelled {r['hedge_cancelled']}")
    _check(report, "stall_watchdog_counters",
           r["stalled_streams"] == 2 and 1 <= r["wedge_quarantines"] <= 2
           and r["failovers"] >= 7,
           f"stalled {r['stalled_streams']}, quarantined "
           f"{r['wedge_quarantines']}, failovers {r['failovers']} "
           "(>= 5 kills + 2 stalls)")

    wedged_traces = [e for e in gateway.flight.snapshot()["traces"]
                     if "wedged" in e["reasons"]]
    _check(report, "flight_recorder_captured_wedged",
           len(wedged_traces) >= 1,
           f"{len(wedged_traces)} trace(s) with reason=wedged")


async def _conservation_check(report: dict, gateway, gw_port: int) -> None:
    """Internal counters must equal the /metrics exposition."""
    async with http.request(
            "GET", f"http://127.0.0.1:{gw_port}/metrics") as resp:
        text = await resp.text()
    exposed = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, val = line.partition(" ")
        exposed[name] = val
    r = gateway._robust
    pairs = [
        ("crowdllama_gateway_failovers_total", r["failovers"]),
        ("crowdllama_stall_aborted_streams_total", r["stalled_streams"]),
        ("crowdllama_wedge_quarantines_total", r["wedge_quarantines"]),
        ("crowdllama_hedge_launched_total", r["hedge_launched"]),
        ("crowdllama_hedge_won_total", r["hedge_won"]),
        ("crowdllama_hedge_cancelled_total", r["hedge_cancelled"]),
    ]
    diverged = [(n, exposed.get(n), v) for n, v in pairs
                if exposed.get(n) != str(v)]
    _check(report, "metrics_exposition_conserved", not diverged,
           "internal counters == /metrics" if not diverged
           else f"diverged: {diverged}")


async def run_soak(seed: int, n_streams: int, n_workers: int,
                   concurrency: int, out_dir: Path | None) -> dict:
    """One soak; the report (with ``fault_log``, the fired events as
    ``(site, action, chunk index)``).  Raises SoakFailure when an
    invariant does not hold; ``out_dir`` None writes no artifact."""
    t_start = time.monotonic()
    report: dict = {"seed": seed, "streams": n_streams,
                    "workers": n_workers, "concurrency": concurrency,
                    "stall_ms": STALL_MS, "hedge_ttft_ms": HEDGE_TTFT_MS,
                    "invariants": []}
    print(f"chaos soak: seed={seed} streams={n_streams} "
          f"workers={n_workers} concurrency={concurrency}")
    workers, consumer, gateway, gw_port, teardown = await _swarm(n_workers)
    try:
        url = f"http://127.0.0.1:{gw_port}/api/chat"

        print("phase 1/2: control (fault-free baseline)...")
        t0 = time.monotonic()
        control = await _phase(url, n_streams, concurrency)
        report["control_s"] = round(time.monotonic() - t0, 2)

        print("phase 2/2: chaos (seeded mixed-fault schedule)...")
        plan = build_plan(seed, n_streams, concurrency)
        t0 = time.monotonic()
        with faults.installed(plan):
            chaos = await _phase(url, n_streams, concurrency)
        report["chaos_s"] = round(time.monotonic() - t0, 2)
        report["fault_log"] = [(site, action, attrs.get("index"))
                               for site, attrs, action in plan.log]

        # The flight recorder stitches its captures asynchronously: a
        # bounded wait before judging (the invariant still fails hard if
        # nothing lands).
        try:
            await _wait_for(
                lambda: any("wedged" in e["reasons"]
                            for e in gateway.flight.snapshot()["traces"]),
                timeout=10.0, what="flight-recorder wedged capture")
        except SoakFailure:
            pass

        print("invariants:")
        _judge(report, control, chaos, plan, gateway)
        await _conservation_check(report, gateway, gw_port)
    finally:
        await teardown()

    report["elapsed_s"] = round(time.monotonic() - t_start, 2)
    report["pass"] = all(c["ok"] for c in report["invariants"])
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / f"SOAK_torch_seed{seed}.json"
        out.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
        print(f"artifact: {out}")
    print(f"{'PASS' if report['pass'] else 'FAIL'} in "
          f"{report['elapsed_s']}s")
    if not report["pass"]:
        failed = [c["name"] for c in report["invariants"] if not c["ok"]]
        raise SoakFailure(f"soak seed={seed} violated: {', '.join(failed)}")
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--streams", type=int, default=200)
    # 5: two wedge quarantines + one drained worker still leave TWO
    # healthy targets, so a kill replay always has somewhere to go.
    ap.add_argument("--workers", type=int, default=5)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--out-dir", type=Path, default=None,
                    help="write SOAK_torch_seed<seed>.json here")
    args = ap.parse_args(argv)
    if args.workers < 3:
        ap.error("--workers must be >= 3 (two stalls quarantine two)")
    try:
        asyncio.run(run_soak(args.seed, args.streams, args.workers,
                             args.concurrency, args.out_dir))
    except SoakFailure as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
