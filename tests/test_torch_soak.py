"""The seeded chaos soak (``crowdllama_tpu_torch/testing/soak.py``) on a
small torch swarm on the CPU: port nodes only (a bootstrap DHT node, five
echo workers, a consumer and the port's gateway), 64 streams one at a
time, each soak well under 30 s.  Every invariant holds (byte-identical
to control, one clean terminal frame, bounded stall recovery, counter
conservation, a ``reason=wedged`` trace), and the same seed fires the
same faults twice.  The plan is the JAX soak's at 200 streams and
above, and the network-emulation proxy (``testing/netem.py``) delays a
loopback echo by one round trip.
"""

import asyncio
import time
from collections import Counter

import pytest

from crowdllama_tpu.testing import soak as jsoak
from crowdllama_tpu_torch.testing import netem as tnetem
from crowdllama_tpu_torch.testing import soak

STREAMS, WORKERS, CONCURRENCY = 64, 5, 1


@pytest.fixture(scope="module")
def reports():
    out = []
    for _ in range(2):
        t0 = time.monotonic()
        out.append(asyncio.run(asyncio.wait_for(
            soak.run_soak(11, STREAMS, WORKERS, CONCURRENCY, None), 60)))
        out[-1]["wall_s"] = time.monotonic() - t0
    return out


@pytest.mark.parametrize("run", [0, 1])
def test_every_invariant_holds(reports, run):
    r = reports[run]
    assert r["pass"], [c for c in r["invariants"] if not c["ok"]]
    names = {c["name"] for c in r["invariants"]}
    assert {"byte_identical_zero_lost_or_dup_tokens",
            "exactly_one_clean_terminal_per_stream",
            "stalled_recovery_bounded", "hedge_conservation",
            "metrics_exposition_conserved",
            "flight_recorder_captured_wedged"} <= names
    assert r["wall_s"] < 30


def test_the_seed_fires_the_same_faults(reports):
    logs = [Counter((site, action) for site, action, _ in r["fault_log"])
            for r in reports]
    assert logs[0] == logs[1]
    assert logs[0][("engine.stream_chunk", "kill_stream")] == 5
    assert logs[0][("engine.stream_chunk", "stall_stream")] == 2
    assert logs[0][("host.new_stream", "error")] == 3


def test_plan_at_full_scale_keeps_the_jax_rules():
    def rules(plan):
        return sorted((r.site, r.action, tuple(sorted(r.match.items())),
                       r.after, r.times, r.delay_s, r.jitter_s)
                      for r in plan.rules)

    assert rules(soak.build_plan(42)) == rules(jsoak.build_plan(42))
    assert rules(soak.build_plan(42, 400, 32)) == rules(jsoak.build_plan(42))


def test_delay_proxy_delays_each_way_once():
    """A 50 ms one-way delay: a 4 kB echo through the proxy takes one
    round trip of ~100 ms (delivery is timestamp-scheduled, so a message
    of several reads pays the delay once), and close() returns with the
    proxied connection still open."""
    async def echo(reader, writer):
        while data := await reader.read(1024):
            writer.write(data)
            await writer.drain()
        writer.close()

    async def go() -> float:
        server = await asyncio.start_server(echo, "127.0.0.1", 0)
        proxy = tnetem.DelayProxy(server.sockets[0].getsockname()[1], 0.05)
        port = await proxy.start()
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            t0 = time.monotonic()
            w.write(b"ping" * 1000)
            await w.drain()
            assert await r.readexactly(4000) == b"ping" * 1000
            return time.monotonic() - t0
        finally:
            await proxy.close()
            w.close()
            server.close()
            await server.wait_closed()

    dt = asyncio.run(asyncio.wait_for(go(), 10))
    assert 0.1 <= dt < 1.0, dt
