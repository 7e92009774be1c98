"""The port's replicated gateway plane (``swarm/gossip.py``) against the
JAX package's.

Units, the same cases on both packages' modules (``tests/test_gossip.py``
runs them on JAX's): the LWW map's merge (commutative, idempotent, the
deterministic tie-break, tombstones and their pruning), the hybrid clock,
the GossipFrame round trip through the port's codec, the tenant quota
parser, token buckets, gossiped usage digests and the weighted fair
share.  The same entries applied in any order give equal digests in the
two packages, and a snapshot written by either package loads in the
other.

The port's ``Gateway`` with a ``GossipNode``: a snapshot bounce keeps the
affinity pins (a gossip affinity hit), quarantines flow both ways
through ``on_draining`` / ``on_entry``, and ``X-Tenant`` admission sheds
the hot tenant alone.

Mixed meshes over real loopback peers: JAX and port replicas converge to
one digest under seeded drop, delay and partition faults (the
``gossip.send`` / ``gossip.recv`` sites of both packages); tombstones and
tenant usage cross between the packages; a port replica between two JAX
replicas relays their ``tune/`` entries unchanged; a JAX gateway's
tenant admits shed the tenant on a port gateway.  And the acceptance
case: a JAX gateway and a port gateway over two port workers, one
gateway killed mid-burst, the survivor's streams equal the undisturbed
stream and the conversation begun on the dead replica continues on the
same worker through the gossiped pin.
"""

import asyncio
import json
import time
from types import SimpleNamespace

import pytest

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.engine.engine import FakeEngine as JFake  # noqa: E402
from crowdllama_tpu.gateway.gateway import Gateway as JGateway  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.swarm import gossip as jg  # noqa: E402
from crowdllama_tpu.testing import faults as jfaults  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.core import wire as twire  # noqa: E402
from crowdllama_tpu_torch.core.messages import (  # noqa: E402
    extract_gossip_frame,
    gossip_frame_msg,
)
from crowdllama_tpu_torch.engine.engine import FakeEngine as TFake  # noqa: E402
from crowdllama_tpu_torch.gateway.gateway import Gateway as TGateway  # noqa: E402
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.swarm import gossip as tg  # noqa: E402
from crowdllama_tpu_torch.testing import faults as tfaults  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

MODEL = "tiny-test"
DEADLINE = 240.0
PKGS = pytest.mark.parametrize("g", [jg, tg], ids=["jax", "torch"])


# ------------------------------------------------------------- LWW units

@PKGS
def test_lww_merge_commutative_and_idempotent(g):
    a, b = g.LWWMap("A"), g.LWWMap("B")
    entries = [a.set("aff/1", "w1"), a.set("aff/2", "w2"),
               b.set("aff/3", "w3"), b.set("aff/1", "w9")]
    for e in entries:
        a.apply(e), a.apply(e)
    for e in reversed(entries):
        b.apply(e)
    assert a.digest() == b.digest()
    assert a.get("aff/1").value == "w9"


@PKGS
def test_lww_tie_break_is_deterministic(g):
    a, b = g.LWWMap("A"), g.LWWMap("B")
    e1 = g.Entry(key="k", value="x", version=100, origin="A")
    e2 = g.Entry(key="k", value="y", version=100, origin="B")
    a.apply(e1), a.apply(e2)
    b.apply(e2), b.apply(e1)
    assert a.get("k").value == b.get("k").value == "y"
    assert a.digest() == b.digest()


@PKGS
def test_tombstone_propagates_and_prunes(g):
    a, b = g.LWWMap("A"), g.LWWMap("B")
    a.set("aff/gone", "w1")
    for e in a.snapshot():
        b.apply(e)
    dead = a.delete("aff/gone")
    b.apply(dead)
    assert b.get("aff/gone") is None and len(b) == 0
    assert not b.apply(g.Entry(key="aff/gone", value="w1",
                               version=dead.version - 1, origin="C"))
    assert b.prune(now_ms=dead.version + 3_600_001) == 1
    assert "aff/gone" not in b.entries


@PKGS
def test_hybrid_clock_monotonic_past_prev(g):
    now_ms = int(time.time() * 1000)
    assert g.hybrid_clock(0) >= now_ms
    future = now_ms + 10_000_000
    assert g.hybrid_clock(future) == future + 1


def test_the_same_entries_give_equal_digests_in_both_packages():
    """Entries written on either package's map, applied to the other's in
    reverse order and twice, give one digest."""
    ja, ta = jg.LWWMap("A"), tg.LWWMap("B")
    written = [ja.set("aff/1", "w1"), ta.set("aff/1", "w2"),
               ja.set("quar/w3", "drain"), ta.set("tune/m", '{"k":1}')]
    written.append(ja.delete("aff/1"))
    for m, mod in ((ja, jg), (ta, tg)):
        for e in reversed(written * 2):
            m.apply(mod.Entry.from_dict(e.to_dict()))
    assert ja.digest() == ta.digest()
    assert ja.get("aff/1") is None and ta.get("tune/m").value == '{"k":1}'


def test_gossip_frame_wire_roundtrip():
    msg = gossip_frame_msg(
        "gw1",
        entries=[{"key": "aff/x", "value": "w1", "version": 7,
                  "tombstone": False, "origin": "gw1"}],
        usage=[{"origin": "gw1", "tenant": "acme", "admitted": 3,
                "version": 9}],
        sync=True, clock=11)
    out = twire.decode_payload(twire.encode_frame(msg)[4:])
    fr = extract_gossip_frame(out)
    assert fr.origin == "gw1" and fr.sync and fr.clock == 11
    e = tg.Entry.from_dict(fr.entries[0])
    assert (e.key, e.value, e.version) == ("aff/x", "w1", 7)
    u = fr.usage[0]
    assert (u.tenant, u.admitted, u.version) == ("acme", 3, 9)


# ----------------------------------------------------------- tenant units

@PKGS
def test_parse_tenant_quotas(g):
    assert g.parse_tenant_quotas("default=20, acme=100") == {
        "default": 20.0, "acme": 100.0}
    assert g.parse_tenant_quotas("*=5") == {"default": 5.0}
    assert g.parse_tenant_quotas("") == {}
    for bad in ("acme=loads", "acme=-1"):
        with pytest.raises(ValueError):
            g.parse_tenant_quotas(bad)


@PKGS
def test_tenant_bucket_sheds_over_rate_and_refills(g):
    q = g.TenantQuotas({"default": 2.0}, node_id="g1")
    t0 = 100.0
    assert q.try_admit("t", now=t0) and q.try_admit("t", now=t0)
    assert not q.try_admit("t", now=t0)
    assert q.try_admit("t", now=t0 + 1.0)
    assert q.admitted_total == 3 and q.shed_total == 1
    assert not g.TenantQuotas({"acme": 1.0}).try_admit("stranger", now=t0)


@pytest.mark.parametrize("src,dst", [(jg, tg), (tg, jg), (tg, tg)],
                         ids=["jax-torch", "torch-jax", "torch-torch"])
def test_usage_digest_charges_buckets_across_packages(src, dst):
    g1 = src.TenantQuotas({"default": 2.0}, node_id="g1")
    for _ in range(2):
        assert g1.try_admit("acme", now=50.0)
    g1.local_admitted["acme"] += 3
    d = g1.usage_digest()
    assert d == [{"origin": "g1", "tenant": "acme", "admitted": 5,
                  "version": g1.usage_version}]
    g2 = dst.TenantQuotas({"default": 2.0}, node_id="g2")
    assert g2.apply_usage(d) == 5
    assert g2.apply_usage(d) == 0
    assert not g2.try_admit("acme")
    assert g2.cluster_admitted("acme") == 5
    assert g2.try_admit("other")
    assert g1.apply_usage(g1.usage_digest()) == 0


@PKGS
def test_fair_share_is_quota_weighted(g):
    q = g.TenantQuotas({"default": 10.0, "big": 30.0})
    assert q.fair_share("big", 8, {"default"}) == pytest.approx(6.0)
    assert q.fair_share("default", 8, {"big"}) == pytest.approx(2.0)
    assert q.fair_share("big", 8, set()) == pytest.approx(8.0)


# ------------------------------------------------------------- snapshots

@pytest.mark.parametrize("src,dst", [(jg, tg), (tg, jg)],
                         ids=["jax-torch", "torch-jax"])
def test_snapshot_written_by_one_package_loads_in_the_other(src, dst,
                                                            tmp_path):
    snap = str(tmp_path / "gossip.json")
    a = src.GossipNode(SimpleNamespace(peer_id="gw1"), snapshot_path=snap)
    a.record_affinity("conv-1", "w1")
    a.record_quarantine("w-dead")
    a.state.set("tune/m", '{"megastep_k":8}')
    a.record_affinity("conv-gone", "w2")
    a.drop_affinity("conv-gone")
    assert a.save_snapshot() == snap
    b = dst.GossipNode(SimpleNamespace(peer_id="gw1"), snapshot_path=snap)
    assert b.load_snapshot() == 4
    assert b.state.digest() == a.state.digest()
    assert b.state.clock >= a.state.clock
    assert b.lookup_affinity("conv-1")[0] == "w1"
    assert b.quarantined() == ["w-dead"]
    assert b.lookup_affinity("conv-gone") is None
    # The port writes the JAX package's file layout.
    assert sorted(json.loads(open(snap).read())) == [
        "clock", "entries", "node_id"]


def test_snapshot_bounce_preserves_affinity(tmp_path):
    snap = str(tmp_path / "gossip.json")
    g1 = tg.GossipNode(SimpleNamespace(peer_id="gw1"), snapshot_path=snap)
    gw1 = TGateway(SimpleNamespace(peer_manager=None), port=0, gossip=g1)
    gw1._affinity_put("conv-bounce", "w-keeper")
    gw1._affinity_put("conv-other", "w-two")
    g1.record_quarantine("w-dead")
    saved_clock = g1.state.clock
    assert g1.save_snapshot() == snap
    g2 = tg.GossipNode(SimpleNamespace(peer_id="gw1"), snapshot_path=snap)
    assert g2.load_snapshot() == 3
    assert g2.state.clock >= saved_clock
    pm = SimpleNamespace(is_routable=lambda pid, model: SimpleNamespace(
        peer_id=pid, resource=SimpleNamespace(load=0.0)))
    gw2 = TGateway(SimpleNamespace(peer_manager=pm), port=0, gossip=g2)
    assert not gw2._affinity
    cand = gw2._affinity_get("conv-bounce", MODEL)
    assert cand is not None and cand.peer_id == "w-keeper"
    assert gw2._gossip_affinity_hits == 1
    assert g2.quarantined() == ["w-dead"]
    assert gw2._affinity_get("conv-unknown", MODEL) is None
    # The donor hint reads the gossiped pin too.
    gw2.kv_ship = True
    assert gw2._kv_donor_for("conv-other", MODEL, "w-else") == "w-two"
    (tmp_path / "gossip.json").write_text("{not json")
    assert tg.GossipNode(SimpleNamespace(peer_id="gw1"),
                         snapshot_path=snap).load_snapshot() == 0


async def test_quarantine_flows_both_ways_through_the_gateway():
    marked = []
    pm = SimpleNamespace(on_peer_removed=None, on_draining=None,
                         mark_draining=lambda pid: marked.append(pid) or True)
    node = tg.GossipNode(SimpleNamespace(peer_id="gw1"), peers=())
    gw = TGateway(SimpleNamespace(peer_manager=pm, host=None), port=0,
                  host="127.0.0.1", gossip=node)
    await gw.start()
    try:
        pm.on_draining("w-drained")
        assert node.quarantined() == ["w-drained"]
        frame = gossip_frame_msg("gw2", entries=[
            {"key": "quar/w-remote", "value": "drain",
             "version": tg.hybrid_clock(), "origin": "gw2"}])
        assert await node.handle_frame(frame) is None
        assert marked == ["w-remote"]
        reply = await node.handle_frame(gossip_frame_msg("gw2", sync=True,
                                                         clock=1))
        keys = {e.key for e in reply.gossip_frame.entries}
        assert {"quar/w-drained", "quar/w-remote"} <= keys
    finally:
        await gw.stop()


# ------------------------------------------------ mixed meshes (loopback)

async def _consumer(pkg: str, bootstrap: list[str] = ()):
    if pkg == "jax":
        p = JPeer(JKey.generate(), JConf(
            listen_host="127.0.0.1", bootstrap_peers=list(bootstrap),
            relay_mode="off", intervals=JIntervals.default()),
            engine=JFake(models=[]), worker_mode=False)
    else:
        p = TPeer(TKey.generate(), TConf(
            listen_host="127.0.0.1", bootstrap_peers=list(bootstrap),
            relay_mode="off"), TFake(models=[]), worker_mode=False)
    await p.start()
    return p


async def _mesh(pkgs, links=None):
    """Consumer peers of ``pkgs`` on loopback, each with its package's
    GossipNode (receive side attached, no background loop: the tests run
    the rounds).  ``links``: i -> the peer indices i pushes to (default
    all others)."""
    peers = [await _consumer(p) for p in pkgs]
    addrs = [f"127.0.0.1:{p.host.listen_port}" for p in peers]
    nodes = []
    for i, (pkg, p) in enumerate(zip(pkgs, peers)):
        mod = jg if pkg == "jax" else tg
        to = (links or {}).get(i, [j for j in range(len(peers)) if j != i])
        node = mod.GossipNode(p, peers=[addrs[j] for j in to], interval=0.2)
        p.gossip_node = node
        nodes.append(node)

    async def teardown():
        jfaults.clear()
        tfaults.clear()
        for node in nodes:
            await node.stop(save=False)
        for p in peers:
            await p.stop()

    return peers, nodes, addrs, teardown


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE))


@pytest.mark.parametrize("pkgs", [("torch", "jax", "torch"),
                                  ("jax", "torch", "jax")],
                         ids=["t-j-t", "j-t-j"])
def test_mixed_replicas_converge_under_drop_delay_partition(pkgs):
    async def go():
        peers, nodes, addrs, teardown = await _mesh(pkgs)
        try:
            ids = [n.state.node_id for n in nodes]
            nodes[0].record_affinity("conv-1", "w1")
            nodes[1].record_affinity("conv-2", "w2")
            nodes[2].record_quarantine("w-dead")
            nodes[0].record_affinity("conv-race", "wA")
            nodes[1].record_affinity("conv-race", "wB")

            def rules(mod, i):
                """The JAX test's plan, each rule on the package of the
                node whose site fires."""
                out = []
                if i == 0:
                    out.append(mod.FaultRule(
                        site="gossip.send", action="error",
                        match={"src": ids[0], "dst": addrs[1]}, times=2))
                if i == 2:
                    out.append(mod.FaultRule(
                        site="gossip.recv", action="delay",
                        match={"dst": ids[2]}, delay_s=0.02, jitter_s=0.02,
                        times=4))
                    out.append(mod.FaultRule(
                        site="gossip.send", action="error",
                        match={"src": ids[2], "dst": addrs[1]}, times=2))
                if i == 1:
                    out.append(mod.FaultRule(
                        site="gossip.send", action="error",
                        match={"src": ids[1], "dst": addrs[2]}, times=2))
                return out

            plans = {}
            for mod, pkg in ((jfaults, "jax"), (tfaults, "torch")):
                plans[pkg] = mod.FaultPlan(seed=7, rules=[
                    r for i, p in enumerate(pkgs) if p == pkg
                    for r in rules(mod, i)])
            with jfaults.installed(plans["jax"]), \
                    tfaults.installed(plans["torch"]):
                for _ in range(2):
                    for node in nodes:
                        await node.run_round()
            fired = [a for p in plans.values() for _, _, a in p.log]
            assert "error" in fired and "delay" in fired
            assert all(p.log for p in plans.values())
            for node in nodes:
                await node.run_round()
            d0 = nodes[0].state.digest()
            assert d0 == nodes[1].state.digest() == nodes[2].state.digest()
            for node in nodes:
                assert node.lookup_affinity("conv-1")[0] == "w1"
                assert node.lookup_affinity("conv-2")[0] == "w2"
                assert node.quarantined() == ["w-dead"]
            assert len({n.lookup_affinity("conv-race")[0]
                        for n in nodes}) == 1
        finally:
            await teardown()

    _run(go())


@pytest.mark.parametrize("pkgs", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax-torch", "torch-jax"])
def test_tombstone_and_usage_cross_the_packages(pkgs):
    async def go():
        peers, nodes, addrs, teardown = await _mesh(pkgs)
        try:
            mods = [jg if p == "jax" else tg for p in pkgs]
            q0 = mods[0].TenantQuotas({"default": 2.0},
                                      node_id=nodes[0].state.node_id)
            q1 = mods[1].TenantQuotas({"default": 2.0},
                                      node_id=nodes[1].state.node_id)
            nodes[0].quotas, nodes[1].quotas = q0, q1
            nodes[0].record_affinity("conv-del", "w1")
            await nodes[0].run_round()
            assert nodes[1].lookup_affinity("conv-del")[0] == "w1"
            nodes[0].drop_affinity("conv-del")
            assert q0.try_admit("acme", now=10.0)
            assert q0.try_admit("acme", now=10.0)
            await nodes[0].run_round()
            assert nodes[1].lookup_affinity("conv-del") is None
            assert not q1.try_admit("acme")
            assert nodes[0].state.digest() == nodes[1].state.digest()
        finally:
            await teardown()

    _run(go())


def test_a_port_replica_relays_tune_entries_unchanged():
    """JAX A -> port B -> JAX C in a line (A and C never exchange): A's
    autopilot operating point reaches C through B with its version,
    origin and value intact, and C decodes it."""
    async def go():
        peers, nodes, addrs, teardown = await _mesh(
            ("jax", "torch", "jax"), links={0: [1], 1: [2], 2: []})
        try:
            point = {"megastep_k": 8, "draft_k": 2}
            nodes[0].record_operating_point(MODEL, point)
            want = nodes[0].state.entries[tg.TUNE_PREFIX + MODEL].to_dict()
            await nodes[0].run_round()
            await nodes[1].run_round()
            got = nodes[2].state.entries[tg.TUNE_PREFIX + MODEL].to_dict()
            assert got == want
            assert nodes[2].lookup_operating_point(MODEL) == point
            # And the port keeps it in its snapshot.
            entry = nodes[1].state.get(tg.TUNE_PREFIX + MODEL)
            assert entry.to_dict() == want
        finally:
            await teardown()

    _run(go())


# ------------------------------------------------------- HTTP admission

async def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _port(gw) -> int:
    return gw.port if isinstance(gw, TGateway) else \
        gw._runner.addresses[0][1]


async def _post(s, gw, body, tenant="", stream=False):
    headers = {"X-Tenant": tenant} if tenant else {}
    async with s.post(f"http://127.0.0.1:{_port(gw)}/api/chat",
                      json=dict(body, stream=stream),
                      headers=headers) as r:
        text = await r.text()
        return r.status, r.headers.get("Retry-After"), text


CHAT = {"model": MODEL, "messages": [{"role": "user", "content": "hi"}]}


def test_tenant_quota_sheds_the_hot_tenant_alone_and_shares_usage():
    """A port gateway with ``default=1000,hot=2`` admits two hot requests,
    sheds the third with 503 + Retry-After and admits a light tenant; a
    JAX gateway replica gossiping with it has been charged the hot
    tenant's admits and sheds it at once."""
    async def go():
        boot, _ = await new_host_and_dht(JKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        worker = TPeer(TKey.generate(), TConf(
            listen_host="127.0.0.1", bootstrap_peers=[addr],
            relay_mode="off"), TFake(models=[MODEL]))
        await worker.start()
        cons = [await _consumer("torch", [addr]),
                await _consumer("jax", [addr])]
        addrs = [f"127.0.0.1:{c.host.listen_port}" for c in cons]
        spec = "default=1000,hot=2"
        tq = tg.TenantQuotas(tg.parse_tenant_quotas(spec))
        jq = jg.TenantQuotas(jg.parse_tenant_quotas(spec))
        tnode = tg.GossipNode(cons[0], peers=[addrs[1]], interval=0.2,
                              quotas=tq)
        jnode = jg.GossipNode(cons[1], peers=[addrs[0]], interval=0.2,
                              quotas=jq)
        tgw = TGateway(cons[0], port=0, host="127.0.0.1", gossip=tnode,
                       tenant_quotas=tq)
        jgw = JGateway(cons[1], port=0, host="127.0.0.1", gossip=jnode,
                       tenant_quotas=jq)
        tnode.metrics = tgw.obs.metrics
        try:
            for part in (tnode, jnode, tgw, jgw):
                await part.start()
            for c in cons:
                await _wait(lambda c=c: c.peer_manager.find_best_worker(
                    MODEL) is not None, "the worker")
            async with aiohttp.ClientSession() as s:
                got = [await _post(s, tgw, CHAT, "hot") for _ in range(3)]
                assert [st for st, _, _ in got] == [200, 200, 503]
                assert got[2][1] is not None
                assert (await _post(s, tgw, CHAT, "light"))[0] == 200
                await _wait(lambda: jq.cluster_admitted("hot") == 2,
                            "the hot tenant's admits on the JAX replica",
                            timeout=10.0)
                assert (await _post(s, jgw, CHAT, "hot"))[0] == 503
                assert (await _post(s, jgw, CHAT, "light"))[0] == 200
                async with s.get(f"http://127.0.0.1:{tgw.port}/metrics") as r:
                    text = await r.text()
            m = tgw.obs.metrics
            assert m.tenant_shed.get("hot") == 1
            assert m.tenant_admitted.get("hot") == 2
            assert m.tenant_admitted.get("light") == 1
            assert 'crowdllama_tenant_shed_total{tenant="hot"} 1' in text
            assert "crowdllama_gossip_frames_sent_total" in text
            assert m.gossip["frames_sent"] >= 1
        finally:
            for part in (jgw, tgw):
                await part.stop()
            for node in (jnode, tnode):
                await node.stop(save=False)
            for p in (*cons, worker):
                await p.stop()
            await boot.close()

    _run(go())


# ---------------------------------------------------------- acceptance

def _ndjson(raw: str) -> list[dict]:
    return [json.loads(line) for line in raw.splitlines() if line.strip()]


def _content(lines) -> str:
    return "".join(x.get("message", {}).get("content", "") for x in lines)


@pytest.mark.parametrize("killed", ["jax", "torch"])
def test_two_gateways_one_swarm_kill_one_midburst(killed, tmp_path):
    """A JAX gateway and a port gateway gossiping over two port workers
    (the permutation checkpoint, paged, kv_ship on).  A conversation's
    first turn goes through the replica that is then killed mid-burst;
    the survivor's burst streams equal the undisturbed stream, and the
    conversation's continuation through the survivor lands on the same
    worker through the gossiped pin with no prefill replayed."""
    from test_torch_handle import COMMON, _perm

    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.weights import params_from_numpy

    async def go():
        _, flat = _perm(tmp_path)
        boot, _ = await new_host_and_dht(JKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        kv = dict(kv_ship=True, kv_ship_min_tokens=16, kv_ship_timeout=2.0)
        engines = [TorchEngine(device="cpu", params=params_from_numpy(
            flat, dtype=torch.bfloat16), model=MODEL, warmup=False,
            **COMMON, **kv) for _ in range(2)]
        workers = [TPeer(TKey.generate(), TConf(
            listen_host="127.0.0.1", bootstrap_peers=[addr], device="cpu",
            model=MODEL, relay_mode="off", **COMMON, **kv), e)
            for e in engines]
        pkgs = ("jax", "torch") if killed == "jax" else ("torch", "jax")
        cons = [await _consumer(p, [addr]) for p in pkgs]
        addrs = [f"127.0.0.1:{c.host.listen_port}" for c in cons]
        nodes, gws = [], []
        for i, (p, c) in enumerate(zip(pkgs, cons)):
            mod, cls = (jg, JGateway) if p == "jax" else (tg, TGateway)
            node = mod.GossipNode(c, peers=[addrs[1 - i]], interval=0.2)
            nodes.append(node)
            gws.append(cls(c, port=0, host="127.0.0.1", kv_ship=True,
                           gossip=node))
        dead = False

        async def kill_first():
            nonlocal dead
            dead = True
            await nodes[0].stop(save=False)
            await gws[0].stop()
            await cons[0].stop()

        started = []
        try:
            for part in (*engines, *workers, *nodes, *gws):
                await part.start()
                started.append(part)
            for c in cons:
                await _wait(lambda c=c: len({
                    p.peer_id for p in c.peer_manager.get_healthy_peers()
                    if p.is_worker}) == 2, "both workers on both consumers")
            convo = ("Replicated gateways gossip affinity pins so any "
                     "replica routes a returning user to its worker.")
            burst = ("Tell the story of the swarm that survived its own "
                     "entry point dying.")
            turn1 = [{"role": "user", "content": convo}]

            def body(messages, n=24):
                return {"model": MODEL, "messages": messages,
                        "options": {"num_predict": n}}

            async with aiohttp.ClientSession() as s:
                st, _, raw = await _post(s, gws[0], body(turn1, 12),
                                         stream=True)
                assert st == 200, raw
                lines = _ndjson(raw)
                reply1, first_worker = _content(lines), lines[-1]["worker_id"]
                akey, cont = TGateway._affinity_key(MODEL, turn1, "")
                assert not cont
                await _wait(lambda: nodes[1].lookup_affinity(akey)
                            is not None, "the pin on the survivor", 10.0)
                assert nodes[1].lookup_affinity(akey)[0] == first_worker
                st, _, raw = await _post(
                    s, gws[1], body([{"role": "user", "content": burst}]),
                    stream=True)
                base = _content(_ndjson(raw))
                bb = body([{"role": "user", "content": burst}])
                b_tasks = [asyncio.create_task(
                    _post(s, gws[1], bb, stream=True)) for _ in range(2)]
                a_task = asyncio.create_task(_post(s, gws[0], bb,
                                                   stream=True))
                await _wait(lambda: gws[1]._inflight >= 2
                            and gws[0]._inflight >= 1, "the burst", 20.0)
                a_task.cancel()
                await asyncio.gather(a_task, return_exceptions=True)
                await kill_first()
                for st, _, raw in await asyncio.gather(*b_tasks):
                    lines = _ndjson(raw)
                    assert st == 200 and lines[-1]["done"] is True
                    assert _content(lines) == base
                hits = gws[1]._gossip_affinity_hits
                st, _, raw = await _post(s, gws[1], body(
                    turn1 + [{"role": "assistant", "content": reply1},
                             {"role": "user", "content": "continue"}], 8),
                    stream=True)
                lines = _ndjson(raw)
                assert st == 200 and lines[-1]["done"] is True
            assert gws[1]._gossip_affinity_hits == hits + 1
            assert lines[-1]["worker_id"] == first_worker
            for e in engines:
                assert e.obs.metrics.replayed_prefill_tokens == 0
        finally:
            for part in reversed(started):
                if dead and part in (nodes[0], gws[0]):
                    continue
                await (part.stop(save=False) if part in nodes
                       else part.stop())
            for i, c in enumerate(cons):
                if not (dead and i == 0):
                    await c.stop()
            await boot.close()

    _run(go())


@pytest.mark.parametrize("flags,node,quotas", [
    ({}, False, False),
    ({"gateway_peers": ["127.0.0.1:1"]}, True, False),
    ({"gossip_snapshot_path": "/s.json"}, True, False),
    ({"tenant_quota": "default=5,hot=1"}, True, True)],
    ids=["none", "peers", "snapshot", "quota"])
def test_the_cli_builds_the_gossip_node_as_the_jax_cli(flags, node, quotas):
    """``start``'s consumer gets a node when it has replicas, a snapshot
    or quotas (the JAX CLI's rule), with the flags' values."""
    from crowdllama_tpu_torch.cli import main as tcli

    cfg = TConf(gossip_interval=0.7, **flags)
    g, q = tcli.make_gossip(cfg, SimpleNamespace(peer_id="p1"))
    assert (g is not None, q is not None) == (node, quotas)
    if g is not None:
        assert (g.peers, g.interval, g.snapshot_path, g.quotas) == (
            cfg.gateway_peers, 0.7, cfg.gossip_snapshot_path, q)
    if q is not None:
        assert q.quotas == {"default": 5.0, "hot": 1.0}
        assert q.node_id == "p1"
