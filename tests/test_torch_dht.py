"""The port's DHT (``net/dht.py``) and discovery (``net/discovery.py``)
against the JAX package's.

- ``PyRoutingTable``: the same buckets (eviction order included, at a
  small k) and the same ``closest`` answers on random ids.
- A port DHT node bootstraps into a JAX bootstrap node and provides the
  namespace key; a JAX node finds it as a provider and reads its
  metadata through the pooled ``metadata`` op and the metadata stream,
  and ``discover_peers`` of each package finds the other's worker.  The
  reverse topology (a port bootstrap node, a JAX provider) also holds.
"""

import asyncio
import random

import pytest

from crowdllama_tpu.config import Intervals as JIntervals
from crowdllama_tpu.core.protocol import METADATA_PROTOCOL as J_META
from crowdllama_tpu.core.protocol import namespace_key as j_namespace_key
from crowdllama_tpu.core.resource import Resource as JResource
from crowdllama_tpu.net import dht as jdht
from crowdllama_tpu.net import discovery as jdisc
from crowdllama_tpu.net.host import Contact as JContact
from crowdllama_tpu.utils.crypto_compat import Ed25519PrivateKey as JKey
from crowdllama_tpu_torch.config import Intervals as TIntervals
from crowdllama_tpu_torch.core.protocol import METADATA_PROTOCOL as T_META
from crowdllama_tpu_torch.core.protocol import namespace_key
from crowdllama_tpu_torch.core.resource import Resource as TResource
from crowdllama_tpu_torch.net import dht as tdht
from crowdllama_tpu_torch.net import discovery as tdisc
from crowdllama_tpu_torch.net.host import Contact as TContact
from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey as TKey
from crowdllama_tpu_torch.utils.keys import peer_id_to_dht_id

DEADLINE = 60.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_table_equals_jax(seed):
    rng = random.Random(seed)
    self_pid = "%040x" % rng.getrandbits(160)
    jt = jdht.PyRoutingTable(peer_id_to_dht_id(self_pid), k=3)
    tt = tdht.PyRoutingTable(peer_id_to_dht_id(self_pid), k=3)
    pids = ["%040x" % rng.getrandbits(160) for _ in range(300)]
    for i in range(600):
        pid = rng.choice(pids)
        port = rng.randrange(1, 65535)
        jt.update(JContact(pid, "10.0.0.1", port))
        tt.update(TContact(pid, "10.0.0.1", port))
        if i % 7 == 0:
            gone = rng.choice(pids)
            jt.remove(gone)
            tt.remove(gone)
    assert len(tt) == len(jt) > 0
    for jb, tb in zip(jt.buckets, tt.buckets):
        assert [(n, c.to_dict()) for n, c in tb] == [
            (n, c.to_dict()) for n, c in jb]
    for _ in range(20):
        target = rng.getrandbits(256).to_bytes(32, "big")
        k = rng.choice([None, 1, 5, 50])
        assert ([c.to_dict() for c in tt.closest(target, k)]
                == [c.to_dict() for c in jt.closest(target, k)])


PKG = {
    "torch": (TKey, tdisc, TResource, T_META, TIntervals, namespace_key),
    "jax": (JKey, jdisc, JResource, J_META, JIntervals, j_namespace_key),
}


async def _provide_and_find(boot_pkg: str, provider_pkg: str,
                            finder_pkg: str) -> dict:
    """A bootstrap node of ``boot_pkg``; a provider node of
    ``provider_pkg`` serving Resource JSON (the ``metadata`` op and the
    metadata stream) that bootstraps and provides the namespace key; a
    finder node of ``finder_pkg`` that finds it."""
    nodes = []

    async def node(pkg):
        key, disc = PKG[pkg][0], PKG[pkg][1]
        host, dht = await disc.new_host_and_dht(key.generate(),
                                                listen_host="127.0.0.1")
        nodes.append(host)
        return host, dht

    try:
        boot_host, _ = await node(boot_pkg)
        addr = f"127.0.0.1:{boot_host.listen_port}"
        p_host, p_dht = await node(provider_pkg)
        _, _, p_res, p_meta, _, p_ns = PKG[provider_pkg]
        res = p_res(peer_id=p_host.peer_id, supported_models=["tiny-test"],
                    worker_mode=True, version="v")
        res.touch()

        async def meta_stream(stream):
            stream.writer.write(res.to_json())
            await stream.writer.drain()
            stream.writer.write_eof()

        p_dht.metadata_provider = res.to_json
        p_host.set_stream_handler(p_meta, meta_stream)
        assert await p_dht.bootstrap([addr]) == 1
        accepted = await p_dht.provide(p_ns())
        f_host, f_dht = await node(finder_pkg)
        _, f_disc, f_res, _, f_iv, f_ns = PKG[finder_pkg]
        assert await f_dht.bootstrap([addr]) == 1
        providers = await f_dht.find_providers(f_ns())
        contact = next(c for c in providers if c.peer_id == p_host.peer_id)
        raw = await f_dht.request_metadata(contact)
        streamed = await f_disc.request_peer_metadata(f_host, contact,
                                                      timeout=10)
        found = await f_disc.discover_peers(f_host, f_dht,
                                            intervals=f_iv.default())
        return {"accepted": accepted, "provider": p_host.peer_id,
                "op": f_res.from_json(raw.encode()),
                "stream": streamed, "discovered": found,
                "want": res.to_json()}
    finally:
        for h in reversed(nodes):
            await h.close()


@pytest.mark.parametrize("boot,provider,finder", [
    ("jax", "torch", "jax"), ("torch", "jax", "torch"),
    ("jax", "jax", "torch")])
def test_provide_find_and_metadata_across_packages(boot, provider, finder):
    out = asyncio.run(asyncio.wait_for(
        _provide_and_find(boot, provider, finder), DEADLINE))
    assert out["accepted"] >= 1
    for r in (out["op"], out["stream"]):
        assert r.to_json() == out["want"]
    assert [r.peer_id for r in out["discovered"]] == [out["provider"]]
    assert out["discovered"][0].supported_models == ["tiny-test"]
