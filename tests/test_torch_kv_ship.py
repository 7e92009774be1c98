"""KV page shipping between the port and the JAX package.

Runners (``engine/paged.py`` ``export_pages`` / ``import_pages``) on
``tiny-test`` random weights carried across as numpy, the same dtype in
both packages:

- With equal pool contents (the JAX runner's pool copied into the port's,
  both having served the same prompt into the same pages), the port's
  exported payload is the JAX runner's byte for byte, on bf16 and int8
  pools (int8 with its bf16 scales); before the copy the port's pages are
  within tolerance of JAX's.
- Pages exported by either package import into the other, and the
  receiver's greedy stream over the imported pages (a suffix-only
  prefill) equals a cold serve of the same prompt, on fp32 and int8
  pools, including a partial match after donor-side eviction.
- A tp=2 port runner's export (rank shares concatenated along the head
  axis) imports into a tp=1 port runner and into the JAX runner, and a
  tp=1 export into a tp=2 runner (the shares split); streams equal cold.
- Import refuses a dtype or size mismatch where JAX refuses it; export
  refuses another page size, unknown hashes and a cache that is off.

Swarms (real p2p streams on loopback, a JAX bootstrap node): a JAX donor
serving a port worker and a port donor serving a JAX worker, each fetch
token-identical to the donor's cold serve with the ``kv_fetch`` and
``kv_export`` spans, then the ``kv.fetch`` and ``kv.serve`` chaos
fallbacks (plain prefill, same text, one fallback each).  The drain
hand-off with a JAX or a port donor: a port successor replays 0 prefill
tokens.  And the reference-side limit: a page pair above the wire's
10 MiB frame limit (llama-3-8b's geometry) makes either package's fetch
fall back alike.
"""

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.paged import (  # noqa: E402
    PagedModelRunner as JaxPagedModelRunner,
)
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.engine.paged import PagedModelRunner  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402

PG = 16
MAX_SEQ = 256
STEPS = 6


def _flat(seed=3):
    cfg = j_get_config("tiny-test", max_context_length=MAX_SEQ)
    return _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))


def _jparams(flat, dtype=jnp.float32):
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, dtype)
    return out


FLAT = _flat()


def _runner(pkg: str, dtype: str = "f32", tp: int = 1, **kw):
    """A paged runner of ``pkg`` ("jax" or "torch") on FLAT; ``dtype``
    "f32" or "bf16" (the runner's and so the pool's)."""
    kw = dict(max_slots=4, max_seq=MAX_SEQ, page_size=PG, **kw)
    if pkg == "jax":
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        return JaxPagedModelRunner(
            j_get_config("tiny-test", max_context_length=MAX_SEQ),
            params=_jparams(FLAT, jdt), dtype=jdt, mesh_spec="1", **kw)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cfg = get_config("tiny-test", max_context_length=MAX_SEQ)
    params = params_from_numpy(FLAT, dtype=tdt)
    if tp == 1:
        return PagedModelRunner(cfg, params=params, device="cpu", **kw)
    return PagedModelRunner(cfg, params=params, mesh_shape=str(tp),
                            devices=["cpu"] * tp, **kw)


def _key(r):
    return jax.random.PRNGKey(1) if isinstance(r, JaxPagedModelRunner) \
        else None


def _serve(r, state, prompt, steps=STEPS):
    """Greedy serve of ``prompt`` in slot 0 (a prefix hit when the index
    covers it); returns (tokens, state) with the slot released."""
    first, ks, vs, plen = r.prefill(prompt, 0.0, 1.0, _key(r), state=state)
    state = r.insert(state, 0, ks, vs, plen, first, 0.0, 1.0,
                     prompt_tokens=prompt)
    out, state = r.decode_steps(state, steps)
    toks = [int(first)] + [int(t) for t in np.asarray(out)[:, 0]]
    return toks, r.release(state, 0)


def _prompt(seed: int, n: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(1, 500, n)]


PAGE_FIELDS = ("k_pages", "v_pages", "k_scales", "v_scales")


def _ship(donor, dstate, recv, rstate, prompt):
    """Export ``prompt``'s pages from ``donor`` and import them into
    ``recv``, whose own export of them must give the same bytes back (the
    pages landed in order, every head in its share)."""
    keys = donor.chain_keys_for_prompt(prompt)
    payload = donor.export_pages(dstate, keys)
    assert payload is not None
    payload["keys"] = keys[:payload["matched"]]
    rstate, n = recv.import_pages(rstate, payload)
    back = recv.export_pages(rstate, payload["keys"])
    assert back["matched"] == payload["matched"]
    for name in PAGE_FIELDS:
        assert back[name] == payload[name], name
    return rstate, n, payload


def _pool_np(x) -> np.ndarray:
    """A pool (a JAX array or a port rank list of one) as numpy; bf16 as
    its int16 bit patterns."""
    if isinstance(x, list):
        (x,) = x
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if x.dtype == jnp.bfloat16 else a


# ------------------------------------------------------------ export bytes

@pytest.mark.parametrize("dtype,kv", [("bf16", "bf16"), ("f32", "int8")],
                         ids=["bf16", "int8"])
def test_export_bytes_equal_the_jax_runners(dtype, kv):
    prompt = _prompt(0, 3 * PG + 5)
    jr = _runner("jax", dtype, kv_dtype=kv)
    tr = _runner("torch", dtype, kv_dtype=kv)
    jst, tst = jr.init_state(), tr.init_state()
    _, jst = _serve(jr, jst, prompt, steps=1)
    _, tst = _serve(tr, tst, prompt, steps=1)
    keys = jr.chain_keys_for_prompt(prompt)
    assert keys == tr.chain_keys_for_prompt(prompt) and len(keys) == 3
    assert ({k: jr._prefix_index[k] for k in keys}
            == {k: tr._prefix_index[k] for k in keys})
    want = jr.export_pages(jst, keys)
    got = tr.export_pages(tst, keys)
    assert (got["matched"], got["kv_dtype"]) == (want["matched"],
                                                 want["kv_dtype"]) == (
        3, {"bf16": "bfloat16", "int8": "int8"}[kv])
    # The port's own pages are the JAX runner's within the compute's noise.
    np_dt = np.int8 if kv == "int8" else np.int16
    for name in ("k_pages", "v_pages"):
        for g, w in zip(got[name], want[name]):
            assert len(g) == len(w)
            a = np.frombuffer(g, np_dt).astype(np.int32)
            b = np.frombuffer(w, np_dt).astype(np.int32)
            if kv == "int8":
                assert np.abs(a - b).max() <= 1
            else:  # bf16 bit patterns -> values
                fa = torch.from_numpy(a.astype(np.int16)).view(
                    torch.bfloat16).float().numpy()
                fb = torch.from_numpy(b.astype(np.int16)).view(
                    torch.bfloat16).float().numpy()
                np.testing.assert_allclose(fa, fb, atol=0.05, rtol=0.05)
    # With the JAX pool's contents in the port's pool, byte for byte.
    for name in ("pool_k", "pool_v", "k_scale", "v_scale"):
        src = getattr(jst, name)
        if src is None or getattr(tst, name) is None:
            continue
        (dst,) = getattr(tst, name)
        bits = torch.from_numpy(_pool_np(src).copy())
        with torch.inference_mode():  # the pools are inference tensors
            dst.copy_(bits.view(dst.dtype))
    got = tr.export_pages(tst, keys)
    assert got == want
    assert tr.kv_pages_exported == 6 and jr.kv_pages_exported == 3


# ---------------------------------------------------- across the packages

@pytest.mark.parametrize("donor_pkg,recv_pkg", [("jax", "torch"),
                                                ("torch", "jax")])
@pytest.mark.parametrize("kv", ["bf16", "int8"], ids=["f32_pool", "int8"])
def test_pages_cross_packages_and_decode_as_cold(donor_pkg, recv_pkg, kv):
    prompt = _prompt(1, 3 * PG + 9)
    donor = _runner(donor_pkg, kv_dtype=kv)
    dstate = donor.init_state()
    _, dstate = _serve(donor, dstate, prompt)
    cold = _runner(recv_pkg, kv_dtype=kv)
    want, _ = _serve(cold, cold.init_state(), prompt)

    recv = _runner(recv_pkg, kv_dtype=kv)
    rstate, n, payload = _ship(donor, dstate, recv, recv.init_state(), prompt)
    assert n == 3 and recv.kv_pages_imported == 3
    assert payload["kv_dtype"] == ("int8" if kv == "int8" else "float32")
    got, _ = _serve(recv, rstate, prompt)
    assert recv.prefix_hits == 1 and recv.prefix_tokens_reused == 3 * PG
    assert got == want


@pytest.mark.parametrize("donor_pkg", ["jax", "torch"])
def test_partial_match_after_donor_eviction(donor_pkg):
    """The donor lost the chain's last page: it serves the leading two, the
    port imports them and recomputes the rest, as cold."""
    prompt = _prompt(2, 3 * PG + 7)
    donor = _runner(donor_pkg)
    dstate = donor.init_state()
    _, dstate = _serve(donor, dstate, prompt)
    keys = donor.chain_keys_for_prompt(prompt)
    page = donor._prefix_index.pop(keys[-1])
    donor._page_key.pop(page, None)
    donor._index_lru.pop(keys[-1], None)
    donor._free_pages.append(page)
    want, _ = _serve(_runner("torch"), _runner("torch").init_state(), prompt)
    recv = _runner("torch")
    rstate, n, payload = _ship(donor, dstate, recv, recv.init_state(), prompt)
    assert payload["matched"] == 2 and n == 2
    got, _ = _serve(recv, rstate, prompt)
    assert recv.prefix_tokens_reused == 2 * PG
    assert got == want


@pytest.mark.parametrize("donor,recv", [((("torch", 2)), ("torch", 1)),
                                        (("torch", 2), ("jax", 1)),
                                        (("torch", 1), ("torch", 2)),
                                        (("jax", 1), ("torch", 2))],
                         ids=["tp2-tp1", "tp2-jax", "tp1-tp2", "jax-tp2"])
@pytest.mark.parametrize("kv", ["bf16", "int8"], ids=["f32_pool", "int8"])
def test_tp_shares_cross_tp_degrees(donor, recv, kv):
    prompt = _prompt(3, 2 * PG + 11)
    d = _runner(donor[0], tp=donor[1], kv_dtype=kv)
    dstate = d.init_state()
    _, dstate = _serve(d, dstate, prompt)
    want, _ = _serve(_runner(recv[0], tp=recv[1], kv_dtype=kv),
                     _runner(recv[0], tp=recv[1], kv_dtype=kv).init_state(),
                     prompt)
    r = _runner(recv[0], tp=recv[1], kv_dtype=kv)
    rstate, n, payload = _ship(d, dstate, r, r.init_state(), prompt)
    assert n == 2
    got, rstate = _serve(r, rstate, prompt)
    assert r.prefix_hits == 1 and got == want
    if donor == ("torch", 2):
        # The shares concatenate to the whole head axis: the tp=1 runner
        # exports the same pages within the compute's noise.
        one = _runner("torch", kv_dtype=kv)
        ost = one.init_state()
        _, ost = _serve(one, ost, prompt)
        ref = one.export_pages(ost, one.chain_keys_for_prompt(prompt))
        dt = np.int8 if kv == "int8" else np.float32
        for name in ("k_pages", "v_pages"):
            for g, w in zip(payload[name], ref[name]):
                np.testing.assert_allclose(
                    np.frombuffer(g, dt).astype(np.float32),
                    np.frombuffer(w, dt).astype(np.float32), atol=1.001e-3
                    if dt == np.float32 else 1.0)


def test_import_refuses_dtype_and_size_mismatch_as_jax():
    prompt = _prompt(4, PG + 3)
    donor = _runner("torch")
    dstate = donor.init_state()
    _, dstate = _serve(donor, dstate, prompt)
    keys = donor.chain_keys_for_prompt(prompt)
    payload = donor.export_pages(dstate, keys)
    payload["keys"] = keys[:payload["matched"]]
    for pkg in ("torch", "jax"):
        recv = _runner(pkg, kv_dtype="int8")
        with pytest.raises(ValueError, match="dtype mismatch"):
            recv.import_pages(recv.init_state(), dict(payload))
        recv2 = _runner(pkg)
        bad = dict(payload, k_pages=[b"\x00" * 8] * len(payload["k_pages"]))
        with pytest.raises(ValueError, match="bytes"):
            recv2.import_pages(recv2.init_state(), bad)
        assert recv2._free_pages == list(range(recv2.total_pages))


def test_export_gates_as_jax():
    prompt = _prompt(5, PG + 2)
    for pkg in ("torch", "jax"):
        donor = _runner(pkg)
        dstate = donor.init_state()
        _, dstate = _serve(donor, dstate, prompt)
        keys = donor.chain_keys_for_prompt(prompt)
        assert donor.export_pages(dstate, keys, page_size=PG * 2) is None
        assert donor.export_pages(dstate, [b"\x00" * 32]) is None
        off = _runner(pkg, prefix_cache=False)
        assert off.export_pages(off.init_state(), keys) is None
        # Pages the receiver already holds are skipped, not re-imported.
        payload = donor.export_pages(dstate, keys)
        payload["keys"] = keys[:payload["matched"]]
        assert donor.import_pages(dstate, payload)[1] == 0


# ---------------------------------------------------------------- swarms

DEADLINE = 240.0
PROMPT = ("Swarm KV shipping turns prefix-affinity misses into paged page "
          "fetches instead of recomputing the prefill from scratch. This "
          "long shared prefix spans several pages so the fetch pays.")
PROMPT2 = ("A donor whose serve path fails answers in band, and the fetcher "
           "falls back to a plain prefill of this second long prompt.")
KV = dict(kv_ship=True, kv_ship_min_tokens=16, kv_ship_timeout=2.0)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE))


async def _wait(cond, what: str, timeout: float = 30.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not await cond():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _worker(pkg: str, addr: str, ckpt: str, flat: dict, **extra):
    """(engine, peer) of ``pkg`` on the permutation checkpoint: the JAX
    worker loads it from ``ckpt``, the port's from its numpy ``flat``."""
    from test_torch_handle import COMMON

    from crowdllama_tpu.config import Configuration as JConf
    from crowdllama_tpu.config import Intervals as JIntervals
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.peer.peer import Peer as JPeer
    from crowdllama_tpu.utils.crypto_compat import Ed25519PrivateKey as JKey
    from crowdllama_tpu_torch.config import Configuration as TConf
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.peer.peer import Peer as TPeer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey as TKey

    node = dict(listen_host="127.0.0.1", bootstrap_peers=[addr])
    kw = dict(COMMON, **KV, **extra)
    if pkg == "jax":
        iv = JIntervals.default()
        eng = JaxEngine(JConf(model="tiny-test", model_path=ckpt,
                              warmup=False, intervals=iv, **kw))
        return eng, JPeer(JKey.generate(), JConf(
            intervals=iv, relay_mode="off", **node, **kw), engine=eng,
            worker_mode=True)
    eng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False, **kw)
    return eng, TPeer(TKey.generate(), TConf(
        device="cpu", model="tiny-test", relay_mode="off", **node, **kw), eng)


def _runner_of(eng):
    return getattr(eng, "runner", None) or eng._runner


async def _text(eng, prompt: str, donor: str = "", trace: str = "") -> str:
    """A non-streamed request through the engine's ``handle`` (the JAX
    package's codec builds it; both packages decode it)."""
    from crowdllama_tpu.core.messages import create_generate_request
    from crowdllama_tpu_torch.core import llama_v1

    msg = create_generate_request("tiny-test", prompt, max_tokens=8)
    msg.trace_id = trace
    if donor:
        msg.generate_request.kv_donor = donor
    if not hasattr(eng, "_runner"):  # the port decodes its own message
        msg = llama_v1.BaseMessage.FromString(msg.SerializeToString())
    reply = await eng.handle(msg, worker_id="t")
    resp = reply.generate_response
    assert resp.done_reason != "error", resp.response
    return resp.response


def _faults(pkg: str):
    from crowdllama_tpu.testing import faults as jfaults
    from crowdllama_tpu_torch.testing import faults as tfaults

    return jfaults if pkg == "jax" else tfaults


@pytest.mark.parametrize("donor_pkg,fetch_pkg", [("jax", "torch"),
                                                 ("torch", "jax")],
                         ids=["jax_donor", "torch_donor"])
def test_wire_fetch_in_a_mixed_swarm_and_its_chaos_fallbacks(
        donor_pkg, fetch_pkg, tmp_path):
    """Donor A (one package) serves PROMPT cold; worker C (the other)
    fetches with ``kv.fetch`` killed on every attempt and falls back to a
    plain prefill; worker B fetches A's pages over the wire: the same
    text, pages imported, the fetch's span and the donor's.  Then A
    serves PROMPT2 and C's fetch meets an injected ``kv.serve`` error on
    A: one more fallback, the same text as A's."""
    from test_torch_handle import _perm

    from crowdllama_tpu.net.discovery import new_host_and_dht
    from crowdllama_tpu.utils.crypto_compat import Ed25519PrivateKey as JKey

    async def go():
        ckpt, flat = _perm(tmp_path)
        boot, _ = await new_host_and_dht(JKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        parts = [_worker(p, addr, ckpt, flat)
                 for p in (donor_pkg, fetch_pkg, fetch_pkg)]
        (ea, pa), (eb, pb), (ec, pc) = parts
        started = []
        try:
            for e, p in parts:
                for part in (e, p):
                    await part.start()
                    started.append(part)
            for p in (pb, pc):
                await _wait(lambda p=p: p.dht.find_peer(pa.peer_id),
                            "the donor in the DHT")
            text_a = await _text(ea, PROMPT)
            ff, fs = _faults(fetch_pkg), _faults(donor_pkg)
            plan = ff.FaultPlan(seed=7, rules=[ff.FaultRule(
                site="kv.fetch", action="kill_stream", times=0)])
            with ff.installed(plan):
                text_c = await _text(ec, PROMPT, donor=pa.peer_id)
            assert plan.log and text_c == text_a
            mc = ec.obs.metrics
            assert (mc.kv_ship["fallbacks"], mc.kv_ship["retries"]) == (1, 1)
            assert _runner_of(ec).kv_pages_imported == 0

            text_b = await _text(eb, PROMPT, donor=pa.peer_id,
                                 trace="kvshiptrace0000")
            assert text_b == text_a
            mb = eb.obs.metrics
            keys = _runner_of(eb).chain_keys_for_prompt(
                eb.tokenizer.encode(PROMPT))
            assert _runner_of(eb).kv_pages_imported == len(keys) >= 8
            assert _runner_of(ea).kv_pages_exported == len(keys)
            assert (mb.kv_ship["fetches"], mb.kv_ship["fallbacks"]) == (1, 0)
            assert mb.kv_ship["bytes"] > 0
            assert mb.kv_fetch_seconds.count == 1
            assert pa.obs.metrics.kv_ship["bytes"] == mb.kv_ship["bytes"]
            tr_b = eb.obs.trace.get("kvshiptrace0000")
            assert any(s["name"] == "kv_fetch" for s in tr_b["spans"])
            tr_a = pa.obs.trace.get("kvshiptrace0000")
            assert any(s["name"] == "kv_export" and
                       s["meta"]["pages"] == len(keys)
                       for s in tr_a["spans"])
            assert eb.describe()["kv_ship"]["pages_imported"] == len(keys)
            # The fetcher holds the donor's pages byte for byte.
            pages_a = await ea.export_kv_pages("tiny-test", keys, 16)
            pages_b = await eb.export_kv_pages("tiny-test", keys, 16)
            assert pages_a["matched"] == pages_b["matched"] == len(keys)
            for name in PAGE_FIELDS:
                assert pages_a[name] == pages_b[name], name

            text_a2 = await _text(ea, PROMPT2)
            plan2 = fs.FaultPlan(seed=8, rules=[fs.FaultRule(
                site="kv.serve", action="error", times=0)])
            with fs.installed(plan2):
                text_c2 = await _text(ec, PROMPT2, donor=pa.peer_id)
            assert len(plan2.log) == 2  # the attempt and its retry
            assert text_c2 == text_a2
            assert mc.kv_ship["fallbacks"] == 2
            assert _runner_of(ec).kv_pages_imported == 0
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()

    _run(go())


LONG_CONTENT = (
    "Live migration moves an in-flight stream to a successor without "
    "redoing prefill: the drained worker stays up as a KV donor and "
    "the successor imports the paged prefix instead of recomputing it.")


@pytest.mark.parametrize("donor_pkg", ["jax", "torch"])
def test_drain_handoff_to_a_port_successor_replays_nothing(donor_pkg,
                                                           tmp_path):
    """A drain at the donor's first streamed chunk (the ``drain`` chaos
    action, the path SIGTERM takes) migrates the stream; the port's
    gateway re-routes it to a port successor with the donor as
    ``kv_donor``: the client's text equals the undisturbed stream's, the
    successor imported the prompt's pages and replayed 0 prefill
    tokens."""
    from test_torch_handle import _perm

    aiohttp = pytest.importorskip("aiohttp")
    from crowdllama_tpu.net.discovery import new_host_and_dht
    from crowdllama_tpu.utils.crypto_compat import Ed25519PrivateKey as JKey
    from crowdllama_tpu_torch.config import Configuration as TConf
    from crowdllama_tpu_torch.engine.engine import FakeEngine
    from crowdllama_tpu_torch.gateway.gateway import Gateway
    from crowdllama_tpu_torch.peer.peer import Peer as TPeer
    from crowdllama_tpu_torch.utils.crypto import Ed25519PrivateKey as TKey

    async def go():
        ckpt, flat = _perm(tmp_path)
        boot, _ = await new_host_and_dht(JKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        ed, pd = _worker(donor_pkg, addr, ckpt, flat)
        es, ps = _worker("torch", addr, ckpt, flat)
        consumer = TPeer(TKey.generate(), TConf(
            listen_host="127.0.0.1", bootstrap_peers=[addr],
            relay_mode="off"), FakeEngine(models=[]), worker_mode=False)
        gw = Gateway(consumer, port=0, host="127.0.0.1", kv_ship=True)
        started = []
        try:
            for part in (ed, pd, es, ps, consumer, gw):
                await part.start()
                started.append(part)
            pm = consumer.peer_manager

            async def both():
                return {pd.peer_id, ps.peer_id} <= {
                    p.peer_id for p in pm.get_healthy_peers()}

            await _wait(both, "both workers")
            find = gw._find_worker

            def donor_first(model, exclude=frozenset(), **kw):
                if pd.peer_id not in exclude:
                    w = find(model, exclude=exclude | {ps.peer_id}, **kw)
                    if w is not None:
                        return w
                return find(model, exclude=exclude, **kw)

            gw._find_worker = donor_first
            body = {"model": "tiny-test", "stream": True,
                    "messages": [{"role": "user", "content": LONG_CONTENT}],
                    "options": {"num_predict": 32}}
            url = f"http://127.0.0.1:{gw.port}/api/chat"

            async def chat() -> list[dict]:
                async with aiohttp.ClientSession() as s:
                    async with s.post(url, json=body) as r:
                        assert r.status == 200
                        return [json.loads(x) for x in
                                (await r.text()).splitlines() if x.strip()]

            # The reference runs on the donor; its pages stay cached there.
            reference = "".join(x["message"]["content"]
                                for x in await chat())
            fd = _faults(donor_pkg)
            plan = fd.FaultPlan(seed=11, rules=[fd.FaultRule(
                site="engine.stream_chunk", action="drain", after=1,
                times=1)])
            with fd.installed(plan):
                lines = await chat()
            assert plan.log and plan.log[0][2] == "drain"
            assert lines[-1]["done"] is True
            assert lines[-1]["worker_id"] == ps.peer_id
            assert "".join(x["message"]["content"] for x in lines) \
                == reference
            n = es.runner.kv_pages_imported
            assert n > 0 and _runner_of(ed).kv_pages_exported == n
            keys = es.runner.chain_keys_for_prompt(es.tokenizer.encode(
                es._format_chat(body["messages"])))[:n]
            pages_d = await ed.export_kv_pages("tiny-test", keys, 16)
            pages_s = await es.export_kv_pages("tiny-test", keys, 16)
            for name in PAGE_FIELDS:
                assert pages_d[name] == pages_s[name], name
            ms = es.obs.metrics
            assert ms.replayed_prefill_tokens == 0
            assert (ms.kv_ship["fetches"], ms.kv_ship["fallbacks"]) == (1, 0)
            assert gw.obs.metrics.migrated_streams == 1
            assert pm.is_routable(pd.peer_id, "tiny-test") is None
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()

    _run(go())


# llama-3-8b's page pair: 2 x 32 layers x 8 kv heads x 128 x 128 x 2 B.
LLAMA3_PAGE_BYTES = 32 * 8 * 128 * 128 * 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_page_pair_over_the_frame_limit_falls_back_alike(pkg, tmp_path):
    """The donor's frame plan sends at least one page pair a frame; at
    llama-3-8b's geometry that pair (16.8 MB) is over the wire's 10 MiB
    message limit, so the donor cannot write the frame and the fetcher
    falls back to plain prefill, in either package (a reference-side
    limit the port keeps)."""
    from test_torch_handle import _perm

    from crowdllama_tpu.core import wire as jwire
    from crowdllama_tpu.engine.engine import FakeEngine as JFake
    from crowdllama_tpu.net.discovery import new_host_and_dht
    from crowdllama_tpu.utils.crypto_compat import Ed25519PrivateKey as JKey
    from crowdllama_tpu_torch.core import wire as twire
    from crowdllama_tpu_torch.engine.engine import FakeEngine as TFake

    assert 2 * LLAMA3_PAGE_BYTES > twire.MAX_MESSAGE_SIZE \
        == jwire.MAX_MESSAGE_SIZE

    class BigDonor(JFake if pkg == "jax" else TFake):
        async def export_kv_pages(self, model, chain_hashes, page_size):
            self.asked = len(chain_hashes)
            page = bytes(LLAMA3_PAGE_BYTES)
            return {"matched": 1, "kv_dtype": "bfloat16",
                    "k_pages": [page], "v_pages": [page],
                    "k_scales": [], "v_scales": []}

    async def go():
        ckpt, flat = _perm(tmp_path)
        boot, _ = await new_host_and_dht(JKey.generate(),
                                         listen_host="127.0.0.1")
        addr = f"127.0.0.1:{boot.listen_port}"
        donor_eng = BigDonor(models=["tiny-test"])
        _, dpeer = _worker(pkg, addr, ckpt, flat)
        dpeer.engine = donor_eng
        ef, pf = _worker(pkg, addr, ckpt, flat)
        started = []
        try:
            for part in (dpeer, ef, pf):
                await part.start()
                started.append(part)
            await _wait(lambda: pf.dht.find_peer(dpeer.peer_id),
                        "the donor in the DHT")
            plain = await _text(ef, PROMPT)
            r = _runner_of(ef)
            ids = ef.tokenizer.encode(PROMPT2)
            payload, ns = await ef._fetch_kv_payload(dpeer.peer_id,
                                                     "tiny-test", ids)
            assert payload is None and ns > 0
            assert donor_eng.asked == len(r.chain_keys_for_prompt(ids))
            m = ef.obs.metrics
            assert (m.kv_ship["fetches"], m.kv_ship["fallbacks"],
                    m.kv_ship["retries"]) == (1, 1, 1)
            assert r.kv_pages_imported == 0
            # The request itself completes by plain prefill.
            assert await _text(ef, PROMPT, donor=dpeer.peer_id) == plain
        finally:
            for part in reversed(started):
                await part.stop()
            await boot.close()

    _run(go())
