"""The port's ``ShardedEngine`` (``engine/sharded.py``) against the JAX
package's, and the shard plane of the worker.

- Host-side pieces: ``_ngram_drafts`` on hypothesis histories, and
  ``sample_host`` picking the same tokens as JAX's on the same logits and
  numpy seed (greedy, temperature, top-p, top-k, repeat penalty).
- Engine streams: a two-member group of each package, the members' stages
  or banks wired straight into the leader's pipeline, serves the same
  prompts (an echo prompt that n-gram drafts hit, a plain one) greedily,
  pp on ``tiny-test`` and ep on ``tiny-test-moe``, with and without
  ``spec_decode="ngram"``: the token ids equal JAX's.  Weights: a native
  checkpoint written by the JAX package of the permutation weights of
  ``testing/modelgen.py`` with ``wo`` and ``w_down`` random at 0.005 (so
  attention, the stages and every expert reach the logits while greedy
  decode keeps O(1) margins), read by both packages in bf16.
- Mixed groups over real loopback hosts: a JAX leader with a port member
  and a port leader with a JAX member, each a ``Peer`` that discovered the
  other through a DHT bootstrap node, for pp and ep: the leader's streams
  equal the all-JAX group's, and every session is released.
- A port-only swarm behind the port's ``Gateway``: the leader is not
  routable while its group is incomplete, is once the member joins,
  answers ``/api/chat`` (whole and streamed), releases every session;
  ``drain`` on the member waits for the leader's live session; the
  member's death makes the model answer 503.
- Failures, as JAX's engine handles them: a member that rejects the
  verify op disables cross-worker speculation for later requests; a
  member that dies mid-stream drops the pooled pipeline and the session is
  released on the pipeline the request ran on.
- Configuration and CLI: the shard flags and environment variables parse
  as JAX's; ``make_engine`` builds a ``ShardedEngine`` and refuses a
  multi-model worker with ``--shard-count`` as JAX's CLI does; ep refuses
  ``quantize`` and dense models with JAX's words; a member started without
  CUDA and without ``device="cpu"`` raises.

Every networked test is bounded by ``asyncio.wait_for``.
"""

import asyncio
import dataclasses
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.cli import main as jcli  # noqa: E402
from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.engine import expert_service as JE  # noqa: E402
from crowdllama_tpu.engine import shard_service as JS  # noqa: E402
from crowdllama_tpu.engine import sharded as JSH  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.cli import main as tcli  # noqa: E402
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.engine import expert_service as TE  # noqa: E402
from crowdllama_tpu_torch.engine import shard_service as TS  # noqa: E402
from crowdllama_tpu_torch.engine import sharded as TSH  # noqa: E402
from crowdllama_tpu_torch.engine.engine import FakeEngine  # noqa: E402
from crowdllama_tpu_torch.gateway.gateway import Gateway  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.net.discovery import (  # noqa: E402
    new_host_and_dht as t_new_host_and_dht,
)
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

MAX_SEQ = 64
TOKENS = 12
# The permutation weights' greedy stream walks the next id: after "abcd"
# it spells "efgh...", which the echo prompt holds, so n-gram drafts hit.
PROMPTS = {"echo": "defghijklmnopqrs abcd", "plain": "the quick brown fox"}
MODELS = {"pp": "tiny-test", "ep": "tiny-test-moe"}
DEADLINE = 150.0


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Native checkpoints (written by the JAX package) of live permutation
    weights for each strategy's model."""
    from crowdllama_tpu.engine.weights import save_params
    from crowdllama_tpu.testing.modelgen import permutation_params

    out = {}
    for strategy, model in MODELS.items():
        jcfg = j_get_config(model, max_context_length=MAX_SEQ)
        params = permutation_params(jcfg)
        r = np.random.default_rng(11)
        for name in ("wo", "w_down"):
            shape = params["layers"][name].shape
            params["layers"][name] = jnp.asarray(
                0.005 * r.standard_normal(shape).astype(np.float32))
        path = tmp_path_factory.mktemp(strategy) / "ckpt"
        save_params(jcfg, params, path)
        out[strategy] = str(path)
    return out


def _group(strategy: str) -> str:
    return f"{MODELS[strategy]}/{strategy}2"


def jconf(strategy: str, ckpt: str, index: int, **kw) -> JConf:
    return JConf(model=MODELS[strategy], model_path=ckpt,
                 shard_group=_group(strategy), shard_index=index,
                 shard_count=2, shard_strategy=strategy,
                 max_context_length=MAX_SEQ, intervals=JIntervals.default(),
                 **kw)


def tconf(strategy: str, ckpt: str, index: int, **kw) -> TConf:
    return TConf(model=MODELS[strategy], model_path=ckpt, device="cpu",
                 shard_group=_group(strategy), shard_index=index,
                 shard_count=2, shard_strategy=strategy,
                 max_context_length=MAX_SEQ, **kw)


def engine(pkg: str, strategy: str, ckpt: str, index: int, **kw):
    if pkg == "jax":
        return JSH.ShardedEngine(jconf(strategy, ckpt, index, **kw))
    return TSH.ShardedEngine(tconf(strategy, ckpt, index, **kw),
                             device="cpu")


class _Ids:
    """Tokenizer proxy recording every token id the stream decoder is
    fed."""

    def __init__(self, tok, ids: list):
        self._tok, self._ids = tok, ids

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), self._ids

        class _Dec:
            def feed(self, t):
                ids.append(int(t))
                return dec.feed(t)

        return _Dec()


async def streams(leader, prompts=PROMPTS) -> dict:
    """Greedy streams of ``prompts``, one after another: name -> ids."""
    tok = leader.tokenizer
    out = {}
    try:
        for name, prompt in prompts.items():
            ids: list[int] = []
            leader.tokenizer = _Ids(tok, ids)
            final = None
            async for chunk in leader.generate(prompt, max_tokens=TOKENS):
                final = chunk
            assert final.done and final.completion_tokens == TOKENS
            out[name] = ids
    finally:
        leader.tokenizer = tok
    return out


def wire(pkg: str, strategy: str, leader, member) -> None:
    """The members' stages or banks straight into the leader's pipeline
    (the swarm dials them over SHARD_PROTOCOL)."""
    if strategy == "pp":
        if pkg == "jax":
            leader._pipeline = JS.SwarmPipeline(
                leader.cfg, leader._embed_params,
                [JS.LocalStage(leader.runner), JS.LocalStage(member.runner)])
        else:
            leader._pipeline = TS.SwarmPipeline(
                leader.cfg, leader._embed_params,
                [TS.LocalStage(leader.runner), TS.LocalStage(member.runner)],
                dtype=leader.dtype, device=leader.device)
    else:
        mod = JE if pkg == "jax" else TE
        leader._pipeline = mod.EPPipeline(
            leader.cfg, leader.runner,
            [mod.LocalExpertBank(leader.bank),
             mod.LocalExpertBank(member.bank)])


def sessions(strategy: str, leader, member) -> int:
    """Live KV sessions left in the group."""
    if strategy == "pp":
        return leader.runner.session_count + member.runner.session_count
    return leader.runner.session_count


async def _direct(pkg: str, strategy: str, ckpt: str, spec: str) -> tuple:
    leader = engine(pkg, strategy, ckpt, 0, spec_decode=spec, spec_draft=3)
    member = engine(pkg, strategy, ckpt, 1)
    await leader.start()
    await member.start()
    try:
        wire(pkg, strategy, leader, member)
        got = await streams(leader)
        assert sessions(strategy, leader, member) == 0
        d = leader.describe()
        return got, d, member.describe()
    finally:
        await leader.stop()
        await member.stop()


_JAX: dict = {}


def jax_streams(strategy: str, ckpt: str, spec: str = "") -> tuple:
    """The all-JAX group's streams (cached per module run)."""
    if (strategy, spec) not in _JAX:
        _JAX[strategy, spec] = asyncio.run(asyncio.wait_for(
            _direct("jax", strategy, ckpt, spec), DEADLINE))
    return _JAX[strategy, spec]


# -------------------------------------------------------------- host side

@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 4), max_size=24), st.integers(1, 6))
def test_ngram_drafts_match_jax(history, k):
    assert TSH._ngram_drafts(history, k) == JSH._ngram_drafts(history, k)


SAMPLE_CASES = {
    "greedy": dict(temperature=0.0, top_p=1.0),
    "temperature": dict(temperature=0.8, top_p=1.0),
    "top_p": dict(temperature=1.0, top_p=0.7),
    "top_k": dict(temperature=0.9, top_p=1.0, top_k=5),
    "penalty": dict(temperature=0.7, top_p=0.95, repeat_penalty=1.3),
    "greedy_penalty": dict(temperature=0.0, top_p=1.0, repeat_penalty=2.0),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_host_picks_jax_tokens(case):
    kw = dict(SAMPLE_CASES[case])
    r = np.random.default_rng(5)
    for trial in range(20):
        logits = (3.0 * r.standard_normal(512)).astype(np.float32)
        recent = list(r.integers(0, 512, size=70))
        if "repeat_penalty" in kw:
            kw["recent"] = recent
        trng, jrng = (np.random.default_rng(trial),
                      np.random.default_rng(trial))
        got = [TSH.sample_host(logits, rng=trng, **kw) for _ in range(8)]
        want = [JSH.sample_host(logits, rng=jrng, **kw) for _ in range(8)]
        assert got == want


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("spec", ["", "ngram"])
@pytest.mark.parametrize("strategy", ["pp", "ep"])
def test_sharded_streams_match_jax(strategy, spec, ckpts):
    want, jdesc, jmember = jax_streams(strategy, ckpts[strategy], spec)
    got, tdesc, tmember = asyncio.run(asyncio.wait_for(
        _direct("torch", strategy, ckpts[strategy], spec), DEADLINE))
    assert got == want
    if spec:
        assert tdesc["spec_decode"] == jdesc["spec_decode"]
        assert tdesc["spec_decode"]["tokens_per_step"] > 1.0
    for t, j in ((tdesc, jdesc), (tmember, jmember)):
        assert dataclasses.asdict(t["shard_group"]) == dataclasses.asdict(
            j["shard_group"])
        assert t["embeddings"] is j["embeddings"] is False
        assert set(t) == set(j)


async def _swarm_group(strategy: str, ckpt: str, leader_pkg: str,
                       member_pkg: str) -> dict:
    boot, _ = await new_host_and_dht(JKey.generate(), listen_host="127.0.0.1")
    node = dict(listen_host="127.0.0.1",
                bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
    started = []
    try:
        parts = []
        for index, pkg in ((0, leader_pkg), (1, member_pkg)):
            if pkg == "jax":
                conf = jconf(strategy, ckpt, index, **node)
                eng = JSH.ShardedEngine(conf)
                peer = JPeer(JKey.generate(), conf, engine=eng,
                             worker_mode=True)
            else:
                conf = tconf(strategy, ckpt, index, **node)
                eng = TSH.ShardedEngine(conf, device="cpu")
                peer = TPeer(TKey.generate(), conf, eng)
            parts.append((eng, peer))
        for eng, peer in parts:
            await eng.start()
            started.append(eng)
            await peer.start()
            started.append(peer)
        (leader, lpeer), (member, mpeer) = parts
        deadline = time.monotonic() + 60.0
        while mpeer.peer_id not in {
                p.peer_id for p in lpeer.peer_manager.group_members(
                    _group(strategy))}:
            assert time.monotonic() < deadline, "member not discovered"
            await asyncio.sleep(0.05)
        seen = lpeer.peer_manager.get_peer(mpeer.peer_id).resource
        assert seen.shard_group.shard_index == 1
        if strategy == "ep":
            assert list(seen.shard_group.expert_ids) == [1, 3]
        got = await streams(leader, {"plain": PROMPTS["plain"]})
        assert sessions(strategy, leader, member) == 0
        return got
    finally:
        for part in reversed(started):
            await part.stop()
        await boot.close()


@pytest.mark.parametrize("leader_pkg,member_pkg", [("jax", "torch"),
                                                   ("torch", "jax")])
@pytest.mark.parametrize("strategy", ["pp", "ep"])
def test_mixed_groups_give_the_all_jax_stream(strategy, leader_pkg,
                                              member_pkg, ckpts):
    want = jax_streams(strategy, ckpts[strategy])[0]
    got = asyncio.run(asyncio.wait_for(_swarm_group(
        strategy, ckpts[strategy], leader_pkg, member_pkg), DEADLINE))
    assert got == {"plain": want["plain"]}


async def _wait(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def _gateway_swarm(ckpt: str) -> dict:
    boot, _ = await t_new_host_and_dht(TKey.generate(),
                                       listen_host="127.0.0.1")
    node = dict(listen_host="127.0.0.1",
                bootstrap_peers=[f"127.0.0.1:{boot.listen_port}"])
    model = MODELS["pp"]
    lconf, mconf = (tconf("pp", ckpt, i, **node) for i in (0, 1))
    leader = TSH.ShardedEngine(lconf, device="cpu")
    member = TSH.ShardedEngine(mconf, device="cpu")
    lpeer = TPeer(TKey.generate(), lconf, leader)
    mpeer = TPeer(TKey.generate(), mconf, member)
    consumer = TPeer(TKey.generate(), TConf(**node), FakeEngine(models=[]),
                     worker_mode=False)
    gw = Gateway(consumer, port=0, host="127.0.0.1")
    started = []
    out: dict = {}
    member_up = False
    try:
        for part in (leader, lpeer, consumer, gw):
            await part.start()
            started.append(part)
        pm = consumer.peer_manager
        await _wait(lambda: lpeer.peer_id in {
            p.peer_id for p in pm.get_healthy_peers()}, "the leader")
        out["alone"] = pm.find_best_worker(model)
        for part in (member, mpeer):
            await part.start()
            started.append(part)
        member_up = True
        await _wait(lambda: (pm.find_best_worker(model) is not None
                             and mpeer.peer_id in {
                                 p.peer_id for p in
                                 lpeer.peer_manager.group_members(
                                     _group("pp"))}), "a complete group")
        out["routed"] = pm.find_best_worker(model).peer_id == lpeer.peer_id
        base = f"http://127.0.0.1:{gw.port}"
        body = {"model": model, "options": {"num_predict": 8},
                "messages": [{"role": "user", "content": "hi"}]}
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{base}/api/chat", json=body) as r:
                out["chat"] = (r.status, await r.json())
            async with s.post(f"{base}/api/chat",
                              json=dict(body, stream=True)) as r:
                out["stream"] = (r.status, await r.text())
            out["sessions"] = sessions("pp", leader, member)

            # drain on the member waits for the leader's live session.
            async def gen():
                async for _ in leader.generate("a longer request",
                                               max_tokens=40):
                    await asyncio.sleep(0.01)

            task = asyncio.create_task(gen())
            await _wait(lambda: member.runner.session_count == 1,
                        "a live member session", 30.0)
            drain = asyncio.create_task(member.drain(30.0))
            await asyncio.sleep(0.1)
            out["drain_waited"] = not drain.done()
            await task
            out["drained"] = await drain

            await mpeer.stop()
            member_up = False
            await _wait(lambda: pm.find_best_worker(model) is None,
                        "the group unroutable", 60.0)
            async with s.post(f"{base}/api/chat", json=body) as r:
                out["dead"] = r.status
        out["leader_id"] = lpeer.peer_id
        return out
    finally:
        for part in reversed(started):
            if part is mpeer and not member_up:
                continue
            await part.stop()
        await boot.close()


def test_gateway_routes_a_complete_group_and_503s_without_it(ckpts):
    import json

    out = asyncio.run(asyncio.wait_for(_gateway_swarm(ckpts["pp"]),
                                       DEADLINE))
    assert out["alone"] is None
    assert out["routed"]
    status, reply = out["chat"]
    assert status == 200 and reply["done"]
    assert reply["worker_id"] == out["leader_id"]
    assert reply["eval_count"] == 8
    status, text = out["stream"]
    lines = [json.loads(line) for line in text.splitlines()]
    assert status == 200 and lines[-1]["done"]
    assert lines[-1]["worker_id"] == out["leader_id"]
    assert out["sessions"] == 0
    assert out["drain_waited"] and out["drained"]
    assert out["dead"] == 503


# --------------------------------------------------------------- failures

class _Flaky:
    """A pipeline whose member rejects the verify op (``verify``) or dies
    after prefill (``die``)."""

    def __init__(self, inner, verify: bool = False, die: bool = False):
        self.inner, self.verify_fails, self.die = inner, verify, die
        self.released: list[str] = []
        self.closed = False

    async def prefill(self, *a):
        return await self.inner.prefill(*a)

    async def decode(self, *a):
        if self.die:
            raise ConnectionResetError("member gone")
        return await self.inner.decode(*a)

    async def verify(self, *a):
        if self.verify_fails:
            raise RuntimeError("shard stage error: unknown op 'verify'")
        return await self.inner.verify(*a)

    async def release(self, session):
        self.released.append(session)
        await self.inner.release(session)

    def close(self):
        self.closed = True


async def _failures(pkg: str, ckpt: str) -> dict:
    leader = engine(pkg, "pp", ckpt, 0, spec_decode="ngram", spec_draft=3)
    member = engine(pkg, "pp", ckpt, 1)
    await leader.start()
    await member.start()
    out: dict = {}
    try:
        wire(pkg, "pp", leader, member)
        flaky = _Flaky(leader._pipeline, verify=True)
        leader._pipeline = flaky
        try:
            await streams(leader, {"echo": PROMPTS["echo"]})
        except RuntimeError as e:
            out["verify_error"] = str(e)
        out["dropped"] = (leader._pipeline is None, flaky.closed)
        out["unsupported"] = leader._verify_unsupported
        leader._pipeline = flaky  # the group re-resolved
        out["per_token"] = await streams(leader, {"echo": PROMPTS["echo"]})
        dying = _Flaky(flaky.inner, die=True)
        leader._pipeline = dying
        try:
            await streams(leader, {"plain": PROMPTS["plain"]})
        except ConnectionResetError:
            out["died"] = True
        out["released"] = (len(flaky.released), len(dying.released),
                           dying.closed, leader._pipeline is None)
        out["sessions"] = sessions("pp", leader, member)
        return out
    finally:
        await leader.stop()
        await member.stop()


def test_member_failures_are_handled_as_jax_does(ckpts):
    got = asyncio.run(asyncio.wait_for(_failures("torch", ckpts["pp"]),
                                       DEADLINE))
    want = asyncio.run(asyncio.wait_for(_failures("jax", ckpts["pp"]),
                                        DEADLINE))
    assert got == want
    assert got["unsupported"] and got["died"]
    assert got["per_token"]["echo"] == jax_streams(
        "pp", ckpts["pp"])[0]["echo"]
    assert got["released"] == (2, 1, True, True) and got["sessions"] == 0


# ------------------------------------------------------- config and CLI

SHARD_ARGV = ["--shard-group", "g", "--shard-index", "1", "--shard-count",
              "3", "--shard-strategy", "ep"]
SHARD_FIELDS = ("shard_group", "shard_index", "shard_count",
                "shard_strategy")


@pytest.mark.parametrize("argv", [[], SHARD_ARGV], ids=["defaults", "set"])
def test_shard_flags_parse_as_the_jax_clis(argv):
    args = ["start", "--worker-mode", *argv]
    t = TConf.from_flags(tcli.build_parser().parse_args(args))
    j = JConf.from_flags(jcli.build_parser().parse_args(args))
    assert {k: getattr(t, k) for k in SHARD_FIELDS} == {
        k: getattr(j, k) for k in SHARD_FIELDS}


def test_shard_environment_parses_as_jax(monkeypatch):
    for var, value in (("SHARD_GROUP", "grp"), ("SHARD_INDEX", "2"),
                       ("SHARD_COUNT", "4"), ("SHARD_STRATEGY", "ep")):
        monkeypatch.setenv(f"CROWDLLAMA_TPU_{var}", value)
    t, j = TConf.from_environment(), JConf.from_environment()
    got = {k: getattr(t, k) for k in SHARD_FIELDS}
    assert got == {k: getattr(j, k) for k in SHARD_FIELDS}
    assert got == {"shard_group": "grp", "shard_index": 2, "shard_count": 4,
                   "shard_strategy": "ep"}


def test_make_engine_builds_a_member_and_refuses_as_jax(monkeypatch):
    args = ["start", "--worker-mode", "--model", "tiny-test",
            "--shard-count", "2", "--shard-index", "1", "--device", "cpu"]
    cfg = TConf.from_flags(tcli.build_parser().parse_args(args))
    eng = tcli.make_engine(cfg)
    assert isinstance(eng, TSH.ShardedEngine)
    assert eng.device == torch.device("cpu")
    jeng = jcli._make_engine(JConf.from_flags(jcli.build_parser().parse_args(
        args[:-2])), True)
    assert (eng.group_id, eng.shard_index, eng.is_leader) == (
        jeng.group_id, jeng.shard_index, jeng.is_leader)
    errs = []
    for make, conf in ((tcli.make_engine, dataclasses.replace(
            cfg, model="tiny-test,tiny-test-moe")),
            (lambda c: jcli._make_engine(c, True),
             JConf(model="tiny-test,tiny-test-moe", shard_count=2))):
        with pytest.raises(ValueError) as e:
            make(conf)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    # Without a card and without device="cpu", a member refuses to start.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.make_engine(dataclasses.replace(cfg, device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        TSH.ShardedEngine(TConf(model="tiny-test", shard_count=2))
    moe = get_config("tiny-test-moe", max_context_length=MAX_SEQ)
    for make in (lambda: TS.ShardStageRunner(moe, {"layers": {}}, 0, 2),
                 lambda: TE.EPLeaderRunner(moe, {"layers": {}}),
                 lambda: TE.ExpertBankRunner(moe, {"layers": {}}, [0]),
                 lambda: TS.SwarmPipeline(moe, {}, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("case", ["dense", "quantize", "range"])
def test_sharded_engine_refusals_match_jax(case, ckpts):
    kw = {"dense": dict(model="tiny-test", shard_strategy="ep",
                        shard_count=2),
          "quantize": dict(model="tiny-test-moe", shard_strategy="ep",
                           shard_count=2, quantize="int8"),
          "range": dict(model="tiny-test", shard_count=2, shard_index=2)}[case]

    async def start(make):
        eng = make()
        await eng.start()

    errs = []
    for make in (lambda: TSH.ShardedEngine(TConf(max_context_length=MAX_SEQ,
                                                 **kw), device="cpu"),
                 lambda: JSH.ShardedEngine(JConf(
                     max_context_length=MAX_SEQ,
                     intervals=JIntervals.default(), **kw))):
        with pytest.raises(ValueError) as e:
            asyncio.run(start(make))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
