"""The port's swarm model sharing (``net/model_share.py``, ``Peer.pull_model``,
the gateway's ``/api/pull``, the CLI's ``pull``/``list``/``show``/``rm``)
against the JAX package, on the CPU.

- ``safe_model_dirname``, ``dest_under_root`` and ``_shareable`` accept
  and reject the same names as JAX's (hypothesis), and map them alike.
- Each op's reply bytes (manifest, fetch of each file, refusals, the
  gated pull) from the port's ``ModelShareService`` equal the JAX
  service's on one HF-layout checkpoint directory.
- Pull gating over real hosts, as ``test_pull_op_gating``.
- A mixed swarm, both ways: a torch worker pulls the permutation
  checkpoint from a JAX worker, and a JAX worker from a torch worker;
  every file's SHA-256 equals the donor's, the model is hot-registered
  and advertised, and the puller's greedy stream equals the donor's.
- The port gateway's ``/api/pull``: 200 (both shapes) for a served model,
  404 naming the failed swarm pull for an absent one, and the proxied
  pull (the gateway's routing wrapped so it does not see the donor, as a
  gateway whose view lags), after which the gateway serves the pulled
  model from the puller with the donor's text.
- The CLI: the same flags as JAX's; ``pull`` from a worker into a models
  dir, then ``list``, ``show`` and ``rm`` printing what the JAX CLI
  prints on that directory, with its exit codes; ``list --gateway``.
"""

import asyncio
import hashlib
import json
import struct
from pathlib import Path

import pytest

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_handle import COMMON, _perm  # noqa: E402

from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.engine.multi import MultiEngine as JMulti  # noqa: E402
from crowdllama_tpu.net import model_share as jms  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.engine.engine import FakeEngine as TFake  # noqa: E402
from crowdllama_tpu_torch.engine.multi import MultiEngine as TMulti  # noqa: E402
from crowdllama_tpu_torch.gateway.gateway import Gateway as TGateway  # noqa: E402
from crowdllama_tpu_torch.net import model_share as tms  # noqa: E402
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

DEADLINE = 240.0
PROMPT = "the quick brown fox"
OTHER = "tiny-test-qwen2"  # the puller's own model, dense in both packages


# ------------------------------------------------------------------- names

NAME_CHARS = st.sampled_from(list("aZ09._-/\\ é:") + [".."])


@settings(max_examples=300, deadline=None)
@given(name=st.one_of(st.lists(NAME_CHARS, max_size=12).map("".join),
                      st.text(max_size=20), st.just("x" * 257),
                      st.just("x" * 256)))
def test_names_accepted_and_rejected_as_jax(tmp_path_factory, name):
    def outcome(fn, *a):
        try:
            return ("ok", fn(*a))
        except ValueError:
            return ("refused", None)

    assert outcome(tms.safe_model_dirname, name) == outcome(
        jms.safe_model_dirname, name)
    root = tmp_path_factory.getbasetemp() / "models"
    assert outcome(tms.dest_under_root, root, name) == outcome(
        jms.dest_under_root, root, name)
    assert tms._shareable(name) == jms._shareable(name)


def test_known_names_and_constants():
    for bad in (".", "..", "", "a/../b", "/etc", "a//b", ".hidden", "a\\b",
                "..evil", "x/", "/x", "a/.ssh", "x" * 300):
        with pytest.raises(ValueError):
            tms.safe_model_dirname(bad)
    assert tms.safe_model_dirname("meta-llama/Llama-3-8B") == (
        "meta-llama_Llama-3-8B")
    for k in ("CHUNK", "OP_TIMEOUT", "MANIFEST_TIMEOUT", "FETCH_IDLE_TIMEOUT",
              "MAX_FILE_BYTES", "MANIFEST_NAME", "_SHAREABLE"):
        assert getattr(tms, k) == getattr(jms, k), k


# ------------------------------------------------------------- wire bytes

@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """An HF-layout tiny-test checkpoint (config.json + safetensors)."""
    from crowdllama_tpu_torch.models.config import get_config

    cfg = get_config("tiny-test")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_context_length,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(7)
    d = tmp_path_factory.mktemp("ckpt") / "tiny-test"
    transformers.LlamaForCausalLM(hf_cfg).save_pretrained(
        str(d), safe_serialization=True)
    (d / ".hidden").write_text("never served")
    (d / "notes.txt").write_text("not checkpoint-shaped")
    return d


class _Sink:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


class _Stream:
    """An in-memory stream: one request frame in, the reply bytes out."""

    def __init__(self, req: dict):
        self.reader = asyncio.StreamReader()
        payload = json.dumps(req, separators=(",", ":")).encode()
        self.reader.feed_data(struct.pack(">I", len(payload)) + payload)
        self.reader.feed_eof()
        self.writer = _Sink()

    def close(self):
        pass


REQUESTS = [
    {"op": "manifest", "model": "tiny-test"},
    {"op": "manifest", "model": "other"},
    {"op": "manifest", "model": ".."},
    {"op": "fetch", "model": "tiny-test", "name": "config.json"},
    {"op": "fetch", "model": "tiny-test", "name": "model.safetensors"},
    {"op": "fetch", "model": "tiny-test", "name": ".hidden"},
    {"op": "fetch", "model": "tiny-test", "name": "notes.txt"},
    {"op": "fetch", "model": "tiny-test", "name": "../config.json"},
    {"op": "fetch", "model": "../../etc", "name": "passwd"},
    {"op": "pull", "model": "tiny-test"},
    {"op": "bogus", "model": "tiny-test"},
]


@pytest.mark.parametrize("allow", [True, False], ids=["pull_on", "pull_off"])
def test_reply_bytes_equal_jax(hf_checkpoint, allow):
    def model_dir(model):
        return str(hf_checkpoint) if model == "tiny-test" else None

    async def pull(model):
        return f"/pulled/{model}"

    async def go(mod):
        svc = mod.ModelShareService(model_dir=model_dir, pull=pull,
                                    allow_pull=allow)
        out = []
        for req in REQUESTS:
            s = _Stream(req)
            await svc.handle(s)
            out.append(bytes(s.writer.data))
        return out

    got, want = asyncio.run(go(tms)), asyncio.run(go(jms))
    for req, g, w in zip(REQUESTS, got, want):
        assert g == w, req
    manifest = json.loads(got[0][4:])
    assert {f["name"] for f in manifest["files"]} >= {
        "config.json", "model.safetensors"}
    for f in manifest["files"]:
        assert f["sha256"] == hashlib.sha256(
            (hf_checkpoint / f["name"]).read_bytes()).hexdigest()


def test_cache_manifest_and_verify(hf_checkpoint, tmp_path):
    import shutil

    dest = tmp_path / "tiny-test"
    shutil.copytree(hf_checkpoint, dest)
    files = [{"name": p.name, "size": p.stat().st_size,
              "sha256": tms._sha256_file(p)}
             for p in sorted(dest.iterdir()) if tms._shareable(p.name)]
    tms.write_cache_manifest(dest, files)
    jdest = tmp_path / "jax"
    jdest.mkdir()
    jms.write_cache_manifest(jdest, files)
    assert ((dest / tms.MANIFEST_NAME).read_bytes()
            == (jdest / jms.MANIFEST_NAME).read_bytes())
    assert tms.verify_cached(dest) and jms.verify_cached(dest)
    (dest / "config.json").write_text("{}")
    assert not tms.verify_cached(dest) and not jms.verify_cached(dest)
    assert tms.verify_cached(tmp_path / "nothing")  # no manifest: nothing to check


# -------------------------------------------------------------- swarms

def _tconf(boot, **kw):
    return TConf(listen_host="127.0.0.1", bootstrap_peers=[boot],
                 warmup=False, device="cpu", **COMMON, **kw)


def _jconf(boot, **kw):
    return JConf(listen_host="127.0.0.1", bootstrap_peers=[boot],
                 warmup=False, intervals=JIntervals.default(), **COMMON,
                 **kw)


async def _wait(cond, what: str, timeout: float = 60.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.1)


async def _greedy(engine, model: str) -> tuple[str, int]:
    text, final = "", None
    async for c in engine.generate(PROMPT, model=model, max_tokens=12):
        text += c.text
        final = c
    return text, final.completion_tokens


def _worker(pkg: str, boot: str, **kw):
    if pkg == "torch":
        cfg = _tconf(boot, **kw)
        eng = TMulti(cfg, device="cpu")
        return eng, TPeer(TKey.generate(), cfg, eng)
    cfg = _jconf(boot, **kw)
    eng = JMulti(cfg)
    return eng, JPeer(JKey.generate(), cfg, engine=eng, worker_mode=True)


def _sees(peer, model: str) -> bool:
    return any(model in p.resource.supported_models
               for p in peer.peer_manager.get_healthy_peers())


async def _mixed(tmp_path, donor_pkg: str, puller_pkg: str) -> dict:
    ckpt, _ = _perm(tmp_path)
    boot_host, _ = await new_host_and_dht(JKey.generate(),
                                          listen_host="127.0.0.1")
    boot = f"127.0.0.1:{boot_host.listen_port}"
    d_eng, donor = _worker(donor_pkg, boot, model="tiny-test",
                           model_path=ckpt)
    p_eng, puller = _worker(puller_pkg, boot, model=OTHER,
                            models_dir=str(tmp_path / "pulled"))
    started = []
    try:
        for part in (d_eng, donor, p_eng, puller):
            await part.start()
            started.append(part)
        await _wait(lambda: _sees(puller, "tiny-test"), "the donor")
        dest = Path(await puller.pull_model("tiny-test"))
        served = list(p_eng.models)
        puller.update_metadata()
        advertised = list(puller.resource.supported_models)
        return {"ckpt": Path(ckpt), "dest": dest, "served": served,
                "advertised": advertised,
                "donor": await _greedy(d_eng, "tiny-test"),
                "puller": await _greedy(p_eng, "tiny-test"),
                "model_dir": p_eng.model_dir("tiny-test")}
    finally:
        for part in reversed(started):
            await part.stop()
        await boot_host.close()


@pytest.mark.parametrize("donor,puller", [("jax", "torch"),
                                          ("torch", "jax")])
def test_mixed_swarm_pull_serves_the_donors_stream(tmp_path, donor, puller):
    out = asyncio.run(asyncio.wait_for(_mixed(tmp_path, donor, puller),
                                       DEADLINE))
    dest, ckpt = out["dest"], out["ckpt"]
    assert dest == (tmp_path / "pulled" / "tiny-test").resolve()
    names = sorted(p.name for p in ckpt.iterdir())
    assert sorted(p.name for p in dest.iterdir()
                  if p.name != tms.MANIFEST_NAME) == names
    for n in names:
        assert (hashlib.sha256((dest / n).read_bytes()).hexdigest()
                == hashlib.sha256((ckpt / n).read_bytes()).hexdigest()), n
    assert tms.verify_cached(dest) and jms.verify_cached(dest)
    assert out["served"] == [OTHER, "tiny-test"]
    assert "tiny-test" in out["advertised"]
    assert out["model_dir"] == str(dest)
    assert out["puller"] == out["donor"] and out["donor"][1] == 12


async def _gateway_topology(tmp_path) -> dict:
    ckpt, _ = _perm(tmp_path)
    boot_host, _ = await new_host_and_dht(JKey.generate(),
                                          listen_host="127.0.0.1")
    boot = f"127.0.0.1:{boot_host.listen_port}"
    a_eng, worker_a = _worker("torch", boot, model="tiny-test",
                              model_path=ckpt)
    b_eng, worker_b = _worker("torch", boot, model=OTHER,
                              models_dir=str(tmp_path / "pulled_b"))
    consumer = TPeer(TKey.generate(), _tconf(boot), TFake(models=[]),
                     worker_mode=False)
    gateway = TGateway(consumer, port=0, host="127.0.0.1")
    started, out = [], {}
    try:
        for part in (a_eng, worker_a, b_eng, worker_b, consumer, gateway):
            await part.start()
            started.append(part)
        base = f"http://127.0.0.1:{gateway.port}"
        pm = consumer.peer_manager
        await _wait(lambda: len([p for p in pm.get_healthy_peers()
                                 if p.is_worker]) >= 2
                    and _sees(worker_b, "tiny-test"), "full discovery")

        async def pull(s, model, stream):
            async with s.post(f"{base}/api/pull",
                              json={"model": model, "stream": stream}) as r:
                return r.status, r.content_type, await r.text()

        async with aiohttp.ClientSession() as s:
            out["served"] = await pull(s, "tiny-test", False)
            out["served_stream"] = await pull(s, "tiny-test", True)
            out["absent"] = await pull(s, "no-such-model", False)
            # The gateway's view without worker A: the served check misses
            # and the pull is proxied to worker B, which fetches from A.
            orig = pm.find_best_worker
            pm.find_best_worker = lambda model, exclude=frozenset(), **kw: \
                orig(model, exclude=set(exclude) | {worker_a.peer_id}, **kw)
            out["proxied"] = await pull(s, "tiny-test", True)
            out["b_models"] = list(b_eng.models)
            await _wait(lambda: any(
                p.peer_id == worker_b.peer_id
                and "tiny-test" in p.resource.supported_models
                for p in pm.get_healthy_peers()), "B advertising the model")
            async with s.post(f"{base}/api/generate", json={
                    "model": "tiny-test", "prompt": PROMPT, "stream": False,
                    "options": {"num_predict": 12}}) as r:
                out["via_gateway"] = (r.status, await r.json())
            out["direct_a"] = await _greedy(a_eng, "tiny-test")
            out["ids"] = {"a": worker_a.peer_id, "b": worker_b.peer_id}
            out["list"] = await asyncio.to_thread(_cli_out, "torch", [
                "list", "--gateway", base])
            out["list_jax"] = await asyncio.to_thread(_cli_out, "jax", [
                "list", "--gateway", base])
            out["pull_cli"] = await asyncio.to_thread(_cli_out, "torch", [
                "pull", "tiny-test", "--bootstrap-peers", boot,
                "--models-dir", str(tmp_path / "cli"), "--key-path",
                str(tmp_path / "cli.key")])
    finally:
        for part in reversed(started):
            await part.stop()
        await boot_host.close()
    out["ckpt"] = Path(ckpt)
    return out


def _cli_out(pkg: str, argv: list[str]) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of a CLI's ``main(argv)``."""
    import contextlib
    import io

    if pkg == "torch":
        from crowdllama_tpu_torch.cli.main import main
    else:
        from crowdllama_tpu.cli.main import main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def gateway_run(tmp_path_factory):
    return asyncio.run(asyncio.wait_for(
        _gateway_topology(tmp_path_factory.mktemp("gw")), DEADLINE))


def test_api_pull_served_and_absent(gateway_run):
    status, ctype, body = gateway_run["served"]
    assert status == 200 and json.loads(body) == {"status": "success"}
    status, ctype, body = gateway_run["served_stream"]
    assert status == 200 and ctype == "application/x-ndjson"
    assert [json.loads(x) for x in body.splitlines()] == [
        {"status": "pulling manifest"}, {"status": "success"}]
    status, _, body = gateway_run["absent"]
    assert status == 404 and "swarm pull failed" in json.loads(body)["error"]


def test_api_pull_proxies_to_a_worker_that_serves_it_after(gateway_run):
    status, _, body = gateway_run["proxied"]
    lines = [json.loads(x) for x in body.splitlines()]
    assert status == 200 and lines[-1] == {"status": "success"}
    b = gateway_run["ids"]["b"]
    assert lines[1]["status"].startswith("pulled to ")
    assert lines[1]["status"].endswith(f"on worker {b[:8]}")
    assert gateway_run["b_models"] == [OTHER, "tiny-test"]
    status, reply = gateway_run["via_gateway"]
    assert status == 200 and reply["worker_id"] == b
    assert (reply["response"], reply["eval_count"]) == gateway_run[
        "direct_a"]


def test_cli_list_gateway_and_pull(gateway_run, tmp_path):
    rc, out, _ = gateway_run["list"]
    assert (rc, out) == gateway_run["list_jax"][:2]
    assert rc == 0 and "tiny-test" in out.splitlines()
    rc, out, err = gateway_run["pull_cli"]
    assert rc == 0, err
    dest = Path(out.strip())
    for p in gateway_run["ckpt"].iterdir():
        assert (dest / p.name).read_bytes() == p.read_bytes()

    # list / show / rm on that models dir: the JAX CLI's output and codes.
    root = str(dest.parent)
    for argv in (["list", "--models-dir", root],
                 ["show", "tiny-test", "--models-dir", root],
                 ["show", "no-such", "--models-dir", root],
                 ["show", "..", "--models-dir", root],
                 ["rm", "..", "--models-dir", root],
                 ["rm", "no-such", "--models-dir", root]):
        got, want = _cli_out("torch", argv), _cli_out("jax", argv)
        assert got[:2] == want[:2], argv
    assert _cli_out("torch", ["rm", "tiny-test", "--models-dir", root]) == (
        0, f"removed {dest}\n", "")
    assert _cli_out("jax", ["list", "--models-dir", root])[:2] == (
        _cli_out("torch", ["list", "--models-dir", root])[:2])
    empty = str(tmp_path / "none")
    assert _cli_out("torch", ["list", "--models-dir", empty])[:2] == (
        0, f"no local checkpoints under {empty}\n")


def test_cli_model_commands_parse_like_jax():
    from crowdllama_tpu.cli.main import build_parser as jparser
    from crowdllama_tpu_torch.cli.main import build_parser

    for argv in (["pull", "m", "--bootstrap-peers", "a:1,b:2"],
                 ["pull", "org/m", "--bootstrap-peers", "a:1",
                  "--models-dir", "/d", "--key-path", "/k"],
                 ["list"], ["list", "--gateway", "http://x:1",
                            "--models-dir", "/d"],
                 ["show", "m"], ["show", "m", "--models-dir", "/d"],
                 ["rm", "m"], ["rm", "m", "--models-dir", "/d"]):
        assert vars(build_parser().parse_args(argv)) == vars(
            jparser().parse_args(argv)), argv
    with pytest.raises(SystemExit):
        build_parser().parse_args(["pull", "m"])  # --bootstrap-peers


def test_pull_op_gating(tmp_path):
    """A worker with ``allow_swarm_pull=False`` refuses the remote pull op
    but still serves manifests; bad names are refused at the wire."""
    from crowdllama_tpu_torch.core.protocol import MODEL_PROTOCOL
    from crowdllama_tpu_torch.net.discovery import (
        new_host_and_dht as t_new_host,
    )
    from crowdllama_tpu_torch.net.host import (
        read_json_frame,
        write_json_frame,
    )

    async def go():
        ckpt, _ = _perm(tmp_path)
        boot_host, _ = await t_new_host(TKey.generate(),
                                        listen_host="127.0.0.1")
        boot = f"127.0.0.1:{boot_host.listen_port}"
        eng, worker = _worker("torch", boot, model="tiny-test",
                              model_path=ckpt, allow_swarm_pull=False)
        client, _ = await t_new_host(TKey.generate(), listen_host="127.0.0.1")
        await eng.start()
        await worker.start()

        async def op(req):
            s = await client.new_stream(worker.host.contact, MODEL_PROTOCOL)
            try:
                await write_json_frame(s.writer, req)
                return await read_json_frame(s.reader, 10.0)
            finally:
                s.close()

        try:
            return [await op(r) for r in (
                {"op": "pull", "model": "tiny-test"},
                {"op": "manifest", "model": "tiny-test"},
                {"op": "manifest", "model": ".."},
                {"op": "fetch", "model": "../../etc", "name": "passwd"})]
        finally:
            await client.close()
            await worker.stop()
            await eng.stop()
            await boot_host.close()

    pull, manifest, bad, fetch = asyncio.run(asyncio.wait_for(go(), 120))
    assert not pull["ok"] and "disabled" in pull["error"]
    assert manifest["ok"] and manifest["files"]
    assert not bad["ok"] and "invalid model name" in bad["error"]
    assert not fetch["ok"]


@pytest.mark.parametrize("allow", [None, "1", "true", "0", "", "yes"])
def test_config_env_matches_jax(monkeypatch, tmp_path, allow):
    """``models_dir`` and ``allow_swarm_pull`` from the environment, as the
    JAX package reads them."""
    monkeypatch.setenv("CROWDLLAMA_TPU_MODELS_DIR", str(tmp_path / "m"))
    if allow is None:
        monkeypatch.delenv("CROWDLLAMA_TPU_ALLOW_SWARM_PULL", raising=False)
    else:
        monkeypatch.setenv("CROWDLLAMA_TPU_ALLOW_SWARM_PULL", allow)
    got, want = TConf.from_environment(), JConf.from_environment()
    assert (got.models_dir, got.allow_swarm_pull) == (
        want.models_dir, want.allow_swarm_pull)
