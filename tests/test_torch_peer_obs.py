"""The port worker's serve loop, its obs plane and its CLI, against the JAX
worker's.

A port worker (``Peer`` over ``TorchEngine`` on the CPU) and a JAX worker
(``Peer`` over ``JaxEngine``), both on ``tiny-test`` random weights, each
get the same llama.v1 traffic from a JAX client host over one pooled
inference stream: a streamed generate request of a two-page prompt
carrying a trace id, then ``trace_fetch``, ``metrics_fetch`` (whole and
filtered), a ``kv_fetch_request`` for that prompt's chain hashes, a stray
``draft_chunk``, a ``gossip_frame`` (no reply; the stream stays usable), a
non-streamed request, then ``drain()`` and one more request (the typed
``draining`` reject).

- ``node_metric_lines`` of the two workers have the same metric families
  and label names (``crowdllama_native_*`` included), and the trace
  records the same spans, parents and meta keys.
- ``metrics_fetch`` and ``trace_fetch`` are answered over the stream; a
  ``kv_fetch_request`` gets the prompt's two pages (``matched=2``,
  ``done``, no error, pages of the same size as the JAX worker's); a
  stray ``draft_chunk`` a terminal nack.
- The CLI parses the ``start --worker-mode`` flags it shares with the JAX
  parser into equal values (defaults too); consumer mode starts without
  CUDA, a worker refuses to start without it unless ``--device cpu`` is
  given; with
  it, ``python -m crowdllama_tpu_torch.cli.main start --worker-mode``
  joins a JAX bootstrap node, serves metadata and exits 0 on SIGINT.
"""

import asyncio
import dataclasses
import json
import os
import re
import signal
import sys
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu import config as jconfig  # noqa: E402
from crowdllama_tpu.cli import main as jcli  # noqa: E402
from crowdllama_tpu.core import messages as jm  # noqa: E402
from crowdllama_tpu.core import wire as jwire  # noqa: E402
from crowdllama_tpu.core.protocol import INFERENCE_PROTOCOL  # noqa: E402
from crowdllama_tpu.core.resource import Resource as JResource  # noqa: E402
from crowdllama_tpu.engine.engine import JaxEngine  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.net.host import Contact, Host  # noqa: E402
from crowdllama_tpu.obs.http import (  # noqa: E402
    node_metric_lines as j_node_metric_lines,
)
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch import config as tconfig  # noqa: E402
from crowdllama_tpu_torch.cli import main as tcli  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.multi import MultiEngine  # noqa: E402
from crowdllama_tpu_torch.obs.http import node_metric_lines  # noqa: E402
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

DEADLINE = 120.0
ENGINE = dict(model="tiny-test", max_context_length=256, kv_page_size=16,
              max_batch_slots=2, warmup=False)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two full pages of 16 tokens before its last token.
PAGED_PROMPT = "hello " * 7


async def _rt(stream, msg, frames: bool = False):
    await jwire.write_length_prefixed_pb(stream.writer, msg)
    if not frames:
        return await jwire.read_length_prefixed_pb(stream.reader, 60)
    out = []
    while True:
        m = await jwire.read_length_prefixed_pb(stream.reader, 60)
        out.append(m)
        if m.generate_response.done:
            return out


async def _drive(pkg: str) -> dict:
    if pkg == "torch":
        engine = TorchEngine(device="cpu", **ENGINE)
        worker = TPeer(TKey.generate(), tconfig.Configuration(
            listen_host="127.0.0.1", device="cpu", **ENGINE), engine)
    else:
        engine = JaxEngine(jconfig.Configuration(**ENGINE))
        worker = JPeer(JKey.generate(), jconfig.Configuration(
            listen_host="127.0.0.1", relay_mode="off", **ENGINE),
            engine=engine, worker_mode=True)
    client = Host(JKey.generate(), listen_host="127.0.0.1")
    await engine.start()
    await worker.start()
    out: dict = {}
    try:
        s = await client.new_stream(
            Contact(worker.peer_id, "127.0.0.1", worker.host.listen_port),
            INFERENCE_PROTOCOL)
        req = jm.create_generate_request("tiny-test", PAGED_PROMPT,
                                         stream=True, max_tokens=6)
        req.trace_id, req.parent_span = "trace-1", "gateway"
        out["frames"] = await _rt(s, req, frames=True)
        out["trace"] = (await _rt(s, jm.trace_fetch_msg("trace-1"))).trace_spans
        out["missing"] = (await _rt(s, jm.trace_fetch_msg("nope"))).trace_spans
        out["metrics"] = (await _rt(s, jm.metrics_fetch_msg())).metrics_snapshot
        out["metrics_req"] = (await _rt(s, jm.metrics_fetch_msg(
            ["crowdllama_request_seconds"]))).metrics_snapshot
        runner = engine.runner if pkg == "torch" else engine._runner
        keys = runner.chain_keys_for_prompt(
            engine.tokenizer.encode(PAGED_PROMPT))
        out["kv"] = (await _rt(s, jm.create_kv_fetch_request(
            "tiny-test", keys, 16))).kv_pages
        out["draft"] = (await _rt(s, jm.draft_chunk_msg(
            "tiny-test", chunk_id=3, position=9, tokens=[1]))).verify_result
        await jwire.write_length_prefixed_pb(
            s.writer, jm.gossip_frame_msg(origin="gw"))
        out["plain"] = (await _rt(s, jm.create_generate_request(
            "tiny-test", "hello", max_tokens=6))).generate_response
        out["lines"] = (node_metric_lines(worker) if pkg == "torch" else
                        j_node_metric_lines(worker))
        await worker.drain()
        out["rejected"] = (await _rt(s, jm.create_generate_request(
            "tiny-test", "hello", max_tokens=6))).generate_response
        out["peer_id"] = worker.peer_id
        s.close()
    finally:
        await client.close()
        await worker.stop()
        await engine.stop()
    return out


@pytest.fixture(scope="module")
def served():
    return {pkg: asyncio.run(asyncio.wait_for(_drive(pkg), DEADLINE))
            for pkg in ("torch", "jax")}


_SERIES = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s")


def _schema(lines: list[str]) -> dict:
    """family -> sorted label names of its series (TYPE lines give the
    families, series lines their labels)."""
    out: dict[str, set] = {}
    for ln in lines:
        if ln.startswith("# TYPE"):
            _, _, name, kind = ln.split()
            out.setdefault(f"{name} {kind}", set())
            continue
        m = _SERIES.match(ln)
        assert m, ln
        labels = tuple(sorted(kv.split("=")[0] for kv in
                              (m.group(3) or "").split(",") if kv))
        out.setdefault(m.group(1), set()).add(labels)
    return {k: sorted(v) for k, v in out.items()}


def test_metric_families_and_labels_equal_the_jax_workers(served):
    want = _schema(served["jax"]["lines"])
    assert "crowdllama_native_fallbacks_total counter" in want
    assert _schema(served["torch"]["lines"]) == want
    payload = served["torch"]["metrics"].payload.decode().splitlines()
    assert _schema(payload) == _schema(served["torch"]["lines"])


def test_trace_record_equals_the_jax_workers(served):
    recs = {}
    for pkg in ("torch", "jax"):
        ts = served[pkg]["trace"]
        assert ts.found and ts.trace_id == "trace-1"
        assert ts.node == f"worker:{served[pkg]['peer_id'][:8]}"
        rec = json.loads(ts.payload)
        recs[pkg] = (sorted(rec), sorted(rec["meta"]), rec["done"],
                     [(sp["name"], sp.get("parent"), sorted(sp.get("meta", {})))
                      for sp in rec["spans"]])
        missing = served[pkg]["missing"]
        assert not missing.found and missing.trace_id == "nope"
    assert recs["torch"] == recs["jax"]
    names = [sp[0] for sp in recs["torch"][3]]
    assert names == ["worker_queue", "prefill", "decode_step", "stream_flush"]


def test_served_arms(served):
    t, j = served["torch"], served["jax"]
    for pkg in (t, j):
        assert pkg["frames"][-1].generate_response.done
        assert all(f.trace_id == "trace-1" for f in pkg["frames"])
        assert pkg["plain"].done and pkg["plain"].completion_tokens == 6
        assert pkg["rejected"].done_reason == "draining"
        d = pkg["draft"]
        assert (d.chunk_id, d.position, d.done, d.accepted) == (3, 9, True, 0)
        assert pkg["metrics"].found and pkg["metrics_req"].found
        fams = {ln.split()[2] for ln in
                pkg["metrics_req"].payload.decode().splitlines()
                if ln.startswith("# TYPE")}
        assert fams == {"crowdllama_request_seconds"}
    for kv in (t["kv"], j["kv"]):
        assert (kv.matched, kv.done, kv.model, kv.error) == (
            2, True, "tiny-test", "")
        assert kv.kv_dtype == "bfloat16" and not kv.k_scales
        assert len(kv.k_pages) == len(kv.v_pages) == 2
    assert [len(b) for b in t["kv"].k_pages] == [
        len(b) for b in j["kv"].k_pages]


# ------------------------------------------------------------------- CLI

SHARED = ["--key-path", "/k", "--bootstrap-peers", "a:1, b:2",
          "--listen-port", "7", "--model", "m1,m2", "--model-path", "/mp",
          "--engine", "fake", "--mesh", "2", "--kv-layout", "contiguous",
          "--kv-page-size", "16", "--kv-pool-tokens", "64",
          "--kv-dtype", "int8", "--relay-mode", "off",
          "--step-token-budget", "40", "--no-ragged-prefill",
          "--profile-dir", "/p", "--trace-buffer", "5", "--trace-ttl", "2.5",
          "--metrics-exemplars", "--admission-pending-max", "3",
          "--kv-ship-timeout", "4", "--drain-timeout", "6", "--verbose"]


def _configs(argv):
    t = tconfig.Configuration.from_flags(
        tcli.build_parser().parse_args(["start", "--worker-mode", *argv]))
    j = jconfig.Configuration.from_flags(
        jcli.build_parser().parse_args(["start", "--worker-mode", *argv]))
    return t, j


@pytest.mark.parametrize("argv", [
    [], SHARED,
    # The replicated gateway's flags and the worker's fetch threshold,
    # refused by the port until its gossip plane and KV page shipping.
    ["--gateway-peers", "a:1, b:2"], ["--gossip-interval", "3"],
    ["--gossip-snapshot", "/s"], ["--tenant-quota", "t=1"],
    ["--kv-ship-min-tokens", "64"]],
    ids=["defaults", "shared", "gateway-peers", "gossip-interval",
         "gossip-snapshot", "tenant-quota", "kv-ship-min-tokens"])
def test_cli_flags_parse_as_the_jax_clis(argv):
    t, j = _configs(argv)
    shared = [f.name for f in dataclasses.fields(t)
              if hasattr(j, f.name) and f.name != "intervals"]
    assert len(shared) > 25
    assert {k: getattr(t, k) for k in shared} == {
        k: getattr(j, k) for k in shared}
    assert dataclasses.asdict(t.intervals) == dataclasses.asdict(j.intervals)
    assert t.device == "cuda"


def test_every_port_flag_is_a_jax_flag_but_device():
    def options(parser):
        start = parser._subparsers._group_actions[0].choices["start"]
        return {o for a in start._actions for o in a.option_strings}

    port = options(tcli.build_parser())
    assert port - options(jcli.build_parser()) == {"--device"}


@pytest.fixture
def app_logger_restored():
    """``start`` builds the "crowdllama" app logger as JAX's CLI does (its
    own handler, no propagation); put it back so later tests' ``caplog``
    sees the package's records."""
    import logging

    log = logging.getLogger("crowdllama")
    saved = (log.level, log.propagate, list(log.handlers))
    yield
    log.setLevel(saved[0])
    log.propagate = saved[1]
    log.handlers[:] = saved[2]


def test_cli_refuses_consumer_mode_and_a_missing_card(monkeypatch, capsys,
                                                     app_logger_restored):
    # Consumer mode is served now (it runs no model, so it needs no card);
    # a worker without a card is still refused.
    ran = []

    async def run_node(cfg, worker_mode=True):
        ran.append((cfg.gateway_port, worker_mode))

    monkeypatch.setattr(tcli, "run_node", run_node)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["start", "--gateway-port", "9123"]) == 0
    assert ran == [(9123, False)]
    assert tcli.main(["start", "--worker-mode"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.make_engine(tconfig.Configuration(model="tiny-test"))
    eng = tcli.make_engine(tconfig.Configuration(model="tiny-test",
                                                 device="cpu"))
    assert isinstance(eng, MultiEngine)
    assert eng._child("tiny-test").device == torch.device("cpu")
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["start", "--device", "tpu"])


@pytest.mark.parametrize("flag,value,item", [
    ("--spec-draft-path", "hf-dir", "item 9"),
    ("--spec-draft-path", "/d", "item 9"),
])
def test_unported_flags_refuse_any_value_but_their_default(flag, value,
                                                          item, tmp_path):
    # Both CLIs take a draft checkpoint directory, native or HF (ROADMAP
    # Queue 1 item 9a): an HF directory (config.json without the marker,
    # and safetensors) is accepted; no directory at all is refused at
    # start, no longer naming the item.
    from crowdllama_tpu_torch.engine.weights import write_safetensors

    if value == "hf-dir":
        (tmp_path / "config.json").write_text('{"model_type": "llama"}')
        write_safetensors({"model.norm.weight": torch.ones(4)},
                          tmp_path / "model.safetensors")
        value = str(tmp_path)
    args = ["start", flag, value]
    jconfig.Configuration.from_flags(jcli.build_parser().parse_args(args))
    parsed = tcli.build_parser().parse_args(args)
    if value == str(tmp_path):
        assert tconfig.Configuration.from_flags(parsed).spec_draft_path == \
            value
        return
    with pytest.raises(ValueError, match="not a checkpoint directory") as e:
        tconfig.Configuration.from_flags(parsed)
    assert item not in str(e.value)


def test_cli_worker_joins_a_jax_swarm_on_the_cpu(tmp_path):
    async def go():
        boot, dht = await new_host_and_dht(JKey.generate(),
                                           listen_host="127.0.0.1")
        env = dict(os.environ, CROWDLLAMA_TPU_WARMUP="0",
                   CROWDLLAMA_TPU_MAX_CONTEXT_LENGTH="256",
                   PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "crowdllama_tpu_torch.cli.main", "start",
            "--worker-mode", "--device", "cpu", "--model", "tiny-test",
            "--kv-page-size", "16", "--key-path", str(tmp_path),
            "--bootstrap-peers", f"127.0.0.1:{boot.listen_port}",
            cwd=str(tmp_path), env=env, stderr=asyncio.subprocess.PIPE)
        try:
            deadline = time.monotonic() + 90
            res = None
            while res is None:
                assert proc.returncode is None and time.monotonic() < deadline
                for c in dht.table.contacts():
                    raw = await dht.request_metadata(c)
                    if raw:
                        res = JResource.from_json(raw)
                await asyncio.sleep(0.2)
        finally:
            if proc.returncode is None:
                proc.send_signal(signal.SIGINT)
            err = await asyncio.wait_for(proc.stderr.read(), 60)
            rc = await asyncio.wait_for(proc.wait(), 60)
            await boot.close()
        return res, rc, err.decode()

    res, rc, err = asyncio.run(go())
    assert rc == 0, err[-2000:]
    assert (res.supported_models, res.worker_mode, res.accelerator) == (
        ["tiny-test"], True, "cpu")
    assert "shutting down" in err
