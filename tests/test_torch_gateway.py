"""The port's ``Gateway`` against the JAX ``Gateway``, on one swarm.

One topology serves the module (``asyncio.wait_for`` bounds it): a JAX
DHT bootstrap node, one port worker (``Peer`` over ``TorchEngine`` on
the CPU, on ``params_from_numpy`` of a ``testing/modelgen.py``
permutation checkpoint, as ``tests/test_torch_handle.py`` builds it),
and two consumers in front of it: a JAX ``Peer`` with its aiohttp
``Gateway``, and the port's consumer ``Peer`` with its ``Gateway`` on
the port's HTTP plane.

1. Every route of the Ollama and OpenAI surfaces goes to both gateways,
   one request at a time: greedy and seeded, streamed (NDJSON, SSE) and
   not, the metadata routes and the error bodies (unknown model, bad
   JSON, missing fields, an unsupported route, an unknown path and
   method).  The replies are equal field for field but ids, timestamps
   and durations; embeddings within 1e-5.
2. Shedding: with the admission cap at 1, a request sent while one is in
   flight gets 503 with a ``Retry-After`` in the jitter range of
   ``retry_after_s`` (``[base, 2 * base]`` whole seconds), on both.
3. A client that drops a stream: the gateway closes the worker stream
   and the worker's slot frees, behind either gateway.
4. A JAX worker joins.  Routing on the port gateway picks the port worker
   first; a hedge whose second leg dials slowly is won by the original
   exactly once, a stall of the port worker at its third chunk under
   ``stream_stall_ms`` and a drain at its third chunk each fail over to
   the JAX worker, and each text equals the undisturbed stream's.
"""

import asyncio
import json
import time

import pytest

aiohttp = pytest.importorskip("aiohttp")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_handle import COMMON, _perm  # noqa: E402

from crowdllama_tpu.config import Configuration as JConf  # noqa: E402
from crowdllama_tpu.config import Intervals as JIntervals  # noqa: E402
from crowdllama_tpu.engine.engine import FakeEngine as JFake  # noqa: E402
from crowdllama_tpu.engine.engine import JaxEngine  # noqa: E402
from crowdllama_tpu.gateway.gateway import Gateway as JGateway  # noqa: E402
from crowdllama_tpu.net.discovery import new_host_and_dht  # noqa: E402
from crowdllama_tpu.peer.peer import Peer as JPeer  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch import native  # noqa: E402
from crowdllama_tpu_torch.config import Configuration as TConf  # noqa: E402
from crowdllama_tpu_torch.core import wire as twire  # noqa: E402
from crowdllama_tpu_torch.core.messages import (  # noqa: E402
    create_generate_request,
)
from crowdllama_tpu_torch.core.protocol import (  # noqa: E402
    INFERENCE_PROTOCOL,
)
from crowdllama_tpu_torch.engine.engine import FakeEngine  # noqa: E402
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.weights import (  # noqa: E402
    params_from_numpy,
)
from crowdllama_tpu_torch.gateway.gateway import Gateway  # noqa: E402
from crowdllama_tpu_torch.peer.peer import Peer as TPeer  # noqa: E402
from crowdllama_tpu_torch.testing import faults  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

DEADLINE = 150.0
EMBED_ATOL = 1e-5
MODEL = "tiny-test"
MSGS = [{"role": "user", "content": "the quick brown fox"}]
SEEDED = {"temperature": 0.8, "seed": 1234}
# name -> (method, path, JSON body or raw bytes)
ROUTES = {
    "chat_greedy": ("POST", "/api/chat", {
        "messages": MSGS, "options": {"num_predict": 10}}),
    "chat_greedy_stream": ("POST", "/api/chat", {
        "messages": MSGS, "stream": True, "options": {"num_predict": 10}}),
    "chat_seeded": ("POST", "/api/chat", {
        "messages": MSGS, "options": {"num_predict": 12, **SEEDED}}),
    "chat_seeded_stream": ("POST", "/api/chat", {
        "messages": MSGS, "stream": True,
        "options": {"num_predict": 12, **SEEDED}}),
    "chat_stop": ("POST", "/api/chat", {
        "messages": MSGS, "options": {"num_predict": 12, "stop": "e"}}),
    "generate": ("POST", "/api/generate", {
        "prompt": "once upon a time", "options": {"num_predict": 8}}),
    "generate_stream": ("POST", "/api/generate", {
        "prompt": "once upon a time", "stream": True,
        "options": {"num_predict": 8, **SEEDED}}),
    "openai_chat": ("POST", "/v1/chat/completions", {
        "messages": MSGS, "max_tokens": 10, "temperature": 0}),
    "openai_chat_stream": ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user",
                      "content": [{"type": "text", "text": "the quick "},
                                  {"type": "text", "text": "brown fox"}]}],
        "max_tokens": 10, "stream": True, "temperature": 0.8, "seed": 7}),
    "openai_completion": ("POST", "/v1/completions", {
        "prompt": ["once upon a time"], "max_tokens": 8, "temperature": 0}),
    "openai_completion_stream": ("POST", "/v1/completions", {
        "prompt": "once upon a time", "max_tokens": 8, "stream": True,
        "temperature": 0.8, "seed": 3}),
    "embed": ("POST", "/api/embed", {
        "input": ["alpha", "a longer text to embed " * 3]}),
    "embeddings": ("POST", "/api/embeddings", {"prompt": "alpha"}),
    "openai_embeddings": ("POST", "/v1/embeddings", {"input": "alpha"}),
    "tags": ("GET", "/api/tags", None),
    "version": ("GET", "/api/version", None),
    "show": ("POST", "/api/show", {"name": MODEL}),
    "show_unknown": ("POST", "/api/show", {"model": "no-such-model"}),
    "ps": ("GET", "/api/ps", None),
    "health": ("GET", "/api/health", None),
    "openai_models": ("GET", "/v1/models", None),
    "pull_served": ("POST", "/api/pull", {"model": MODEL}),
    "pull_served_nostream": ("POST", "/api/pull", {"model": MODEL,
                                                   "stream": False}),
    "err_unknown_model": ("POST", "/api/chat", {
        "model": "no-such-model", "messages": MSGS}),
    "err_bad_json": ("POST", "/api/chat", b"{not json"),
    "err_missing_messages": ("POST", "/api/chat", {"messages": []}),
    "err_generate_no_prompt": ("POST", "/api/generate", {}),
    "err_embed_no_input": ("POST", "/api/embed", {"input": [1, 2]}),
    "err_openai_bad_json": ("POST", "/v1/chat/completions", b"{"),
    "err_openai_n2": ("POST", "/v1/chat/completions", {
        "messages": MSGS, "n": 2}),
    "err_openai_part": ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user",
                      "content": [{"type": "image_url"}]}]}),
    "err_openai_unknown_model": ("POST", "/v1/completions", {
        "model": "no-such-model", "prompt": "x"}),
    "err_unsupported": ("POST", "/api/delete", {"model": MODEL}),
    "err_unknown_path": ("GET", "/api/nothing", None),
    "err_wrong_method": ("GET", "/api/chat", None),
}
SKIP = {"id", "created", "created_at", "total_duration", "last_seen"}
LONG = {"model": MODEL, "stream": True,
        "messages": [{"role": "user", "content": "tell a long story"}],
        "options": {"num_predict": 24, **SEEDED}}
LONG_DROP = {"model": MODEL, "stream": True,
             "messages": [{"role": "user", "content": "go on and on"}],
             "options": {"num_predict": 200}}


def _decode(ctype: str, text: str):
    if ctype.startswith("application/x-ndjson"):
        return [json.loads(line) for line in text.splitlines() if line]
    if ctype.startswith("text/event-stream"):
        return [ev[len("data: "):] if ev == "data: [DONE]"
                else json.loads(ev[len("data: "):])
                for ev in text.split("\n\n") if ev]
    if ctype.startswith("application/json"):
        return json.loads(text)
    return text


async def _call(s, base: str, method: str, path: str, body) -> dict:
    kw = {}
    if isinstance(body, bytes):
        kw["data"] = body
    elif body is not None:
        kw["json"] = {"model": MODEL, **body}
    async with s.request(method, base + path, **kw) as r:
        ctype = r.headers.get("Content-Type", "")
        return {"status": r.status, "ctype": ctype.split(";")[0],
                "retry_after": r.headers.get("Retry-After"),
                "allow": r.headers.get("Allow"),
                "body": _decode(ctype, await r.text())}


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in SKIP}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


async def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _text(lines: list[dict]) -> str:
    return "".join(line["message"]["content"] for line in lines)


async def _drop_stream(port: int, body: dict) -> None:
    """Send a streamed chat, read two NDJSON lines, close the socket."""
    raw = json.dumps(body).encode()
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(b"POST /api/chat HTTP/1.1\r\nHost: g\r\nContent-Type: "
            b"application/json\r\nContent-Length: %d\r\n\r\n%s"
            % (len(raw), raw))
    await w.drain()
    await r.readuntil(b"\r\n\r\n")
    lines = 0
    while lines < 2:
        lines += (await r.readuntil(b"\n")).count(b'"done"')
    w.close()


async def _direct_stream(host, dht, worker_id: str, body: dict) -> list:
    """The GenerateRequest the gateway sends for ``body``, streamed
    straight to ``worker_id`` over a fresh secure stream: its frames."""
    o = body["options"]
    msg = create_generate_request(
        MODEL, messages=body["messages"], stream=True,
        max_tokens=o["num_predict"], temperature=o["temperature"],
        top_p=1.0, seed=o["seed"], repeat_penalty=1.0)
    s = await host.new_stream(await dht.find_peer(worker_id),
                              INFERENCE_PROTOCOL)
    try:
        await twire.write_length_prefixed_pb(s.writer, msg)
        frames = []
        while not frames or not frames[-1].done:
            m = await twire.read_length_prefixed_pb(s.reader, timeout=120)
            frames.append(m.generate_response)
        return frames
    finally:
        s.close()


def _idle(engine) -> bool:
    return all(s is None for s in engine.scheduler.slots)


async def _topology(tmp_path) -> dict:
    ckpt, flat = _perm(tmp_path)
    iv = JIntervals.default()
    boot, _ = await new_host_and_dht(JKey.generate(), listen_host="127.0.0.1")
    addr = f"127.0.0.1:{boot.listen_port}"
    node = dict(listen_host="127.0.0.1", bootstrap_peers=[addr])
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model=MODEL, warmup=False, **COMMON)
    tworker = TPeer(TKey.generate(), TConf(device="cpu", model=MODEL,
                                           **node, **COMMON), teng)
    jcons = JPeer(JKey.generate(), JConf(intervals=iv, **node),
                  engine=JFake(models=[]), worker_mode=False)
    tcons = TPeer(TKey.generate(), TConf(**node), FakeEngine(models=[]),
                  worker_mode=False)
    jgw = JGateway(jcons, port=0, host="127.0.0.1", retry_after_s=2.0)
    tgw = Gateway(tcons, port=0, host="127.0.0.1", retry_after_s=2.0)
    jeng = JaxEngine(JConf(model=MODEL, model_path=ckpt, warmup=False,
                           intervals=iv, **COMMON))
    jworker = JPeer(JKey.generate(), JConf(intervals=iv, **node, **COMMON),
                    engine=jeng, worker_mode=True)
    started = []
    out: dict = {"ids": {}}
    try:
        for part in (teng, tworker, jcons, tcons, jgw, tgw):
            await part.start()
            started.append(part)
        bases = {"jax": f"http://127.0.0.1:{jgw._runner.addresses[0][1]}",
                 "port": f"http://127.0.0.1:{tgw.port}"}
        gws = {"jax": jgw, "port": tgw}
        for cons in (jcons, tcons):
            await _wait(lambda: tworker.peer_id in {
                p.peer_id for p in cons.peer_manager.get_healthy_peers()},
                "the port worker")
        # Every request frame the port gateway sends, beside the codec's
        # encoding of its message.
        frames = out["request_frames"] = []
        forward = tgw._forward

        async def recording_forward(request, worker_id, msg, *a,
                                    frame=None, **kw):
            frames.append((frame, twire.encode_frame(msg)))
            return await forward(request, worker_id, msg, *a, frame=frame,
                                 **kw)

        tgw._forward = recording_forward
        envelope0 = native.stats()["calls"].get("envelope", 0)
        async with aiohttp.ClientSession() as s:
            # 1. Every route, to each gateway in turn.
            replies: dict = {"jax": {}, "port": {}}
            for name, (method, path, body) in ROUTES.items():
                if name in ("tags", "ps", "health", "openai_models"):
                    continue
                for k in ("jax", "port"):
                    replies[k][name] = await _call(s, bases[k], method,
                                                   path, body)
            # The metadata routes read the worker's advertised telemetry:
            # both consumers re-probe it while it idles.
            for cons in (jcons, tcons):
                await cons.peer_manager.perform_health_checks()
            for name in ("tags", "ps", "health", "openai_models"):
                method, path, body = ROUTES[name]
                for k in ("jax", "port"):
                    replies[k][name] = await _call(s, bases[k], method,
                                                   path, body)
            out["replies"] = replies
            del tgw._forward
            out["envelope_calls"] = (native.stats()["calls"].get(
                "envelope", 0) - envelope0)
            out["consumer_ids"] = {"jax": jcons.peer_id,
                                   "port": tcons.peer_id}

            # 2. Shedding at an admission cap of 1.
            shed = {}
            for k, gw in gws.items():
                gw.admission_max_inflight = 1
                first = asyncio.create_task(_call(
                    s, bases[k], "POST", "/api/chat", LONG))
                await _wait(lambda: gw._inflight == 1, "an admitted request")
                shed[k] = [await _call(s, bases[k], "POST", "/api/chat",
                                       LONG) for _ in range(3)]
                shed[k].append(await first)
                gw.admission_max_inflight = 0
            out["shed"] = shed

            # 3. A client drops its stream mid-flight.
            drops = {}
            for k, gw in gws.items():
                await _drop_stream(int(bases[k].rsplit(":", 1)[1]),
                                   LONG_DROP)
                t0 = time.monotonic()
                await _wait(lambda: _idle(teng), "the worker's slot to free")
                drops[k] = {"free_s": time.monotonic() - t0,
                            "robust": dict(gw._robust)}
            out["drops"] = drops

            # 4. A JAX worker joins; failover on the port gateway.
            for part in (jeng, jworker):
                await part.start()
                started.append(part)
            await _wait(lambda: jworker.peer_id in {
                p.peer_id for p in tcons.peer_manager.get_healthy_peers()},
                "the JAX worker")
            # Warm the JAX worker with the very request (and read it as a
            # second reference), straight over a secure stream.
            frames = await _direct_stream(tcons.host, tcons.dht,
                                          jworker.peer_id, LONG)
            out["jax_direct"] = "".join(f.response for f in frames)
            undisturbed = (await _call(s, bases["port"], "POST",
                                       "/api/chat", LONG))["body"]
            # Routing picks the port worker first (the failover target is
            # then the JAX worker, whatever their throughput scores say).
            find = tgw._find_worker

            def port_first(model, exclude=frozenset(), **kw):
                if tworker.peer_id not in exclude:
                    w = find(model, exclude=exclude | {jworker.peer_id},
                             **kw)
                    if w is not None:
                        return w
                return find(model, exclude=exclude, **kw)

            tgw._find_worker = port_first
            fo = {"undisturbed": undisturbed,
                  "ids": {"torch": tworker.peer_id, "jax": jworker.peer_id}}
            # Hedge: the second leg's dial waits 1.5 s; the original wins.
            tgw.hedge_ttft_ms = 1.0
            plan = faults.FaultPlan(rules=[faults.FaultRule(
                site="host.new_stream", action="delay", delay_s=1.5,
                match={"peer": jworker.peer_id,
                       "protocol": INFERENCE_PROTOCOL})])
            with faults.installed(plan):
                fo["hedge"] = (await _call(s, bases["port"], "POST",
                                           "/api/chat", LONG))["body"]
            tgw.hedge_ttft_ms = 0.0
            fo["hedge_robust"] = dict(tgw._robust)
            fo["hedge_log"] = list(plan.log)
            await _wait(lambda: _idle(teng), "the hedge's slots")
            # Stall at the third chunk.  The injected stall never writes
            # again, so the budget costs only its own wait: 8 s keeps it
            # well above the slowest undisturbed chunk, and the JAX
            # worker's first chunk after the failover, on a loaded CPU.
            tgw.stream_stall_ms = 8000.0
            plan = faults.FaultPlan(rules=[faults.FaultRule(
                site="engine.stream_chunk", action="stall_stream", after=2,
                match={"worker": tworker.peer_id})])
            # The quarantine is read when it happens: the consumer's health
            # loop re-fetches the worker's metadata and replaces its
            # Resource, which can lift the mark before the chat returns.
            pm = tcons.peer_manager
            mark = pm.mark_draining
            marks = []

            def recording_mark(peer_id, reason="drain"):
                accepted = mark(peer_id, reason)
                marks.append((peer_id, reason, accepted))
                return accepted

            pm.mark_draining = recording_mark
            try:
                with faults.installed(plan):
                    fo["stall"] = (await _call(s, bases["port"], "POST",
                                               "/api/chat", LONG))["body"]
            finally:
                del pm.mark_draining
            tgw.stream_stall_ms = 0.0
            fo["stall_log"] = list(plan.log)
            fo["stall_robust"] = dict(tgw._robust)
            fo["wedged"] = [(pid, reason) for pid, reason, accepted in marks
                            if accepted]
            # The port worker never drained: a re-probe lifts the wedge.
            await tcons.peer_manager.perform_health_checks()
            # Drain at the third chunk: the stream migrates.
            plan = faults.FaultPlan(rules=[faults.FaultRule(
                site="engine.stream_chunk", action="drain", after=2,
                match={"worker": tworker.peer_id})])
            with faults.installed(plan):
                fo["drain"] = (await _call(s, bases["port"], "POST",
                                           "/api/chat", LONG))["body"]
            fo["drain_log"] = list(plan.log)
            fo["draining"] = tworker.resource.draining
            fo["drain_robust"] = dict(tgw._robust)
            fo["migrated_streams"] = tgw.obs.metrics.migrated_streams
            out["failover"] = fo
    finally:
        for part in reversed(started):
            await part.stop()
        await boot.close()
    return out


@pytest.fixture(scope="module")
def swarm(tmp_path_factory):
    return asyncio.run(asyncio.wait_for(
        _topology(tmp_path_factory.mktemp("gw")), DEADLINE))


def _embeddings(name: str, body) -> list:
    if name == "embed":
        return body["embeddings"]
    if name == "embeddings":
        return [body["embedding"]]
    return [d["embedding"] for d in body["data"]]


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_answers_as_the_jax_gateway(swarm, name):
    got = swarm["replies"]["port"][name]
    want = swarm["replies"]["jax"][name]
    assert got["status"] == want["status"], (got, want)
    assert (got["ctype"], got["allow"]) == (want["ctype"], want["allow"])
    g, w = got["body"], want["body"]
    if name in ("embed", "embeddings", "openai_embeddings"):
        ge, we = _embeddings(name, g), _embeddings(name, w)
        assert len(ge) == len(we) > 0
        for a, b in zip(ge, we):
            assert len(a) == len(b) > 0
            assert max(abs(x - y) for x, y in zip(a, b)) <= EMBED_ATOL
        strip = {"embeddings", "embedding", "data"}
        g = {k: v for k, v in g.items() if k not in strip}
        w = {k: v for k, v in w.items() if k not in strip}
    if name == "health":
        assert g["peer_id"] == swarm["consumer_ids"]["port"]
        assert w["peer_id"] == swarm["consumer_ids"]["jax"]
        g, w = dict(g, peer_id=""), dict(w, peer_id="")
    assert _strip(g) == _strip(w)


def test_streams_carry_the_whole_reply(swarm):
    r = swarm["replies"]["port"]
    for name in ("chat_greedy", "chat_seeded"):
        lines = r[name + "_stream"]["body"]
        assert lines[-1]["done"] and lines[-1]["eval_count"] > 0
        assert _text(lines) == r[name]["body"]["message"]["content"]
    sse = r["openai_chat_stream"]["body"]
    assert sse[-1] == "[DONE]"
    assert sse[0]["choices"][0]["delta"]["role"] == "assistant"
    assert len({ev["id"] for ev in sse[:-1]}) == 1
    assert sse[-2]["choices"][0]["finish_reason"] in ("stop", "length")


def test_request_frames_are_the_native_encoders(swarm):
    """With the native library loaded, every generate request the port
    gateway forwards was encoded by the native request encoder, in the
    codec's bytes, and the served frames went through the native
    envelope (the worker's reply frames, the gateway's decode)."""
    frames = swarm["request_frames"]
    assert frames
    for frame, codec in frames:
        assert frame == (codec if native.native_enabled() else None)
    if native.native_enabled():
        assert swarm["envelope_calls"] > len(frames)


@pytest.mark.parametrize("gw", ["jax", "port"])
def test_shed_503_with_jittered_retry_after(swarm, gw):
    replies = swarm["shed"][gw]
    shed, admitted = replies[:-1], replies[-1]
    assert admitted["status"] == 200
    for r in shed:
        assert r["status"] == 503
        assert 2 <= int(r["retry_after"]) <= 4
        assert "admission cap 1" in r["body"]["error"]
    assert _strip(swarm["shed"]["port"][0]["body"]) == _strip(
        swarm["shed"]["jax"][0]["body"])


@pytest.mark.parametrize("gw", ["jax", "port"])
def test_client_drop_frees_the_workers_slot(swarm, gw):
    d = swarm["drops"][gw]
    assert d["free_s"] < 20.0
    if gw == "port":
        assert d["robust"]["failovers"] == 0


def test_hedge_original_wins_exactly_once(swarm):
    fo = swarm["failover"]
    text = _text(fo["undisturbed"])
    assert text and text == swarm["jax_direct"]
    assert fo["undisturbed"][-1]["worker_id"] == fo["ids"]["torch"]
    lines = fo["hedge"]
    assert [line["done"] for line in lines].count(True) == 1
    assert _text(lines) == text
    assert lines[-1]["worker_id"] == fo["ids"]["torch"]
    r = fo["hedge_robust"]
    assert (r["hedge_launched"], r["hedge_won"], r["hedge_cancelled"]) == (
        1, 0, 1)
    assert fo["hedge_log"]


def test_stall_fails_over_to_the_jax_worker(swarm):
    fo = swarm["failover"]
    lines = fo["stall"]
    assert fo["stall_log"] and fo["stall_log"][0][2] == "stall_stream"
    assert _text(lines) == _text(fo["undisturbed"])
    assert lines[-1]["done"] and "error" not in lines[-1]
    assert lines[-1]["done_reason"] == fo["undisturbed"][-1]["done_reason"]
    assert lines[-1]["worker_id"] == fo["ids"]["jax"]
    r = fo["stall_robust"]
    assert (r["stalled_streams"], r["wedge_quarantines"]) == (1, 1)
    assert fo["wedged"] == [(fo["ids"]["torch"], "wedged")]


def test_drain_fails_over_to_the_jax_worker(swarm):
    fo = swarm["failover"]
    lines = fo["drain"]
    assert fo["drain_log"] and fo["draining"]
    assert _text(lines) == _text(fo["undisturbed"])
    assert lines[-1]["worker_id"] == fo["ids"]["jax"]
    assert fo["migrated_streams"] == 1
    assert fo["drain_robust"]["failovers"] == fo["stall_robust"][
        "failovers"] + 1
