"""The port's request seams (``Engine.handle`` /
``handle_streaming_frames``), drain and migrate, and ``MultiEngine``,
against the JAX package.

``JaxEngine`` and ``TorchEngine`` serve the permutation checkpoint
(``testing/modelgen.py``; page 16, a small step budget so long prompts
take the ragged path) and answer the same llama.v1 requests, each request
encoded once by protobuf and decoded by each package's own codec:
greedy, seeded (temperature 0.8 seed 1234; 1.1 with top-k 20 and top-p
0.9 on a chunked long prompt), a chat request, stop strings and an
EmbedRequest.  Replies are equal field by field but ``created_at`` and
``total_duration`` (embedding vectors within 1e-5, as
``test_torch_contiguous.py`` holds the runners); streamed frames are as
many, with the same text; the sampled streams' token ids are equal.  The
seeded requests run on both KV layouts.

``migrate`` mid-stream ends each stream in a MigrateFrame whose
``delivered_tokens`` is what it streamed and whose chain hashes are the
JAX runner's ``chain_keys_for_prompt``; slots and pages are freed with
the prompt pages left in the prefix index; new requests are refused with
JAX's message; ``drain`` is True idle and False on timeout.  The same
through ``MultiEngine`` with two children.
"""

import asyncio
import contextvars
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu.core import messages as jmessages  # noqa: E402
from crowdllama_tpu.core import wire as jwire  # noqa: E402
from crowdllama_tpu.engine.paged import (  # noqa: E402
    PagedModelRunner as JaxPagedRunner,
)
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.core import llama_v1 as tpb  # noqa: E402
from crowdllama_tpu_torch.core import wire as twire  # noqa: E402
from crowdllama_tpu_torch.core.messages import (  # noqa: E402
    create_embed_request,
    create_generate_request,
)
from crowdllama_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from crowdllama_tpu_torch.engine.multi import MultiEngine  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402

EMBED_ATOL = 1e-5
LONG = "a long seeded prompt that is admitted in chunks " * 2
GREEDY = "the quick brown fox jumps over"
REQUESTS = {
    "greedy": dict(prompt=GREEDY, max_tokens=10),
    "seeded": dict(prompt="seeded", max_tokens=12, temperature=0.8,
                   seed=1234),
    "seeded_long": dict(prompt=LONG, max_tokens=12, temperature=1.1,
                        seed=2**40 + 3, top_k=20, top_p=0.9),
    "chat": dict(messages=[{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "say abc"}],
                 max_tokens=10),
    "stop": dict(prompt="count from abc", max_tokens=12, stop=["ghi", "x"]),
    "embed": None,
}
EMBED_INPUTS = ["alpha", "a longer text to embed " * 3, ""]
SEEDED = ("seeded", "seeded_long")

# Token ids the running stream's decoder was fed (per asyncio task).
_IDS: contextvars.ContextVar = contextvars.ContextVar("ids", default=None)


class _Recorder:
    """Tokenizer proxy appending every decoded token id to ``_IDS``."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), _IDS.get()

        class _Dec:
            def feed(self, token_id):
                if ids is not None:
                    ids.append(int(token_id))
                return dec.feed(token_id)

        return _Dec()


def _payload(name: str) -> bytes:
    """The request as protobuf encodes it (the JAX package's messages)."""
    if name == "embed":
        msg = jmessages.create_embed_request("tiny-test", EMBED_INPUTS)
    else:
        msg = jmessages.create_generate_request("tiny-test",
                                                **REQUESTS[name])
    return msg.SerializeToString()


def _fields(msg, skip=("created_at", "total_duration")) -> dict:
    """A reply's fields as plain values (either package's messages), but
    the timestamp and the duration."""
    arm = msg.WhichOneof("message")
    sub = getattr(msg, arm)
    out = {"arm": arm, "trace_id": msg.trace_id}
    for name in [f.name for f in tpb.MESSAGES[
            f"llama.v1.{type(sub).__name__}"].FIELDS]:
        if name in skip:
            continue
        v = getattr(sub, name)
        if name == "embeddings":
            v = [list(e.values) for e in v]
        elif isinstance(v, (list, tuple)) or hasattr(v, "extend"):
            v = list(v)
        out[name] = v
    return out


def _perm(tmp_path):
    from crowdllama_tpu.testing.modelgen import (
        permutation_checkpoint,
        permutation_params,
    )

    ckpt = permutation_checkpoint("tiny-test", tmp_path / "perm",
                                  max_context=256)
    flat = _flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=256)))
    return ckpt, flat


COMMON = dict(max_context_length=256, kv_page_size=16, step_token_budget=36,
              max_batch_slots=4)


def _engines(ckpt, flat, **kw):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine

    jeng = JaxEngine(Configuration(model="tiny-test", model_path=ckpt,
                                   warmup=False, intervals=Intervals.default(),
                                   **COMMON, **kw))
    teng = TorchEngine(device="cpu", params=params_from_numpy(
        flat, dtype=torch.bfloat16), model="tiny-test", warmup=False,
        **COMMON, **kw)
    return jeng, teng


async def _serve(engine, decode, names) -> dict:
    """Each request through ``handle`` and ``handle_streaming_frames``:
    name -> (reply, token ids, streamed frames, token ids)."""
    engine.tokenizer = _Recorder(engine.tokenizer)
    out = {}
    for name in names:
        ids: list[int] = []
        _IDS.set(ids)
        reply = await engine.handle(decode(_payload(name)), worker_id="w")
        frames, stream_ids = [], []
        if name != "embed":
            _IDS.set(stream_ids)
            async for frame in engine.handle_streaming_frames(
                    decode(_payload(name)), worker_id="w"):
                frames.append(decode(frame[4:]))
        out[name] = (reply, ids, frames, stream_ids)
    return out


def _run_both(tmp_path, names, **kw) -> tuple[dict, dict]:
    ckpt, flat = _perm(tmp_path)
    jeng, teng = _engines(ckpt, flat, **kw)

    async def go(engine, decode, runner_attr):
        await engine.start()
        try:
            getattr(engine, runner_attr).prefill_chunk = 32
            return await _serve(engine, decode, names)
        finally:
            await engine.stop()

    want = asyncio.run(go(jeng, jwire.decode_payload, "_runner"))
    got = asyncio.run(go(teng, twire.decode_payload, "runner"))
    return want, got


@pytest.fixture(scope="module")
def paged_replies(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("paged"), list(REQUESTS))


@pytest.fixture(scope="module")
def contiguous_replies(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("contiguous"), list(SEEDED),
                     kv_layout="contiguous")


def _check_reply(want, got, name):
    wreply, wids, wframes, wsids = want[name]
    treply, tids, tframes, tsids = got[name]
    w, t = _fields(wreply), _fields(treply)
    if name == "embed":
        wv, tv = w.pop("embeddings"), t.pop("embeddings")
        assert len(wv) == len(tv) == len(EMBED_INPUTS)
        np.testing.assert_allclose(np.array(tv), np.array(wv),
                                   atol=EMBED_ATOL, rtol=0)
    assert t == w
    assert tids == wids
    assert [_fields(f) for f in tframes] == [_fields(f) for f in wframes]
    assert tsids == wsids
    if name != "embed":
        assert tframes[-1].generate_response.done
        assert "".join(f.generate_response.response for f in tframes) == (
            t["response"])


@pytest.mark.parametrize("name", list(REQUESTS))
def test_handle_replies_match_jax_engine(paged_replies, name):
    want, got = paged_replies
    _check_reply(want, got, name)
    reply = _fields(got[name][0])
    if name == "stop":
        assert reply["done_reason"] == "stop" and reply["response"] == "def"
    elif name != "embed":
        assert reply["completion_tokens"] == REQUESTS[name]["max_tokens"]
    if name in SEEDED:
        assert len(set(got[name][1])) > 2  # really sampled


@pytest.mark.parametrize("name", SEEDED)
def test_seeded_frames_match_jax_engine_contiguous(contiguous_replies, name):
    want, got = contiguous_replies
    _check_reply(want, got, name)
    assert got[name][1] == got[name][3]  # handle and stream drew alike


def test_seeded_request_float_fields_are_float32():
    """The sampled requests' floats reach generate() as the float32 values
    protobuf reads, on both packages."""
    seen = {}

    class _Probe(TorchEngine):
        def generate(self, prompt, **kw):
            seen.update(kw)
            raise StopAsyncIteration

    probe = _Probe(device="cpu", model="tiny-test")
    with pytest.raises(StopAsyncIteration):
        probe._gen_from_request(
            twire.decode_payload(_payload("seeded_long")).generate_request)
    ref = jwire.decode_payload(_payload("seeded_long")).generate_request
    assert (seen["temperature"], seen["top_p"]) == (ref.temperature,
                                                    ref.top_p)
    assert seen["temperature"] != 1.1 and seen["seed"] == 2**40 + 3


# ------------------------------------------------------- drain / migrate

def _tiny(**kw):
    base = dict(model="tiny-test", max_context_length=256, kv_page_size=16,
                max_batch_slots=4, warmup=False)
    base.update(kw)
    return TorchEngine(device="cpu", dtype=torch.float32, **base)


def _idle(runner) -> bool:
    """No slot holds pages, and every page is free or prefix-cached."""
    cached = set(runner._page_key)
    return (not runner._slot_pages
            and len(set(runner._free_pages) | cached) == runner.total_pages)


async def _stream_until(engine, prompts, model, frames_before=4):
    """Start one stream per prompt; migrate once each has ``frames_before``
    frames; returns (moved, {i: (frames, token ids)})."""
    frames: dict[int, list] = {i: [] for i in range(len(prompts))}
    ids: dict[int, list] = {i: [] for i in range(len(prompts))}

    async def run(i, prompt):
        _IDS.set(ids[i])
        msg = create_generate_request(model, prompt, max_tokens=200)
        msg.trace_id = f"trace-{i}"
        async for frame in engine.handle_streaming_frames(msg, "worker-a"):
            frames[i].append(twire.decode_payload(frame[4:]))

    tasks = [asyncio.create_task(run(i, p)) for i, p in enumerate(prompts)]
    while not all(len(f) >= frames_before for f in frames.values()):
        assert not any(t.done() for t in tasks), "a stream ended early"
        await asyncio.sleep(0.005)
    moved = await engine.migrate()
    await asyncio.wait_for(asyncio.gather(*tasks), 30)
    return moved, {i: (frames[i], ids[i]) for i in frames}


def _jax_chain_keys(ids: list[int], page_size: int) -> list[bytes]:
    """JAX's ``PagedModelRunner.chain_keys_for_prompt`` (host hashing
    only: a runner with just its page size)."""
    r = types.SimpleNamespace(page_size=page_size)
    r._chain_keys = types.MethodType(JaxPagedRunner._chain_keys, r)
    return JaxPagedRunner.chain_keys_for_prompt(r, ids)


PROMPTS = ["abc abc abc abc abc abc abc abc abc a",   # 38 tokens: 2 pages
           "the second stream's prompt, a",
           "a third one that is rather longer than the page size, a"]


def _check_migrated(engine, out, model="tiny-test"):
    tok = engine.tokenizer
    for i, (frames, ids) in out.items():
        *text, last = frames
        assert len(text) >= 4
        assert all(f.WhichOneof("message") == "generate_response"
                   and not f.generate_response.done for f in text)
        assert last.WhichOneof("message") == "migrate_frame"
        mf = last.migrate_frame
        prompt = PROMPTS[i]
        assert (mf.model, mf.worker_id, mf.reason, last.trace_id) == (
            model, "worker-a", "drain", f"trace-{i}")
        assert mf.delivered_tokens == len(ids) >= len(text)
        prompt_ids = tok.encode(prompt)
        assert mf.prompt_tokens == len(prompt_ids)
        assert mf.page_size == 16
        assert list(mf.chain_hashes) == _jax_chain_keys(prompt_ids, 16)
        assert len(mf.chain_hashes) == (len(prompt_ids) - 1) // 16


async def _check_drained(engine) -> None:
    r = engine.runner
    assert all(s is None for s in engine.scheduler.slots)
    assert _idle(r)
    for p in PROMPTS:  # the prompts' full pages stay indexed
        for key in r.chain_keys_for_prompt(engine.tokenizer.encode(p)):
            assert key in r._prefix_index
    for call in (engine.handle(create_generate_request("tiny-test", "x")),
                 engine.embed(["x"])):
        with pytest.raises(RuntimeError,
                           match="^worker is draining for shutdown$"):
            await call
    assert await engine.drain(timeout=1.0)


@pytest.mark.parametrize("ragged", [True, False])
async def test_migrate_mid_stream_retires_every_stream(ragged):
    engine = _tiny(ragged_prefill=ragged)
    await engine.start()
    engine.tokenizer = _Recorder(engine.tokenizer)
    try:
        moved, out = await _stream_until(engine, PROMPTS, "tiny-test")
        assert moved == len(PROMPTS)
        _check_migrated(engine, out)
        await _check_drained(engine)
    finally:
        await engine.stop()


@pytest.mark.parametrize("ragged", [True, False])
async def test_migrate_retires_chunked_deferred_and_pending_requests(ragged):
    """Requests not yet in a slot (a long prompt mid-chunked-admission,
    ragged or legacy, one deferred behind it, one pending) also end with
    "migrate", and the chunked admission's pages are freed."""
    engine = _tiny(max_batch_slots=2, step_token_budget=18,
                   ragged_prefill=ragged)
    await engine.start()
    try:
        r = engine.runner
        assert r.ragged_chunk == 16
        r.prefill_chunk = 16
        long = "x" * 200
        reqs = {}

        async def run(name, prompt):
            reasons = []
            async for chunk in engine.generate(prompt, max_tokens=200):
                reasons.append(chunk.done_reason)
            reqs[name] = reasons[-1]

        tasks = [asyncio.create_task(run("short", "abc"))]
        while engine.scheduler.tokens_generated < 1:
            await asyncio.sleep(0.005)
        tasks += [asyncio.create_task(run(n, p)) for n, p in (
            ("long", long), ("deferred", long + "y"), ("pending", "q"))]
        while engine.scheduler._chunking is None:
            await asyncio.sleep(0.001)
        job = engine.scheduler._chunking[2]
        assert getattr(job, "ragged", False) == ragged
        moved = await engine.migrate()
        await asyncio.wait_for(asyncio.gather(*tasks), 30)
        assert reqs == dict.fromkeys(reqs, "migrate") and len(reqs) == 4
        assert moved == 4
        assert engine.scheduler._chunking is None
        assert engine.scheduler._admitting == 0
        assert _idle(r)
    finally:
        await engine.stop()


async def test_drain_true_when_idle_false_on_timeout_with_a_live_stream():
    engine = _tiny()
    await engine.start()
    try:
        assert await engine.drain(timeout=0.5)
        engine.scheduler.start()  # serving again
        gen = engine.generate("abc", max_tokens=200)
        await gen.__anext__()
        assert not await engine.drain(timeout=0.3)
        with pytest.raises(RuntimeError, match="draining"):
            await engine.handle(create_generate_request("tiny-test", "x"))
        await gen.aclose()  # the client goes away: its slot frees
        assert await engine.drain(timeout=5.0)
    finally:
        await engine.stop()


async def test_embed_and_describe():
    engine = _tiny()
    assert "embeddings" not in engine.describe()
    await engine.start()
    try:
        assert engine.describe()["embeddings"] is True
        reply = await engine.handle(create_embed_request(
            "tiny-test", ["alpha", "x" * 300]), worker_id="w")
        er = reply.embed_response
        assert (er.model, er.worker_id, er.error) == ("tiny-test", "w", "")
        assert er.prompt_tokens == 6 + 255
        want = engine.runner.embed_prompts(
            [engine.tokenizer.encode("alpha"),
             engine.tokenizer.encode("x" * 300)[:255]])
        got = np.array([list(e.values) for e in er.embeddings])
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        with pytest.raises(ValueError, match="truncate=false"):
            await engine.embed(["x" * 300], truncate=False)
        with pytest.raises(ValueError, match="not served"):
            await engine.embed(["x"], model="other")
    finally:
        await engine.stop()


async def test_capture_profile_writes_a_chrome_trace(tmp_path):
    import json

    engine = _tiny()
    with pytest.raises(RuntimeError, match="profiling disabled"):
        await engine.capture_profile(0.1)
    engine = _tiny(profile_dir=str(tmp_path))
    await engine.start()
    try:
        gen = engine.generate("abc", max_tokens=40)
        await gen.__anext__()
        out = await engine.capture_profile(0.2)
        await gen.aclose()
    finally:
        await engine.stop()
    assert out.startswith(str(tmp_path / "plugins" / "profile"))
    (trace,) = list((tmp_path / "plugins" / "profile").rglob(
        "*.pt.trace.json"))
    assert str(trace.parent) == out
    assert "traceEvents" in json.loads(trace.read_text())


async def test_capture_profile_traces_the_dispatch_thread(tmp_path):
    """The session opens and closes on the scheduler's dispatch thread, so
    the trace holds the operators that thread runs while a stream
    decodes; a stopped engine's scheduler refuses ``on_dispatch_thread``
    and its profile comes from a worker thread."""
    import json
    import threading

    engine = _tiny(profile_dir=str(tmp_path))
    await engine.start()
    try:
        name = await engine.scheduler.on_dispatch_thread(
            lambda: threading.current_thread().name)
        assert name.startswith("torch-dispatch")
        tid = await engine.scheduler.on_dispatch_thread(threading.get_native_id)
        gen = engine.generate("abc", max_tokens=200)
        await gen.__anext__()
        out = await engine.capture_profile(0.3)
        rest = [c async for c in gen]
    finally:
        await engine.stop()
    assert rest and rest[-1].done
    with pytest.raises(RuntimeError, match="not started"):
        await engine.scheduler.on_dispatch_thread(threading.get_ident)
    idle = await engine.capture_profile(0.1)
    traces = sorted((tmp_path / "plugins" / "profile").rglob(
        "*.pt.trace.json"))
    assert sorted(str(t.parent) for t in traces) == sorted([out, idle])
    trace = next(t for t in traces if str(t.parent) == out)
    ops = [e for e in json.loads(trace.read_text())["traceEvents"]
           if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops and {e["tid"] for e in ops} == {tid}


# ----------------------------------------------------------- MultiEngine

async def test_multi_engine_routes_drains_and_migrates():
    from crowdllama_tpu_torch.config import Configuration

    cfg = Configuration(model="tiny-test, tiny-test-qwen2",
                        max_context_length=256, kv_page_size=16,
                        max_batch_slots=4, warmup=False)
    multi = MultiEngine(cfg, device="cpu", dtype=torch.float32)
    assert multi.models == ["tiny-test", "tiny-test-qwen2"]
    await multi.start()
    try:
        for eng in multi._engines.values():
            eng.tokenizer = _Recorder(eng.tokenizer)
        for model in multi.models:
            reply = await multi.handle(create_generate_request(
                model, "hello", max_tokens=5))
            gr = reply.generate_response
            assert (gr.model, gr.completion_tokens) == (model, 5)
            want = await multi._engines[model].handle(
                create_generate_request(model, "hello", max_tokens=5))
            assert gr.response == want.generate_response.response
        for bad, match in (("", "model is required"),
                           ("nope", "not served")):
            with pytest.raises(ValueError, match=match):
                await multi.handle(create_generate_request(bad, "x"))
        vecs, n = await multi.embed(["a", "b"], model="tiny-test-qwen2")
        assert len(vecs) == 2 and n == 4
        d = multi.describe()
        assert d["embeddings"] and set(d["engines"]) == set(multi.models)

        frames = {}
        tasks = {m: asyncio.create_task(_collect(multi, m, frames))
                 for m in multi.models}
        while not all(len(v) >= 4 for v in frames.values()) or len(
                frames) < 2:
            await asyncio.sleep(0.005)
        assert await multi.migrate() == 2
        await asyncio.wait_for(asyncio.gather(*tasks.values()), 30)
        for model, got in frames.items():
            last = got[-1]
            assert last.WhichOneof("message") == "migrate_frame"
            assert last.migrate_frame.model == model
            assert list(last.migrate_frame.chain_hashes) == _jax_chain_keys(
                multi._engines[model].tokenizer.encode(PROMPTS[0]), 16)
        for eng in multi._engines.values():
            assert _idle(eng.runner)
        with pytest.raises(RuntimeError, match="draining"):
            await multi.embed(["x"], model="tiny-test")
        assert await multi.drain(timeout=1.0)
    finally:
        await multi.stop()


async def _collect(engine, model, frames):
    frames[model] = got = []
    msg = create_generate_request(model, PROMPTS[0], max_tokens=200)
    async for frame in engine.handle_streaming_frames(msg, "w"):
        got.append(twire.decode_payload(frame[4:]))
