"""Pipeline stages of the port (``engine/shard_service.py``) against the
JAX package's.

- Tensor frames: the bytes ``write_tensor`` writes equal JAX's (header key
  order, dtype strings, the big-endian length), and each package's
  ``read_tensor`` reads the other's frames back exactly.
- ``ShardStageRunner``: prefill, decode and the verify window of one
  stage against JAX's runner on the same fp32 weights and activations
  (seeded numpy), within 1e-4: ``tiny-test``, and ``tiny-test-gemma``
  (softcaps, post-norms, alternating sliding windows) with stages of one
  layer, where slicing the windows by local instead of global layer index
  would swap them, and a prompt longer than the window.
- ``SwarmPipeline``: last-position prefill logits, decode logits and
  verify logits of a two-stage pipeline, the second stage behind a real
  authenticated loopback stream, against JAX's pipeline (1e-4); then
  mixed: the port's pipeline over a JAX stage service and JAX's pipeline
  over the port's stage service, equal to the all-JAX logits.
- ``ShardStageService``: the same error and ``info`` replies as JAX's
  service for an unknown session, an unknown op and a missing field; a
  closed stream releases the sessions prefilled over it.

Every networked test is bounded by ``asyncio.wait_for``.
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.core.protocol import SHARD_PROTOCOL  # noqa: E402
from crowdllama_tpu.engine import shard_service as JS  # noqa: E402
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.net import host as jhost  # noqa: E402
from crowdllama_tpu.utils.crypto_compat import (  # noqa: E402
    Ed25519PrivateKey as JKey,
)
from crowdllama_tpu_torch.engine import shard_service as TS  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.net import host as thost  # noqa: E402
from crowdllama_tpu_torch.utils.crypto import (  # noqa: E402
    Ed25519PrivateKey as TKey,
)

RTOL = ATOL = 1e-4  # fp32 on both sides, sums in another order
MAX_SEQ = 128
DEADLINE = 120.0


def weights(model: str, seed: int = 0, **over):
    """(JAX cfg, port cfg, JAX fp32 params, the port's copy of them)."""
    jcfg = j_get_config(model, max_context_length=MAX_SEQ, **over)
    cfg = get_config(model, max_context_length=MAX_SEQ, **over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(_flatten_params(jp))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


class Sink:
    """A StreamWriter stand-in that keeps the bytes written to it."""

    def __init__(self):
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data

    async def drain(self) -> None:
        pass


def reader_of(data: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    return r


async def serve(handler, package: str):
    """A host of ``package`` ("jax" or "torch") on 127.0.0.1 serving
    ``handler`` on SHARD_PROTOCOL."""
    if package == "jax":
        h = jhost.Host(JKey.generate(), listen_host="127.0.0.1")
    else:
        h = thost.Host(TKey.generate(), listen_host="127.0.0.1")
    h.set_stream_handler(SHARD_PROTOCOL, handler)
    await h.start()
    return h


async def dial(server, package: str):
    """(client host, stream) from a fresh host of ``package`` to
    ``server``'s SHARD_PROTOCOL."""
    mod, key = (jhost, JKey) if package == "jax" else (thost, TKey)
    client = mod.Host(key.generate(), listen_host="127.0.0.1")
    await client.start()
    contact = mod.Contact(server.peer_id, "127.0.0.1", server.listen_port)
    return client, await client.new_stream(contact, SHARD_PROTOCOL)


# ----------------------------------------------------------- tensor frames

FRAMES = {
    "act_prefill": np.random.default_rng(0).standard_normal(
        (1, 16, 64)).astype(np.float32),
    "act_decode": np.random.default_rng(1).standard_normal(
        (1, 64)).astype(np.float32),
    "expert_ids": np.asarray([3, 1, 0, 2, 2], np.int32),
    "transposed": np.random.default_rng(2).standard_normal(
        (5, 3)).astype(np.float32).T,
    "empty": np.zeros((0, 64), np.float32),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_tensor_frames_are_bytes_equal_to_jax(name):
    arr = FRAMES[name]

    async def go():
        tsink, jsink = Sink(), Sink()
        await TS.write_tensor(tsink, arr)
        await JS.write_tensor(jsink, arr)
        assert bytes(tsink.buf) == bytes(jsink.buf)
        # Each package reads the other's frame.
        for read, buf in ((TS.read_tensor, jsink.buf),
                          (JS.read_tensor, tsink.buf)):
            got = await read(reader_of(bytes(buf)), timeout=5.0)
            assert got.dtype == arr.dtype and got.shape == arr.shape
            np.testing.assert_array_equal(got, arr)

    asyncio.run(go())
    assert TS.MAX_TENSOR_BYTES == JS.MAX_TENSOR_BYTES
    assert TS.STAGE_CALL_TIMEOUT == JS.STAGE_CALL_TIMEOUT
    assert TS.STREAM_IDLE_TIMEOUT == JS.STREAM_IDLE_TIMEOUT


def test_oversized_tensor_frames_are_refused_alike():
    import struct

    async def go():
        sink = Sink()
        await JS.write_tensor(sink, np.zeros((2,), np.float32))
        hdr_len = struct.unpack(">I", bytes(sink.buf[:4]))[0]
        forged = bytearray(sink.buf[:4 + hdr_len])
        forged += struct.pack(">I", TS.MAX_TENSOR_BYTES + 1)
        errs = []
        for read in (TS.read_tensor, JS.read_tensor):
            with pytest.raises(ValueError) as e:
                await read(reader_of(bytes(forged)))
            errs.append(str(e.value))
        assert errs[0] == errs[1]

    asyncio.run(go())


# ------------------------------------------------------------ stage runner

STAGES = [("tiny-test", 1, 2), ("tiny-test-gemma", 0, 2),
          ("tiny-test-gemma", 1, 4), ("tiny-test-gemma", 2, 4)]


@pytest.mark.parametrize("model,index,count", STAGES)
def test_stage_runner_matches_jax(model, index, count):
    jcfg, cfg, jp, tp = weights(model, seed=index)
    jr = JS.ShardStageRunner(jcfg, jp, index, count, max_seq=MAX_SEQ,
                             dtype=jnp.float32)
    tr = TS.ShardStageRunner(cfg, tp, index, count, max_seq=MAX_SEQ,
                             dtype=torch.float32, device="cpu")
    assert tr.layer_range == jr.layer_range
    assert tr.windows == list(jr.windows)
    rng = np.random.default_rng(7)
    d = cfg.hidden_size
    plen, bucket = 40, 64  # longer than Gemma's window of 32
    x = rng.standard_normal((1, bucket, d)).astype(np.float32)
    got, want = tr.prefill("s", x, plen), jr.prefill("s", x, plen)
    assert got.dtype == np.float32 and got.shape == want.shape
    close(got[:, :plen], want[:, :plen])
    n = plen
    for _ in range(3):
        xt = rng.standard_normal((1, d)).astype(np.float32)
        close(tr.decode("s", xt, n, n + 1), jr.decode("s", xt, n, n + 1))
        n += 1
    xw = rng.standard_normal((1, 4, d)).astype(np.float32)
    close(tr.verify("s", xw, n), jr.verify("s", xw, n))
    # The window's K/V were written at n..n+3: a decode at n+1 (one
    # accepted token) reads them as context where they are valid.
    xt = rng.standard_normal((1, d)).astype(np.float32)
    close(tr.decode("s", xt, n + 1, n + 2), jr.decode("s", xt, n + 1, n + 2))
    assert tr.session_count == 1
    tr.release("s")
    assert tr.session_count == 0


def test_stage_runner_takes_a_sliced_share():
    jcfg, cfg, jp, tp = weights("tiny-test-gemma")
    share = {"layers": {k: v[2:4] for k, v in tp["layers"].items()}}
    whole = TS.ShardStageRunner(cfg, tp, 1, 2, dtype=torch.float32,
                                device="cpu")
    cut = TS.ShardStageRunner(cfg, share, 1, 2, dtype=torch.float32,
                              device="cpu")
    for k in whole.layers:
        assert torch.equal(whole.layers[k], cut.layers[k])
    with pytest.raises(ValueError, match="layer leaf"):
        TS.ShardStageRunner(cfg, {"layers": {k: v[:1] for k, v in
                                             tp["layers"].items()}},
                            1, 2, dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------- pipeline

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]


async def _drive(pipe, sid: str) -> list[np.ndarray]:
    """Prefill, 3 decode steps and a verify window: every logits array."""
    out = [await pipe.prefill(sid, PROMPT, 16)]
    n, tok = len(PROMPT), int(np.argmax(out[0]))
    for _ in range(3):
        out.append(await pipe.decode(sid, tok, n, n + 1))
        tok, n = int(np.argmax(out[-1])), n + 1
    out.append(await pipe.verify(sid, [tok, 7, 8, 9], n))
    await pipe.release(sid)
    return out


async def _jax_logits(jcfg, jp) -> list[np.ndarray]:
    stages = [JS.LocalStage(JS.ShardStageRunner(
        jcfg, jp, i, 2, max_seq=MAX_SEQ, dtype=jnp.float32))
        for i in range(2)]
    return await _drive(JS.SwarmPipeline(jcfg, jp, stages,
                                         dtype=jnp.float32), "j")


async def _mixed(model: str, leader: str, member: str) -> tuple:
    """Logits of a two-stage pipeline whose leader (stage 0 and the
    embeddings) is of package ``leader`` and whose stage 1 serves behind a
    ``member`` host, beside the all-JAX pipeline's."""
    jcfg, cfg, jp, tp = weights(model, seed=3)
    want = await _jax_logits(jcfg, jp)
    if member == "jax":
        runner = JS.ShardStageRunner(jcfg, jp, 1, 2, max_seq=MAX_SEQ,
                                     dtype=jnp.float32)
        service = JS.ShardStageService(runner)
    else:
        runner = TS.ShardStageRunner(cfg, tp, 1, 2, max_seq=MAX_SEQ,
                                     dtype=torch.float32, device="cpu")
        service = TS.ShardStageService(runner)
    server = await serve(service.handle, member)
    client = None
    try:
        client, stream = await dial(server, leader)
        if leader == "jax":
            pipe = JS.SwarmPipeline(jcfg, jp, [
                JS.LocalStage(JS.ShardStageRunner(
                    jcfg, jp, 0, 2, max_seq=MAX_SEQ, dtype=jnp.float32)),
                JS.RemoteStage(stream)], dtype=jnp.float32)
        else:
            pipe = TS.SwarmPipeline(cfg, tp, [
                TS.LocalStage(TS.ShardStageRunner(
                    cfg, tp, 0, 2, max_seq=MAX_SEQ, dtype=torch.float32,
                    device="cpu")),
                TS.RemoteStage(stream)], dtype=torch.float32, device="cpu")
        got = await _drive(pipe, "m")
        pipe.close()
        assert runner.session_count == 0
        return got, want
    finally:
        if client is not None:
            await client.close()
        await server.close()


@pytest.mark.parametrize("model", ["tiny-test", "tiny-test-gemma"])
def test_swarm_pipeline_logits_match_jax(model):
    got, want = asyncio.run(asyncio.wait_for(
        _mixed(model, "torch", "torch"), DEADLINE))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("leader,member", [("torch", "jax"),
                                           ("jax", "torch")])
def test_mixed_pipelines_match_the_all_jax_pipeline(leader, member):
    got, want = asyncio.run(asyncio.wait_for(
        _mixed("tiny-test", leader, member), DEADLINE))
    for g, w in zip(got, want):
        close(g, w)


# ----------------------------------------------------------------- service

async def _replies(package: str) -> list[dict]:
    """The error and info replies of ``package``'s stage service."""
    if package == "jax":
        jcfg, _, jp, _ = weights("tiny-test")
        runner = JS.ShardStageRunner(jcfg, jp, 1, 2, max_seq=MAX_SEQ,
                                     dtype=jnp.float32)
        service, mod = JS.ShardStageService(runner), JS
        read, write, tensor = (jhost.read_json_frame, jhost.write_json_frame,
                               JS.write_tensor)
    else:
        _, cfg, _, tp = weights("tiny-test")
        runner = TS.ShardStageRunner(cfg, tp, 1, 2, max_seq=MAX_SEQ,
                                     dtype=torch.float32, device="cpu")
        service, mod = TS.ShardStageService(runner), TS
        read, write, tensor = (thost.read_json_frame, thost.write_json_frame,
                               TS.write_tensor)
    server = await serve(service.handle, package)
    client = None
    out = []
    try:
        client, stream = await dial(server, package)
        stage = mod.RemoteStage(stream)
        with pytest.raises(RuntimeError, match="shard stage error") as e:
            await stage.decode("nope", np.zeros((1, 64), np.float32), 0, 1)
        out.append(str(e.value))
        for header, x in (({"op": "bogus"}, None),
                          ({"op": "prefill", "session": "a"},
                           np.zeros((1, 16, 64), np.float32)),
                          ({"op": "info"}, None)):
            await write(stream.writer, header)
            if x is not None:
                await tensor(stream.writer, x)
            out.append(await read(stream.reader, timeout=30.0))
        # A prefill over this stream, then the stream closes: the service
        # releases the session.
        await stage.prefill("owned", np.zeros((1, 16, 64), np.float32), 5)
        out.append({"sessions": runner.session_count})
        stream.close()
        deadline = asyncio.get_running_loop().time() + 10.0
        while runner.session_count and (
                asyncio.get_running_loop().time() < deadline):
            await asyncio.sleep(0.05)
        out.append({"sessions": runner.session_count})
    finally:
        if client is not None:
            await client.close()
        await server.close()
    return out


def test_service_replies_match_jax():
    got = asyncio.run(asyncio.wait_for(_replies("torch"), DEADLINE))
    want = asyncio.run(asyncio.wait_for(_replies("jax"), DEADLINE))
    assert got == want
    assert got[-2:] == [{"sessions": 1}, {"sessions": 0}]
