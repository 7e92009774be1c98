"""Expert banks of the port (``engine/expert_service.py``) against the JAX
package's.

- ``assign_experts`` and ``_pad_bucket`` equal JAX's.
- ``ExpertBankRunner.ffn``: a bank's outputs for prefill-sized batches
  (20 rows, padded to 32) and decode-sized ones (1 and 2 rows over 4 local
  experts: most groups empty, the padding rows on local expert 0) against
  JAX's bank on the same fp32 weights, within 1e-4; the refusal of an
  expert the bank does not host, word for word.
- ``EPLeaderRunner`` + ``EPPipeline``: prefill, decode and verify logits
  with one bank behind a real authenticated loopback stream against JAX's
  pipeline (1e-4), on ``tiny-test-moe`` and on ``tiny-test-qwen3-moe``
  with qkv biases and perturbed biases and qk-norms; mixed: the port's
  leader over a JAX bank service and JAX's leader over the port's bank
  service, equal to the all-JAX logits.
- The expert-coverage refusal and the bank service's ``info`` and error
  replies equal JAX's.

Every networked test is bounded by ``asyncio.wait_for``.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_shard_service import (  # noqa: E402
    DEADLINE,
    MAX_SEQ,
    PROMPT,
    close,
    dial,
    serve,
)

from crowdllama_tpu.engine import expert_service as JE  # noqa: E402
from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.net import host as jhost  # noqa: E402
from crowdllama_tpu_torch.engine import expert_service as TE  # noqa: E402
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.net import host as thost  # noqa: E402


def moe_weights(model: str, seed: int = 0, perturb: bool = False, **over):
    """(JAX cfg, port cfg, JAX fp32 params, the port's copy); with
    ``perturb`` the biases and qk-norms move off their zero / one init so
    the leader's Qwen branches change the logits."""
    jcfg = j_get_config(model, max_context_length=MAX_SEQ, **over)
    cfg = get_config(model, max_context_length=MAX_SEQ, **over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if perturb:
        r = np.random.default_rng(11)
        for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if name in jp["layers"]:
                shape = jp["layers"][name].shape
                jp["layers"][name] = jp["layers"][name] + jnp.asarray(
                    0.1 * r.standard_normal(shape).astype(np.float32))
    return jcfg, cfg, jp, params_from_numpy(_flatten_params(jp))


@pytest.mark.parametrize("n,count", [(4, 2), (8, 2), (8, 3), (8, 8), (5, 4)])
def test_assign_experts_and_buckets_match_jax(n, count):
    for i in range(count):
        assert TE.assign_experts(n, count, i) == JE.assign_experts(n, count, i)
    for rows in (0, 1, 2, 7, 8, 9, 20, 33, 1000):
        assert TE._pad_bucket(rows) == JE._pad_bucket(rows)


BANK_CASES = {"prefill": 20, "decode1": 1, "decode2": 2}


@pytest.mark.parametrize("rows", list(BANK_CASES))
def test_expert_bank_matches_jax(rows):
    jcfg, cfg, jp, tp = moe_weights("tiny-test-moe", num_experts=8)
    ids = TE.assign_experts(8, 2, 1)  # four local experts
    jb = JE.ExpertBankRunner(jcfg, jp, ids, dtype=jnp.float32)
    tb = TE.ExpertBankRunner(cfg, tp, ids, dtype=torch.float32, device="cpu")
    r = np.random.default_rng(BANK_CASES[rows])
    n = BANK_CASES[rows]
    x = r.standard_normal((n, cfg.hidden_size)).astype(np.float32)
    eids = r.choice(ids, size=n)
    for layer in range(cfg.num_layers):
        got = tb.ffn(layer, eids, x)
        assert got.dtype == np.float32 and got.shape == x.shape
        close(got, jb.ffn(layer, eids, x))
    errs = []
    for bank in (tb, jb):
        with pytest.raises(ValueError) as e:
            bank.ffn(0, np.asarray([0]), x[:1])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_expert_bank_takes_a_sliced_share():
    _, cfg, _, tp = moe_weights("tiny-test-moe")
    ids = [1, 3]
    share = {"layers": {k: tp["layers"][k][:, ids]
                        for k in ("w_gate", "w_up", "w_down")}}
    whole = TE.ExpertBankRunner(cfg, tp, ids, dtype=torch.float32,
                                device="cpu")
    cut = TE.ExpertBankRunner(cfg, share, ids, dtype=torch.float32,
                              device="cpu")
    assert torch.equal(whole.wg, cut.wg) and torch.equal(whole.wd, cut.wd)


async def _drive(pipe, sid: str) -> list[np.ndarray]:
    out = [await pipe.prefill(sid, PROMPT, 16)]
    n, tok = len(PROMPT), int(np.argmax(out[0]))
    for _ in range(3):
        out.append(await pipe.decode(sid, tok, n, n + 1))
        tok, n = int(np.argmax(out[-1])), n + 1
    out.append(await pipe.verify(sid, [tok, 7, 8, 9], n))
    await pipe.release(sid)
    return out


async def _ep(model: str, leader: str, member: str, **kw) -> tuple:
    """Logits of an EP pipeline whose leader (attention, router, bank 0)
    is of package ``leader`` and whose bank 1 serves behind a ``member``
    host, beside the all-JAX pipeline's."""
    jcfg, cfg, jp, tp = moe_weights(model, seed=3, **kw)
    e = cfg.num_experts
    jbanks = [JE.LocalExpertBank(JE.ExpertBankRunner(
        jcfg, jp, JE.assign_experts(e, 2, i), dtype=jnp.float32))
        for i in range(2)]
    want = await _drive(JE.EPPipeline(jcfg, JE.EPLeaderRunner(
        jcfg, jp, max_seq=MAX_SEQ, dtype=jnp.float32), jbanks), "j")
    ids = JE.assign_experts(e, 2, 1)
    if member == "jax":
        bank = JE.ExpertBankRunner(jcfg, jp, ids, dtype=jnp.float32)
        service = JE.ExpertBankService(bank)
    else:
        bank = TE.ExpertBankRunner(cfg, tp, ids, dtype=torch.float32,
                                   device="cpu")
        service = TE.ExpertBankService(bank)
    server = await serve(service.handle, member)
    client = None
    try:
        client, stream = await dial(server, leader)
        if leader == "jax":
            runner = JE.EPLeaderRunner(jcfg, jp, max_seq=MAX_SEQ,
                                       dtype=jnp.float32)
            pipe = JE.EPPipeline(jcfg, runner, [
                jbanks[0], JE.RemoteExpertBank(stream, ids)])
        else:
            runner = TE.EPLeaderRunner(cfg, tp, max_seq=MAX_SEQ,
                                       dtype=torch.float32, device="cpu")
            pipe = TE.EPPipeline(cfg, runner, [
                TE.LocalExpertBank(TE.ExpertBankRunner(
                    cfg, tp, TE.assign_experts(e, 2, 0),
                    dtype=torch.float32, device="cpu")),
                TE.RemoteExpertBank(stream, ids)])
        got = await _drive(pipe, "m")
        assert runner.session_count == 0
        pipe.close()
        return got, want
    finally:
        if client is not None:
            await client.close()
        await server.close()


EP_MODELS = {
    "tiny-test-moe": {},
    "tiny-test-qwen3-moe": dict(attn_qkv_bias=True, perturb=True),
}


@pytest.mark.parametrize("model", list(EP_MODELS))
def test_ep_pipeline_logits_match_jax(model):
    got, want = asyncio.run(asyncio.wait_for(
        _ep(model, "torch", "torch", **EP_MODELS[model]), DEADLINE))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("leader,member", [("torch", "jax"),
                                           ("jax", "torch")])
def test_mixed_ep_pipelines_match_the_all_jax_pipeline(leader, member):
    got, want = asyncio.run(asyncio.wait_for(
        _ep("tiny-test-moe", leader, member), DEADLINE))
    for g, w in zip(got, want):
        close(g, w)


def test_expert_coverage_refusal_matches_jax():
    jcfg, cfg, jp, tp = moe_weights("tiny-test-moe")
    errs = []
    with pytest.raises(RuntimeError) as e:
        JE.EPPipeline(jcfg, JE.EPLeaderRunner(jcfg, jp, dtype=jnp.float32),
                      [JE.LocalExpertBank(JE.ExpertBankRunner(
                          jcfg, jp, [0, 2], dtype=jnp.float32))])
    errs.append(str(e.value))
    with pytest.raises(RuntimeError) as e:
        TE.EPPipeline(cfg, TE.EPLeaderRunner(cfg, tp, dtype=torch.float32,
                                             device="cpu"),
                      [TE.LocalExpertBank(TE.ExpertBankRunner(
                          cfg, tp, [0, 2], dtype=torch.float32,
                          device="cpu"))])
    errs.append(str(e.value))
    assert errs[0] == errs[1] and "unassigned" in errs[0]


async def _bank_replies(package: str) -> list[dict]:
    if package == "jax":
        jcfg, _, jp, _ = moe_weights("tiny-test-moe")
        service = JE.ExpertBankService(JE.ExpertBankRunner(
            jcfg, jp, [1, 3], dtype=jnp.float32))
        read, write = jhost.read_json_frame, jhost.write_json_frame
    else:
        _, cfg, _, tp = moe_weights("tiny-test-moe")
        service = TE.ExpertBankService(TE.ExpertBankRunner(
            cfg, tp, [1, 3], dtype=torch.float32, device="cpu"))
        read, write = thost.read_json_frame, thost.write_json_frame
    server = await serve(service.handle, package)
    client = None
    out = []
    try:
        client, stream = await dial(server, package)
        for header in ({"op": "info"}, {"op": "nope"}):
            await write(stream.writer, header)
            out.append(await read(stream.reader, timeout=30.0))
        bank = (JE if package == "jax" else TE).RemoteExpertBank(stream,
                                                                 [1, 3])
        with pytest.raises(RuntimeError) as e:
            await bank.ffn(0, np.asarray([2]), np.zeros((1, 64), np.float32))
        out.append({"error": str(e.value)})
    finally:
        if client is not None:
            await client.close()
        await server.close()
    return out


def test_bank_service_replies_match_jax():
    got = asyncio.run(asyncio.wait_for(_bank_replies("torch"), DEADLINE))
    want = asyncio.run(asyncio.wait_for(_bank_replies("jax"), DEADLINE))
    assert got == want


def test_leader_holds_only_its_share():
    """The leader places attention, router and embeddings, no expert."""
    _, cfg, _, tp = moe_weights("tiny-test-moe")
    r = TE.EPLeaderRunner(cfg, tp, dtype=torch.float32, device="cpu")
    assert set(r.layers) == {"ln1", "ln2", "wq", "wk", "wv", "wo", "router"}
    qcfg = dataclasses.replace(cfg, attn_qkv_bias=True, qk_norm=True)
    assert set(TE.EPLeaderRunner.layer_keys(qcfg)) == set(r.layers) | {
        "bq", "bk", "bv", "q_norm", "k_norm"}
