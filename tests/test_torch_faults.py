"""The port's fault-site registry (``testing/faults.py``) against the JAX
package's: the same sites, each one injected where the port instruments
it, and the ``scheduler.ragged_chunk`` site's ``drain`` action migrating
a stream in the middle of its chunked prefill in the port's scheduler
as in JAX's (the same pass fires, the stream ends ``migrate`` with no
token, the engine stays up)."""

import ast
import asyncio
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.testing import faults as jfaults  # noqa: E402
from crowdllama_tpu_torch.testing import faults as tfaults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 256


def test_fault_site_registries_have_equal_keys():
    assert set(tfaults.FAULT_SITES) == set(jfaults.FAULT_SITES)


def test_every_port_site_is_injected_in_the_port():
    injected = set()
    for path in (ROOT / "crowdllama_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "inject"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "faults" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                injected.add(node.args[0].value)
    assert injected == set(tfaults.FAULT_SITES)


@pytest.fixture(scope="module")
def flat():
    from crowdllama_tpu.engine.weights import _flatten_params
    from crowdllama_tpu.models import transformer as JT
    from crowdllama_tpu.models.config import get_config as jget

    cfg = jget("tiny-test", max_context_length=MAX_SEQ)
    return _flatten_params(JT.init_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32))


def _scheduler(pkg, flat):
    common = dict(max_slots=4, max_seq=MAX_SEQ, page_size=32,
                  step_token_budget=96, prefix_cache=True)
    if pkg == "jax":
        from crowdllama_tpu.engine import scheduler as mod
        from crowdllama_tpu.engine.paged import PagedModelRunner
        from crowdllama_tpu.models.config import get_config as jget
        from test_torch_autotune import _jparams

        runner = PagedModelRunner(jget("tiny-test", max_context_length=MAX_SEQ),
                                  params=_jparams(flat), dtype=jnp.float32,
                                  mesh_spec="1", **common)
        return mod, jfaults, mod.Scheduler(runner, decode_chunk=1)
    from crowdllama_tpu_torch.engine import scheduler as mod
    from crowdllama_tpu_torch.engine.paged import PagedModelRunner
    from crowdllama_tpu_torch.engine.weights import params_from_numpy
    from crowdllama_tpu_torch.models.config import get_config

    runner = PagedModelRunner(get_config("tiny-test", max_context_length=MAX_SEQ),
                              params=params_from_numpy(flat), device="cpu",
                              **common)
    return mod, tfaults, mod.Scheduler(runner, decode_chunk=1)


async def _drain_mid_prefill(pkg, flat):
    """One 200-token prompt in 64-token ragged chunks (one a dispatch);
    the drain rule fires at the second dispatch while a delay parks the
    loop between the next two.  Returns (tokens, reason, fired events,
    ragged chunks run, indexed prefix pages)."""
    mod, faults, sched = _scheduler(pkg, flat)
    plan = faults.FaultPlan(seed=13, rules=[
        faults.FaultRule(site="scheduler.ragged_chunk", action="delay",
                         delay_s=0.3, after=2, times=2),
        faults.FaultRule(site="scheduler.ragged_chunk", action="drain",
                         after=1, times=1)])
    req = mod.GenRequest(prompt_ids=list(range(11, 211)), max_tokens=8)
    sched.start()
    try:
        with faults.installed(plan):
            await sched.submit(req)
            toks = []
            while True:
                tok, reason = await asyncio.wait_for(req.out.get(), 60)
                if tok is mod.DONE:
                    break
                toks.append(tok)
        with pytest.raises(RuntimeError, match="draining"):
            await sched.submit(mod.GenRequest(prompt_ids=[1, 2, 3]))
    finally:
        await sched.stop()
    runner = sched.runner
    return (toks, reason, plan.log, sched.ragged_chunks,
            len(runner._prefix_index))


async def test_a_ragged_chunk_drain_migrates_mid_prefill_as_in_jax(flat):
    got = await _drain_mid_prefill("torch", flat)
    want = await _drain_mid_prefill("jax", flat)
    assert got == want
    toks, reason, log, chunks, pages = got
    assert toks == [] and reason == "migrate"
    assert log[0][2] == "drain"
    assert 0 < log[0][1]["done"] < log[0][1]["total"] == 200
    assert 0 < chunks < 4 and pages > 0  # completed pages stay cached
