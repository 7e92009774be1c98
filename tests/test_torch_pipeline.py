"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's.

On ``tests/test_pipeline.py``'s cases: the same fp32 weights (made by the
JAX package, crossed through numpy), the JAX side on the conftest's
virtual CPU devices, the port's ranks on ``["cpu"] * n``:

- ``pp_prefill`` logits and every stage's KV against JAX's ``pp_prefill``
  (pp x tp, dp x pp, pp x ep x tp on a MoE model, four stages of Gemma-2);
- ``pp_decode_step`` logits and the stages' caches against JAX's;
- one microbatch (B = 1, the serving prefill) through ``pp_prefill`` and
  ``pp_hidden_states``, and ``pick_n_microbatches``;
- the schedule: stage r takes microbatch s - r at step s, and the bubble's
  out-of-range pairs are skipped.
All within 2e-4 abs + 1e-4 rel, JAX's own tolerance for these cases.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine.weights import _flatten_params  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.parallel import pipeline as JP  # noqa: E402
from crowdllama_tpu.parallel.mesh import build_mesh as j_build_mesh  # noqa: E402
from crowdllama_tpu.parallel.sharding import (  # noqa: E402
    cache_sharding,
    shard_params as j_shard_params,
)
from crowdllama_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.parallel import pipeline as P  # noqa: E402
from crowdllama_tpu_torch.parallel.mesh import build_mesh, mesh_axes  # noqa: E402
from crowdllama_tpu_torch.parallel.sharding import (  # noqa: E402
    rank_groups,
    shard_params,
)

B, SEQ, S = 4, 8, 16
TOL = dict(atol=2e-4, rtol=1e-4)


def _setup(name, spec, seed=0):
    jcfg = j_get_config(name)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed),
                             dtype=jnp.float32)
    cfg = get_config(name)
    mesh = build_mesh(spec, devices=["cpu"] * math.prod(mesh_axes(spec)))
    groups = rank_groups(shard_params(
        params_from_numpy(_flatten_params(jparams)), cfg, mesh), mesh)
    return jcfg, jparams, cfg, mesh, groups


def _stages(groups, mesh, d=0):
    return [groups[(d, p, 0)] for p in range(mesh.pp)]


def _per_stage_cache(x: np.ndarray, mesh, tp: int) -> list:
    """[L, B, Hkv, S, Dh] cut into stages (layers) and tp ranks (heads)."""
    return [[torch.from_numpy(np.array(h))
             for h in np.split(st, tp, axis=2)]
            for st in np.split(x, mesh.pp, axis=0)]


def _joined(parts: list) -> np.ndarray:
    return np.concatenate([np.concatenate([t.numpy() for t in st], axis=2)
                           for st in parts], axis=0)


@pytest.mark.parametrize("name,spec", [
    ("tiny-test", "1x2x1x1x2"),
    ("tiny-test", "2x2x1x1x1"),
    ("tiny-test-moe", "1x2x1x2x2"),
    ("tiny-test-gemma", "1x4x1x1x2"),
])
def test_pp_prefill_matches_jax(name, spec):
    jcfg, jparams, cfg, mesh, groups = _setup(name, spec)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, SEQ))
    pos = np.tile(np.arange(SEQ), (B, 1))
    jmesh = j_build_mesh(spec)
    want, wks, wvs = jax.jit(lambda p, t, po: JP.pp_prefill(
        p, jcfg, t, po, jmesh))(j_shard_params(jparams, jcfg, jmesh),
                                jnp.asarray(tokens), jnp.asarray(pos))
    got, ks, vs = P.pp_prefill(_stages(groups, mesh), cfg,
                               torch.from_numpy(tokens),
                               torch.from_numpy(pos).int())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(_joined(ks), np.asarray(wks), **TOL)
    np.testing.assert_allclose(_joined(vs), np.asarray(wvs), **TOL)


@pytest.mark.parametrize("name,spec", [
    ("tiny-test", "1x2x1x1x2"),
    ("tiny-test-moe", "1x2x1x2x1"),
])
def test_pp_decode_matches_jax(name, spec):
    jcfg, jparams, cfg, mesh, groups = _setup(name, spec)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, SEQ))
    pos = np.tile(np.arange(SEQ), (B, 1))
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    _, ks, vs = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                           jnp.asarray(pos))
    kc = jnp.zeros((L, B, hkv, S, dh), jnp.float32).at[:, :, :, :SEQ].set(ks)
    vc = jnp.zeros((L, B, hkv, S, dh), jnp.float32).at[:, :, :, :SEQ].set(vs)
    nxt = rng.integers(0, cfg.vocab_size, (B,))
    dpos = np.full((B,), SEQ, np.int32)
    lens = np.full((B,), SEQ + 1, np.int32)

    jmesh = j_build_mesh(spec)
    want, wkc, wvc = jax.jit(lambda p, t, po, k, v, sl: JP.pp_decode_step(
        p, jcfg, t, po, k, v, sl, jmesh))(
        j_shard_params(jparams, jcfg, jmesh), jnp.asarray(nxt),
        jnp.asarray(dpos), jax.device_put(kc, cache_sharding(jmesh)),
        jax.device_put(vc, cache_sharding(jmesh)), jnp.asarray(lens))

    tp = mesh.tp
    kcs = _per_stage_cache(np.asarray(kc), mesh, tp)
    vcs = _per_stage_cache(np.asarray(vc), mesh, tp)
    stages = _stages(groups, mesh)
    ropes = [[T.rope_for(cfg, "cpu")] * tp for _ in stages]
    got = P.pp_decode_step(stages, cfg, torch.from_numpy(nxt),
                           torch.from_numpy(dpos), kcs, vcs,
                           torch.from_numpy(lens), ropes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(_joined(kcs), np.asarray(wkc), **TOL)
    np.testing.assert_allclose(_joined(vcs), np.asarray(wvc), **TOL)


def test_pp_prefill_single_microbatch():
    """B = 1 (the serving prefill): sequential stages, JAX's logits."""
    jcfg, jparams, cfg, mesh, groups = _setup("tiny-test", "1x2x1x1x2",
                                              seed=1)
    tokens = np.asarray([[5, 9, 2, 11, 3, 1, 8, 4]])
    pos = np.arange(8)[None, :]
    jmesh = j_build_mesh("1x2x1x1x2")
    want, _, _ = jax.jit(lambda p, t, po: JP.pp_prefill(p, jcfg, t, po,
                                                        jmesh))(
        j_shard_params(jparams, jcfg, jmesh), jnp.asarray(tokens),
        jnp.asarray(pos))
    got, _, _ = P.pp_prefill(_stages(groups, mesh), cfg,
                             torch.from_numpy(tokens),
                             torch.from_numpy(pos).int())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hs = P.pp_hidden_states(_stages(groups, mesh), cfg,
                            torch.from_numpy(tokens),
                            torch.from_numpy(pos).int())
    want_h = jax.jit(lambda p, t, po: JP.pp_hidden_states(
        p, jcfg, t, po, jmesh))(
        j_shard_params(jparams, jcfg, jmesh), jnp.asarray(tokens),
        jnp.asarray(pos))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("batch,pp", [(8, 2), (3, 2), (6, 4), (1, 8), (4, 4)])
def test_pick_n_microbatches_matches_jax(batch, pp):
    assert P.pick_n_microbatches(batch, pp) == JP.pick_n_microbatches(batch,
                                                                      pp)


@pytest.mark.parametrize("n_mb,npp", [(1, 2), (2, 2), (3, 2), (4, 4)])
def test_schedule_is_gpipe(n_mb, npp):
    """Every (stage, microbatch) pair once; stage r takes microbatch s - r
    at step s; a microbatch reaches stage r + 1 the step after stage r."""
    sched = list(P._schedule(n_mb, npp))
    assert sorted((r, m) for _, r, m in sched) == [
        (r, m) for r in range(npp) for m in range(n_mb)]
    assert all(m == s - r for s, r, m in sched)
    step = {(r, m): s for s, r, m in sched}
    assert all(step[(r + 1, m)] == step[(r, m)] + 1
               for r in range(npp - 1) for m in range(n_mb))
    assert max(s for s, _, _ in sched) == n_mb + npp - 2
