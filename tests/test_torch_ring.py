"""The port's sequence parallelism (``ops/ring.py``) against the JAX
package's.

- ``ring_prefill_attention`` over per-rank sequence shards against JAX's
  ring on the conftest's virtual CPU devices, on ``tests/test_ring.py``'s
  specs and shapes (GQA under tp, softcap and a sliding window, a padded
  tail on one sequence), fp32 within 2e-5 abs + rel; the port's shards
  may sit on one device (``["cpu"] * n``), as the JAX body's do not.
- ``sp_decode_attention`` the same way (one full and one partial
  sequence), and ``sp_cache_update`` writing exactly JAX's cache.
- Both against the port's dense attention (the one-rank function).
- A padded tail masks in every block pair: shards wholly in the padding
  get outputs equal to the dense function's rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.ops import ring as JR  # noqa: E402
from crowdllama_tpu.parallel.mesh import build_mesh  # noqa: E402
from crowdllama_tpu_torch.ops import ring as R  # noqa: E402
from crowdllama_tpu_torch.ops.attention import (  # noqa: E402
    decode_attention_ref,
    prefill_attention_ref,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _sp_tp(spec: str) -> tuple[int, int]:
    from crowdllama_tpu_torch.parallel.mesh import mesh_axes

    _, _, sp, _, tp = mesh_axes(spec)
    return sp, tp


def _shards(x: np.ndarray, n: int, axis: int) -> list:
    return [torch.from_numpy(np.ascontiguousarray(p))
            for p in np.split(x, n, axis=axis)]


def _tp_heads(x: np.ndarray, tp: int, axis: int) -> list[np.ndarray]:
    """kv-major head shards: tp rank r's heads."""
    return np.split(x, tp, axis=axis)


@pytest.mark.parametrize("spec,h,hkv,softcap,window", [
    ("1x4x1x2", 4, 2, 0.0, 0),
    ("2x2x1x2", 8, 4, 0.0, 0),
    ("1x8x1x1", 4, 2, 30.0, 16),
])
def test_ring_prefill_matches_jax(spec, h, hkv, softcap, window):
    b, t, dh = 2, 64, 8
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kv_valid = np.stack([np.ones(t, bool), np.arange(t) < t - 10])
    scale = dh ** -0.5

    mesh = build_mesh(spec)
    want = np.asarray(jax.jit(lambda *a: JR.ring_prefill_attention(
        *a, scale, mesh, softcap=softcap, sliding_window=window,
        kv_valid=jnp.asarray(kv_valid)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions)))

    sp, tp = _sp_tp(spec)
    got = np.zeros_like(want)
    for r, (qh, kh, vh) in enumerate(zip(_tp_heads(q, tp, 2),
                                         _tp_heads(k, tp, 2),
                                         _tp_heads(v, tp, 2))):
        outs = R.ring_prefill_attention(
            _shards(qh, sp, 1), _shards(kh, sp, 1), _shards(vh, sp, 1),
            _shards(positions, sp, 1), scale, softcap=softcap,
            sliding_window=window, kv_valid=_shards(kv_valid, sp, 1))
        hq = h // tp
        got[:, :, r * hq:(r + 1) * hq] = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    dense = prefill_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), torch.from_numpy(positions),
        scale, softcap=softcap, sliding_window=window,
        kv_valid=torch.from_numpy(kv_valid))
    np.testing.assert_allclose(got, dense.numpy(), **TOL)


def test_ring_masks_a_padded_tail_in_every_pair():
    """A prompt of 5 valid tokens in a 32-token bucket on 4 shards: the
    padding positions clamp to the last valid one (as the runner passes
    them), so only ``kv_valid`` keeps the three padding shards' keys out
    of the other shards' rows; every row equals the dense function's."""
    b, t, h, hkv, dh, plen = 1, 32, 4, 2, 8, 5
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, hkv, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, hkv, dh)).astype(np.float32))
    pos = torch.clamp(torch.arange(t), max=plen - 1)[None].int()
    valid = (torch.arange(t) < plen)[None]
    outs = R.ring_prefill_attention(q.chunk(4, 1), k.chunk(4, 1),
                                    v.chunk(4, 1), list(pos.chunk(4, 1)),
                                    0.3, kv_valid=list(valid.chunk(4, 1)))
    dense = prefill_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                  pos, 0.3, kv_valid=valid)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), dense.numpy(),
                               **TOL)


@pytest.mark.parametrize("spec,h,hkv,softcap,window", [
    ("1x4x1x2", 4, 2, 0.0, 0),
    ("1x2x1x2", 8, 4, 0.0, 0),
    ("2x4x1x1", 4, 2, 50.0, 12),
])
def test_sp_decode_matches_jax(spec, h, hkv, softcap, window):
    b, s, dh = 2, 32, 8
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    seq_lens = np.asarray([s, 17], np.int32)
    scale = dh ** -0.5

    mesh = build_mesh(spec)
    want = np.asarray(jax.jit(lambda *a: JR.sp_decode_attention(
        *a, scale, mesh, softcap=softcap, sliding_window=window))(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(seq_lens)))

    sp, tp = _sp_tp(spec)
    got = np.zeros_like(want)
    hq = h // tp
    for r, (qh, kh, vh) in enumerate(zip(_tp_heads(q, tp, 1),
                                         _tp_heads(kc, tp, 1),
                                         _tp_heads(vc, tp, 1))):
        out = R.sp_decode_attention(
            torch.from_numpy(np.ascontiguousarray(qh)), _shards(kh, sp, 2),
            _shards(vh, sp, 2), torch.from_numpy(seq_lens), scale,
            softcap=softcap, sliding_window=window)
        got[:, r * hq:(r + 1) * hq] = out.numpy()
    np.testing.assert_allclose(got, want, **TOL)

    dense = decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(seq_lens), scale, softcap=softcap,
        sliding_window=window)
    np.testing.assert_allclose(got, dense.numpy(), **TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_cache_update_matches_jax(sp):
    """Each shard writes only the positions it owns; the joined shards
    equal JAX's cache after its shard-local update."""
    b, hkv, s, dh = 3, 2, 32, 8
    rng = np.random.default_rng(2)
    kc = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    k_new = rng.standard_normal((b, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((b, hkv, dh)).astype(np.float32)
    positions = np.asarray([0, s // sp, s - 1], np.int32)

    mesh = build_mesh(f"1x{sp}x1x1")
    jk, jv = JR.sp_cache_update(
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(positions),
        jnp.asarray(kc), jnp.asarray(vc), mesh)
    ks, vs = _shards(kc, sp, 2), _shards(vc, sp, 2)
    R.sp_cache_update(torch.from_numpy(k_new), torch.from_numpy(v_new),
                      torch.from_numpy(positions), ks, vs)
    np.testing.assert_array_equal(torch.cat(ks, 2).numpy(), np.asarray(jk))
    np.testing.assert_array_equal(torch.cat(vs, 2).numpy(), np.asarray(jv))
