"""The port's plain ops (crowdllama_tpu_torch) against the JAX package's.

Inputs are made once from a numpy seed and handed to both packages; the
comparisons run in float32 at atol 1e-5 (both sides accumulate in fp32,
only the order of sums differs)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine import sampling as JS  # noqa: E402
from crowdllama_tpu.models.config import RopeScaling as JRopeScaling  # noqa: E402
from crowdllama_tpu.ops import attention as JA  # noqa: E402
from crowdllama_tpu.ops.norms import rms_norm as j_rms_norm  # noqa: E402
from crowdllama_tpu.ops.rope import apply_rope as j_apply_rope  # noqa: E402
from crowdllama_tpu.ops.rope import rope_table as j_rope_table  # noqa: E402
from crowdllama_tpu_torch.engine import sampling as TS  # noqa: E402
from crowdllama_tpu_torch.models.config import RopeScaling  # noqa: E402
from crowdllama_tpu_torch.ops import attention as TA  # noqa: E402
from crowdllama_tpu_torch.ops.norms import rms_norm  # noqa: E402
from crowdllama_tpu_torch.ops.rope import apply_rope, rope_table  # noqa: E402

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    r = _rng(1)
    x = r.standard_normal((3, 5, 16)).astype(np.float32)
    w = r.standard_normal(16).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                   plus_one=plus_one)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one=plus_one)
    _close(got, want)


@pytest.mark.parametrize("scaling", [None, "llama3", "linear"])
def test_rope_table_and_apply_match_jax(scaling):
    kw = dict(factor=4.0, original_max_position_embeddings=32)
    tsc = jsc = None
    if scaling == "llama3":
        tsc, jsc = RopeScaling(**kw), JRopeScaling(**kw)
    elif scaling == "linear":
        tsc = RopeScaling(rope_type="linear", factor=4.0)
        jsc = JRopeScaling(rope_type="linear", factor=4.0)
    cos, sin = rope_table(48, 16, 10000.0, scaling=tsc)
    jcos, jsin = j_rope_table(48, 16, 10000.0, scaling=jsc)
    _close(cos, jcos)
    _close(sin, jsin)
    r = _rng(2)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = r.integers(0, 48, (2, 7))
    # Same tables on both sides: this checks the rotation itself.
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     torch.from_numpy(np.array(jcos)),
                     torch.from_numpy(np.array(jsin)))
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), jcos, jsin)
    _close(got, want)


def _qkv(r, b, t, h, hkv, dh):
    q = r.standard_normal((b, t, h, dh)).astype(np.float32)
    k = r.standard_normal((b, hkv, t, dh)).astype(np.float32)
    v = r.standard_normal((b, hkv, t, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("softcap,window,plen", [
    (0.0, 0, 24), (30.0, 0, 24), (0.0, 5, 24), (0.0, 0, 17), (20.0, 7, 11)])
def test_prefill_attention_ref_matches_jax(softcap, window, plen):
    """Padded prompts: positions clamp at plen-1, kv_valid masks padding."""
    r = _rng(3)
    b, t, h, hkv, dh = 2, 24, 4, 2, 8
    q, k, v = _qkv(r, b, t, h, hkv, dh)
    pos = np.minimum(np.arange(t), plen - 1)[None].repeat(b, 0).astype(
        np.int32)
    valid = (np.arange(t) < plen)[None].repeat(b, 0)
    got = TA.prefill_attention_ref(
        *map(torch.from_numpy, (q, k, v, pos)), 0.35, softcap=softcap,
        sliding_window=window, kv_valid=torch.from_numpy(valid))
    want = JA.prefill_attention_ref(
        *map(jnp.asarray, (q, k, v, pos)), 0.35, softcap=softcap,
        sliding_window=window, kv_valid=jnp.asarray(valid))
    _close(got, want)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (25.0, 0), (0.0, 6)])
def test_prefill_attention_ctx_matches_jax(softcap, window):
    r = _rng(4)
    b, t, c, h, hkv, dh, ctx, slen = 1, 16, 32, 4, 2, 8, 20, 13
    q, k, v = _qkv(r, b, t, h, hkv, dh)
    ck = r.standard_normal((b, hkv, c, dh)).astype(np.float32)
    cv = r.standard_normal((b, hkv, c, dh)).astype(np.float32)
    pos = (ctx + np.minimum(np.arange(t), slen - 1))[None].astype(np.int32)
    valid = (np.arange(t) < slen)[None]
    cvalid = (np.arange(c) < ctx)[None]
    args = (q, k, v, pos, ck, cv, cvalid)
    got = TA.prefill_attention_ctx(
        *map(torch.from_numpy, args), 0.35, softcap=softcap,
        sliding_window=window, kv_valid=torch.from_numpy(valid))
    want = JA.prefill_attention_ctx(
        *map(jnp.asarray, args), 0.35, softcap=softcap,
        sliding_window=window, kv_valid=jnp.asarray(valid))
    _close(got, want)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (25.0, 0), (0.0, 9)])
def test_decode_attention_ref_matches_jax(softcap, window):
    """Includes a zero-length slot (every key masked)."""
    r = _rng(5)
    b, s, h, hkv, dh = 4, 40, 4, 2, 8
    q = r.standard_normal((b, h, dh)).astype(np.float32)
    kc = r.standard_normal((b, hkv, s, dh)).astype(np.float32)
    vc = r.standard_normal((b, hkv, s, dh)).astype(np.float32)
    lens = np.array([0, 1, 23, 40], np.int32)
    args = (q, kc, vc, lens)
    got = TA.decode_attention(*map(torch.from_numpy, args), 0.35,
                              softcap=softcap, sliding_window=window)
    want = JA.decode_attention_ref(*map(jnp.asarray, args), 0.35,
                                   softcap=softcap, sliding_window=window)
    _close(got, want)


def _logits(seed, b=4, v=300):
    # Distinct values: top-k ties would make the orders differ legitimately.
    r = _rng(seed)
    return (r.permutation(b * v).reshape(b, v) / 37.0).astype(np.float32)


@pytest.mark.parametrize("top_k", [None, [0, 5, 70, 1]])
def test_nucleus_filter_matches_jax(top_k):
    logits = _logits(6)
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 0.99], np.float32)
    tk = None if top_k is None else np.array(top_k, np.int32)
    got = TS._nucleus_filter(torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(top_p), 64,
                             None if tk is None else torch.from_numpy(tk))
    want = JS._nucleus_filter(jnp.asarray(logits), jnp.asarray(temp),
                              jnp.asarray(top_p), 64,
                              None if tk is None else jnp.asarray(tk))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(w).astype(np.float64),
                                   atol=ATOL, rtol=0)


def test_repeat_penalty_matches_jax():
    logits = _logits(7, b=3, v=50) - 20.0
    recent = np.array([[1, 2, 50, 50], [3, 3, 49, 0], [7, 8, 9, 10]],
                      np.int32)
    pen = np.array([1.3, 0.0, 1.0], np.float32)
    got = TS.apply_repeat_penalty(*map(torch.from_numpy,
                                       (logits, recent, pen)))
    want = JS.apply_repeat_penalty(*map(jnp.asarray, (logits, recent, pen)))
    _close(got, want)


def test_greedy_sampling_is_exact_argmax():
    logits = _logits(8)
    temp = np.zeros(4, np.float32)
    top_p = np.ones(4, np.float32)
    keys = np.zeros((4, 2), np.uint32)
    got = TS.sample_tokens_slots(torch.from_numpy(logits),
                                 torch.from_numpy(temp),
                                 torch.from_numpy(top_p), keys)
    want = JS.sample_tokens_slots(jnp.asarray(logits), jnp.asarray(temp),
                                  jnp.asarray(top_p), jnp.asarray(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seeded_sampling_reproduces_and_stays_in_filter():
    """A sampled row draws with its own key chain: the same seed gives the
    same tokens, and every draw lies inside the row's top-k."""
    from crowdllama_tpu_torch.engine import prng

    logits = torch.from_numpy(_logits(9))
    temp = torch.tensor([0.0, 0.8, 0.8, 1.0])
    top_p = torch.ones(4)
    top_k = torch.tensor([0, 3, 3, 5], dtype=torch.int32)

    def draw(seed):
        keys, out = prng.split(prng.PRNGKey(seed), 4), []
        for _ in range(8):
            keys, sub = TS.split_slot_keys(keys)
            out.append(TS.sample_tokens_slots(logits, temp, top_p, sub,
                                              top_k=top_k))
        return torch.stack(out)

    a, b = draw(11), draw(11)
    assert torch.equal(a, b)
    assert (a[:, 0] == logits[0].argmax()).all()
    for row, k in ((1, 3), (2, 3), (3, 5)):
        allowed = set(logits[row].topk(k).indices.tolist())
        assert set(a[:, row].tolist()) <= allowed
