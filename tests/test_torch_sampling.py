"""The port's threefry PRNG and samplers against ``jax.random`` and the JAX
package's samplers.

Keys, split, fold_in, random bits and uniforms must equal JAX bit for bit;
gumbel noise within 1 ulp of |g| <= 16 (2.4e-7: the ``log`` of the
transform differs by at most one ulp between math libraries); categorical
draws and sampled tokens must be equal (integers).  Inputs come from numpy
seeds.  The seeds of ``_req_key`` cover both sides of bit 31, bit 63, a
negative seed and 2**64 (which reduces to 0); seed 0 itself means
"unseeded" to both schedulers, so its key is built from ``PRNGKey(0)``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine import sampling as JS  # noqa: E402
from crowdllama_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from crowdllama_tpu_torch.engine import prng  # noqa: E402
from crowdllama_tpu_torch.engine import prng_golden as golden  # noqa: E402
from crowdllama_tpu_torch.engine import sampling as S  # noqa: E402
from crowdllama_tpu_torch.engine.scheduler import Scheduler  # noqa: E402

GUMBEL_ATOL = 2.4e-7
SEEDS = [0, 1, 2**31 - 1, 2**31, 2**63 + 5, -7, 2**64]


def _keys_for(seed: int, lane: int):
    if seed == 0:
        return (prng.fold_in(prng.PRNGKey(0), lane),
                np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), lane)))
    req = types.SimpleNamespace(seed=seed)
    want = np.asarray(JaxScheduler._req_key(None, req, lane))
    got = Scheduler._req_key(None, req, lane)
    return got, want


@pytest.mark.parametrize("seed", SEEDS)
def test_req_key_and_threefry_match_jax(seed):
    for lane in (0, 1):
        got, want = _keys_for(seed, lane)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    key, jkey = got, jnp.asarray(want)
    np.testing.assert_array_equal(prng.split(key, 5),
                                  np.asarray(jax.random.split(jkey, 5)))
    for d in (0, 3, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(key, d), np.asarray(jax.random.fold_in(jkey, d)))
    np.testing.assert_array_equal(prng.random_bits(key, (3, 67)),
                                  np.asarray(jax.random.bits(jkey, (3, 67))))
    np.testing.assert_array_equal(
        prng.uniform(key, (512,)), np.asarray(jax.random.uniform(jkey, (512,))))
    np.testing.assert_array_equal(
        prng.uniform(key, (512,), prng.TINY, 1.0),
        np.asarray(jax.random.uniform(jkey, (512,), minval=prng.TINY)))
    np.testing.assert_allclose(prng.gumbel(key, (4, 64)),
                               np.asarray(jax.random.gumbel(jkey, (4, 64))),
                               rtol=0, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_prngkey_and_batched_split_match_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 8))
    carry, sub = S.split_slot_keys(keys)
    jc, js = JS.split_slot_keys(jnp.asarray(keys))
    np.testing.assert_array_equal(carry, np.asarray(jc))
    np.testing.assert_array_equal(sub, np.asarray(js))
    for slot in (0, 5):
        np.testing.assert_array_equal(S.default_slot_key(slot),
                                      np.asarray(JS.default_slot_key(slot)))


def _filter_case(seed, rows=256, vocab=512):
    """Random logits and per-row sampling parameters (some rows greedy,
    some with top-k / top-p cutting the window to -inf)."""
    r = np.random.default_rng(seed)
    logits = (3 * r.standard_normal((rows, vocab))).astype(np.float32)
    temp = r.uniform(0.2, 1.5, rows).astype(np.float32)
    temp[r.random(rows) < 0.2] = 0.0
    top_p = np.where(r.random(rows) < 0.5, 1.0,
                     r.uniform(0.3, 0.95, rows)).astype(np.float32)
    top_k = np.where(r.random(rows) < 0.5, 0,
                     r.integers(1, 64, rows)).astype(np.int32)
    return logits, temp, top_p, top_k


def test_categorical_matches_jax_on_filtered_rows():
    """Rows from the top-k/top-p filter carry -inf entries; one key for
    the batch and one key per row both pick JAX's indices."""
    logits, temp, top_p, top_k = _filter_case(3)
    filtered, _, _ = JS._nucleus_filter(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p),
        S.TOPK_WINDOW, top_k=jnp.asarray(top_k))
    filtered = np.asarray(filtered)
    assert np.isneginf(filtered).any()
    key = prng.PRNGKey(11)
    np.testing.assert_array_equal(
        prng.categorical(key, filtered),
        np.asarray(jax.random.categorical(jnp.asarray(key), filtered)))
    keys = prng.split(key, filtered.shape[0])
    want = jax.vmap(jax.random.categorical)(jnp.asarray(keys), filtered)
    got = np.argmax(prng.gumbel(keys, (filtered.shape[1],)) + filtered, -1)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("per_row", [True, False])
def test_sample_tokens_match_jax_on_random_rows(per_row):
    logits, temp, top_p, top_k = _filter_case(5)
    key = prng.PRNGKey(7)
    targs = (torch.from_numpy(logits), torch.from_numpy(temp),
             torch.from_numpy(top_p))
    jargs = (jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p))
    if per_row:
        keys = prng.split(key, logits.shape[0])
        got = S.sample_tokens_slots(*targs, keys,
                                    top_k=torch.from_numpy(top_k))
        want = JS.sample_tokens_slots(*jargs, jnp.asarray(keys),
                                      top_k=jnp.asarray(top_k))
    else:
        got = S.sample_tokens(*targs, key, top_k=torch.from_numpy(top_k))
        want = JS.sample_tokens(*jargs, jnp.asarray(key),
                                top_k=jnp.asarray(top_k))
    assert (temp > 0).sum() > 150  # most rows actually sample
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_goldens_are_jax_and_the_port_reproduces_them():
    """The committed goldens (also checked on the card by chip_smoke.py)
    are what JAX computes, and the port's samplers give them."""
    key = jax.random.PRNGKey(golden.SEED)
    assert np.asarray(jax.random.split(key, 3)).ravel().tolist() == golden.SPLIT
    assert np.asarray(jax.random.fold_in(key, 7)).tolist() == golden.FOLD_IN_7
    assert (np.asarray(jax.random.fold_in(key, 2**32 - 1)).tolist()
            == golden.FOLD_IN_MAX)
    assert (np.asarray(jax.random.bits(key, (8,))).tolist()
            == golden.RANDOM_BITS)
    args = (jnp.asarray(golden.logits()), jnp.asarray(golden.TEMPERATURE),
            jnp.asarray(golden.TOP_P))
    top_k = jnp.asarray(golden.TOP_K, jnp.int32)
    assert (np.asarray(JS.sample_tokens_slots(
        *args, jax.random.split(key, 4), top_k=top_k)).tolist()
        == golden.SLOT_TOKENS)
    assert (np.asarray(JS.sample_tokens(*args, key, top_k=top_k)).tolist()
            == golden.BATCH_TOKENS)
    golden.check("cpu")


def _tied_case(seed, rows=8, vocab=512, tied=40):
    """Rows whose top-64 window holds ``tied`` columns tied at 1.5 (above
    every other logit), at scattered indices."""
    r = np.random.default_rng(seed)
    logits = r.standard_normal((rows, vocab)).astype(np.float32)
    for i in range(rows):
        logits[i, r.choice(vocab, tied, replace=False)] = 1.5
    temp = np.full((rows,), 0.8, np.float32)
    return logits, temp


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("cut", ["top_p", "top_k"])
def test_sample_tokens_match_jax_on_tied_rows(per_row, cut):
    """Tied logits in the window: the port's window must order ties as
    ``jax.lax.top_k`` does (lower index first), so every seeded draw lands
    on JAX's token.  50 seeds x 8 rows, with a nucleus cut (top_p 0.9) or
    a top-k cut (k 50, inside the tie block's end at rank 40 and past
    it)."""
    logits, temp = _tied_case(17)
    rows = logits.shape[0]
    top_p = np.full((rows,), 0.9 if cut == "top_p" else 1.0, np.float32)
    top_k = np.full((rows,), 50 if cut == "top_k" else 0, np.int32)
    top_k[::2] = 20 if cut == "top_k" else 0
    targs = (torch.from_numpy(logits), torch.from_numpy(temp),
             torch.from_numpy(top_p))
    jargs = (jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p))
    for seed in range(50):
        key = prng.PRNGKey(seed)
        if per_row:
            keys = prng.split(key, rows)
            got = S.sample_tokens_slots(*targs, keys,
                                        top_k=torch.from_numpy(top_k))
            want = JS.sample_tokens_slots(*jargs, jnp.asarray(keys),
                                          top_k=jnp.asarray(top_k))
        else:
            got = S.sample_tokens(*targs, key, top_k=torch.from_numpy(top_k))
            want = JS.sample_tokens(*jargs, jnp.asarray(key),
                                    top_k=jnp.asarray(top_k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nucleus_window_orders_ties_as_jax_top_k():
    logits, temp = _tied_case(3)
    ones = np.ones_like(temp)
    _, idx, _ = S._nucleus_filter(torch.from_numpy(logits),
                                  torch.from_numpy(temp),
                                  torch.from_numpy(ones), S.TOPK_WINDOW)
    _, jidx = jax.lax.top_k(jnp.asarray(logits), S.TOPK_WINDOW)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))



def test_tied_goldens_are_jax():
    """The tied-row goldens (held on the card by chip_smoke.py and
    tests/test_torch_card.py) are JAX's draws."""
    args = (jnp.asarray(golden.tied_logits()), jnp.full((8,), 0.8),
            jnp.asarray(golden.TIED_TOP_P))
    top_k = jnp.asarray(golden.TIED_TOP_K, jnp.int32)
    for seed, want in enumerate(golden.TIED_SLOT_TOKENS):
        keys = jax.random.split(jax.random.PRNGKey(seed), 8)
        assert np.asarray(JS.sample_tokens_slots(
            *args, keys, top_k=top_k)).tolist() == want
