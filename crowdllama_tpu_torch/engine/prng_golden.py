"""Golden vectors of ``jax.random`` (JAX 0.9.0, threefry2x32,
partitionable) and of the JAX package's samplers, for the key
``PRNGKey(1234)``, and of the samplers on rows with tied logits.

``tests/test_torch_sampling.py`` recomputes every constant with JAX and
holds the port against them on the CPU; ``chip_smoke.py`` holds the port
against them with the logits on the card (:func:`check`).
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 1234
# jax.random.split(PRNGKey(1234), 3), flattened [3, 2]
SPLIT = [1264997412, 2518116175, 2877103387, 1697627890, 2113592192,
         603280156]
# jax.random.fold_in(PRNGKey(1234), 7) and (..., 2**32 - 1)
FOLD_IN_7 = [3539328958, 3006788168]
FOLD_IN_MAX = [127439262, 1781514768]
# jax.random.bits(PRNGKey(1234), (8,)), uint32
RANDOM_BITS = [3715183467, 3461522409, 1578076316, 3641478021, 607760917,
               2701805931, 3332195204, 1640115702]
# crowdllama_tpu.engine.sampling.sample_tokens_slots(LOGITS, TEMPERATURE,
# TOP_P, split(PRNGKey(1234), 4), top_k=TOP_K) and sample_tokens(...,
# PRNGKey(1234), top_k=TOP_K)
SLOT_TOKENS = [61, 58, 19, 52]
BATCH_TOKENS = [61, 61, 44, 16]
TEMPERATURE = [0.0, 0.7, 1.0, 1.3]
TOP_P = [1.0, 0.9, 0.5, 1.0]
TOP_K = [0, 0, 10, 5]
# sample_tokens_slots(tied_logits(), 0.8, TIED_TOP_P, split(PRNGKey(seed),
# 8), top_k=TIED_TOP_K) for seed 0 .. 5: rows whose top-64 window holds 40
# tied logits, where the window's order of equal values decides the draw.
TIED_TOP_P = [0.9, 0.9, 1.0, 1.0, 0.9, 1.0, 0.9, 1.0]
TIED_TOP_K = [0, 20, 50, 0, 0, 30, 45, 0]
TIED_SLOT_TOKENS = [[429, 125, 332, 502, 96, 359, 192, 497],
                    [231, 152, 387, 403, 168, 331, 289, 109],
                    [139, 0, 387, 357, 201, 193, 220, 162],
                    [347, 111, 194, 60, 27, 276, 26, 30],
                    [111, 235, 221, 60, 27, 193, 151, 340],
                    [97, 180, 0, 193, 207, 386, 428, 414]]


def logits() -> np.ndarray:
    """The sampled logits [4, 100]: exact multiples of 1/8."""
    return (((np.arange(400) * 7919 % 97) - 48).astype(np.float32)
            .reshape(4, 100) / 8)


def tied_logits() -> np.ndarray:
    """[8, 512] logits in [-1, 1) with 40 columns of each row tied at 1.5
    (at scattered indices), above every other."""
    i, j = np.arange(8)[:, None], np.arange(512)[None, :]
    x = (((i * 512 + j) * 7919 % 1009).astype(np.float32) / 1009 - 0.5) * 2
    return np.where((j * 37 + 11 * i) % 512 < 40, np.float32(1.5),
                    x).astype(np.float32)


def check(device) -> dict:
    """Hold ``engine/prng.py`` and the samplers (logits on ``device``)
    against the goldens; raises AssertionError on any mismatch."""
    from crowdllama_tpu_torch.engine import prng
    from crowdllama_tpu_torch.engine.sampling import (
        sample_tokens,
        sample_tokens_slots,
    )

    key = prng.PRNGKey(SEED)
    got = {"split": prng.split(key, 3).ravel().tolist(),
           "fold_in_7": prng.fold_in(key, 7).tolist(),
           "fold_in_max": prng.fold_in(key, 2**32 - 1).tolist(),
           "random_bits": prng.random_bits(key, (8,)).tolist()}
    args = (torch.from_numpy(logits()).to(device),
            torch.tensor(TEMPERATURE, device=device),
            torch.tensor(TOP_P, device=device))
    top_k = torch.tensor(TOP_K, dtype=torch.int32, device=device)
    got["slot_tokens"] = sample_tokens_slots(
        *args, prng.split(key, 4), top_k=top_k).tolist()
    got["batch_tokens"] = sample_tokens(*args, key, top_k=top_k).tolist()
    tied = (torch.from_numpy(tied_logits()).to(device),
            torch.full((8,), 0.8, device=device),
            torch.tensor(TIED_TOP_P, device=device))
    tied_k = torch.tensor(TIED_TOP_K, dtype=torch.int32, device=device)
    got["tied_slot_tokens"] = [sample_tokens_slots(
        *tied, prng.split(prng.PRNGKey(seed), 8), top_k=tied_k).tolist()
        for seed in range(len(TIED_SLOT_TOKENS))]
    want = {"split": SPLIT, "fold_in_7": FOLD_IN_7,
            "fold_in_max": FOLD_IN_MAX, "random_bits": RANDOM_BITS,
            "slot_tokens": SLOT_TOKENS, "batch_tokens": BATCH_TOKENS,
            "tied_slot_tokens": TIED_SLOT_TOKENS}
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise AssertionError(f"threefry goldens differ (got, want): {bad}")
    return got
