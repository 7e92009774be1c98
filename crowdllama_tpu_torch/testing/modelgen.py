"""Synthetic checkpoints with engineered decode behaviour.

Counterpart of ``crowdllama_tpu/testing/modelgen.py``.  Random-init
models have ulp-scale logit gaps, so greedy argmax flips between
numerically distinct but equivalent paths (prefill, the decode step, the
speculative verify forward): a check of token identity across paths
becomes a lottery.  The weights here have O(1) margins by construction,
so path-stable greedy decode is a property of the checkpoint.

:func:`permutation_params` zeroes the attention and MLP outputs
(``wo = w_down = 0``), so the residual stream is exactly the input
token's embedding, and makes the unembedding column of pi(t) the unit
embedding of t: greedy decode walks the fixed cycle pi over the
non-special vocabulary (pi(t) is the next non-special id after t).  The
embeddings are the JAX package's (``numpy.random.default_rng(0)``), so
both packages' permutation models decode the same stream; the other
weights come from the port's own random init.
"""

from __future__ import annotations

import numpy as np
import torch

from crowdllama_tpu_torch.engine.tokenizer import ByteTokenizer
from crowdllama_tpu_torch.engine.weights import init_params, save_params
from crowdllama_tpu_torch.models.config import ModelConfig, get_config

_SPECIALS = (ByteTokenizer.PAD, ByteTokenizer.BOS, ByteTokenizer.EOS)


def permutation_next(vocab: int) -> np.ndarray:
    """pi as an array: ``nxt[t]`` for every id (specials map to
    themselves; they never drive an emitted prediction)."""
    allowed = np.array([t for t in range(vocab) if t not in _SPECIALS])
    nxt = np.arange(vocab)
    nxt[allowed] = np.roll(allowed, -1)
    return nxt


def permutation_params(mcfg: ModelConfig, dtype: torch.dtype = torch.float32,
                       device: torch.device | str = "cpu",
                       seed: int = 0) -> dict:
    """Weights whose greedy decode walks pi, in ``dtype`` on ``device``.
    The margin check (every non-special id's argmax is pi of it, after the
    cast to ``dtype``) runs on ``device`` in row blocks."""
    if mcfg.tie_word_embeddings:
        raise ValueError("permutation weights need an untied lm_head")
    dim, vocab = mcfg.hidden_size, mcfg.vocab_size
    params = init_params(mcfg, seed=seed, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((vocab, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    nxt = permutation_next(vocab)
    allowed = np.array([t for t in range(vocab) if t not in _SPECIALS])
    emb_t = torch.from_numpy(emb).to(device)
    lm = torch.zeros((dim, vocab), dtype=torch.float32, device=device)
    lm[:, torch.from_numpy(nxt[allowed]).to(device)] = emb_t[
        torch.from_numpy(allowed).to(device)].T
    params["embed"] = emb_t.to(dtype)
    params["lm_head"] = lm.to(dtype)
    params["final_norm"] = torch.ones((dim,), dtype=dtype, device=device)
    params["layers"]["wo"].zero_()
    params["layers"]["w_down"].zero_()
    # RMSNorm(emb[t]) = emb[t] * sqrt(dim) (unit rows); its argmax over
    # the cast lm_head must be pi(t).
    emb_c, lm_c = params["embed"].float(), params["lm_head"].float()
    ids = torch.from_numpy(allowed).to(device)
    want = torch.from_numpy(nxt[allowed]).to(device)
    for i in range(0, len(allowed), 4096):
        rows = emb_c[ids[i:i + 4096]] * dim ** 0.5
        if not torch.equal((rows @ lm_c).argmax(-1), want[i:i + 4096]):
            raise AssertionError("permutation not dominant")
    return params


def permutation_checkpoint(model: str, out_dir, max_context: int = 256,
                           layers: int | None = None) -> str:
    """Write a native checkpoint of :func:`permutation_params` for
    ``model`` (``layers`` cuts its depth) into ``out_dir``; returns its
    path as a string."""
    cut = {} if layers is None else {"num_layers": layers}
    mcfg = get_config(model, max_context_length=max_context, **cut)
    save_params(mcfg, permutation_params(mcfg), out_dir,
                {"note": "permutation test model (testing/modelgen.py)"})
    return str(out_dir)
