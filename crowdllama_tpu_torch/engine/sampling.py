"""Sampling: greedy / temperature / top-k / nucleus (top-p), per slot.

Counterpart of ``crowdllama_tpu/engine/sampling.py``.  The nucleus filter
works on the top-``window`` logits, top-k applied before top-p; greedy
(temperature 0) is an exact argmax.  A sampled row draws with JAX's
``categorical``: argmax of the filtered logits plus gumbel noise from a
threefry key (``engine/prng.py``), so a seeded request samples the same
tokens here as on the JAX package.  Keys are [2] / [B, 2] numpy uint32
pairs; the noise is made on the host and copied to the logits' device.
"""

from __future__ import annotations

import numpy as np
import torch

from crowdllama_tpu_torch.engine import prng

TOPK_WINDOW = 64
#: repeat-penalty lookback (Ollama repeat_last_n default)
REPEAT_LAST_N = 64


def apply_repeat_penalty(logits: torch.Tensor, recent: torch.Tensor,
                         penalty: torch.Tensor) -> torch.Tensor:
    """llama.cpp-style presence penalty over the last-N tokens.

    logits [B, V]; recent [B, N] token ids (entries >= V are padding);
    penalty [B] (values <= 0 or == 1 disable).  Positive logits divide by
    the penalty, negative multiply."""
    b, v = logits.shape
    presence = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    presence.scatter_(1, recent.clamp(0, v).long(), True)
    presence = presence[:, :v]
    pen = torch.where(penalty > 0, penalty,
                      torch.ones_like(penalty)).float()[:, None]
    adj = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(presence & (pen != 1.0), adj, logits)


def split_slot_keys(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-slot key split: keys [B, 2] -> (carry [B, 2], sub [B, 2]), as
    ``jax.vmap(jax.random.split)``."""
    pair = prng.split(keys)  # [B, 2, 2]
    return pair[:, 0], pair[:, 1]


def default_slot_key(slot: int) -> np.ndarray:
    """Deterministic per-slot key for direct runner callers that do not
    plumb a request seed: ``fold_in(PRNGKey(0), slot)``."""
    return prng.fold_in(prng.PRNGKey(0), slot)


def noise_width(vocab: int, window: int = TOPK_WINDOW) -> int:
    """Candidates per row that a draw ranks (the filter's window)."""
    return min(window, vocab)


def _nucleus_filter(logits, temperature, top_p, window: int, top_k=None):
    """Top-k + nucleus filtering: returns (filtered [B, W] scaled logits,
    top_idx [B, W], greedy [B]).  ``top_k`` [B] int (0 disables; the
    window truncation still applies)."""
    greedy = logits.argmax(dim=-1)
    temp = temperature.clamp_min(1e-6)[:, None]
    window = min(window, logits.shape[-1])
    # A stable descending sort puts the lower index first among equal
    # logits, as ``jax.lax.top_k`` does (``topk``'s tie order is not
    # defined), so tied rows draw the same tokens as the JAX package.
    top_logits, top_idx = logits.sort(dim=-1, descending=True, stable=True)
    top_logits, top_idx = top_logits[:, :window], top_idx[:, :window]
    scaled = top_logits / temp
    neg_inf = torch.full_like(scaled, float("-inf"))
    if top_k is not None:
        limit = torch.where(top_k > 0, top_k.clamp(max=window),
                            torch.full_like(top_k, window))
        ranks = torch.arange(window, device=logits.device)[None, :]
        scaled = torch.where(ranks < limit[:, None], scaled, neg_inf)
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens while the exclusive cumulative probability < top_p; the
    # top token always survives (its exclusive cumsum is 0).
    keep = (cum - probs) < top_p[:, None]
    return torch.where(keep, scaled, neg_inf), top_idx, greedy


def sample_with_noise(logits: torch.Tensor, temperature: torch.Tensor,
                      top_p: torch.Tensor, noise: torch.Tensor | None,
                      window: int = TOPK_WINDOW,
                      top_k: torch.Tensor | None = None) -> torch.Tensor:
    """One token per row of logits [B, V] (fp32): argmax where temperature
    is 0, else ``argmax(filtered + noise)`` with gumbel ``noise`` [B, W]
    (None when no row samples: every row is then greedy)."""
    if noise is None:
        return logits.argmax(dim=-1).to(torch.int32)
    filtered, top_idx, greedy = _nucleus_filter(logits, temperature, top_p,
                                                window, top_k=top_k)
    choice = (filtered + noise).argmax(dim=-1)
    sampled = top_idx.gather(-1, choice[:, None])[:, 0]
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def sample_tokens_slots(logits: torch.Tensor, temperature: torch.Tensor,
                        top_p: torch.Tensor, keys: np.ndarray,
                        window: int = TOPK_WINDOW,
                        top_k: torch.Tensor | None = None) -> torch.Tensor:
    """Like :func:`sample_tokens` with an independent key per row (keys
    [B, 2]): row i's noise is ``gumbel(keys[i], (W,))``."""
    w = noise_width(logits.shape[-1], window)
    noise = torch.from_numpy(prng.gumbel(keys, (w,))).to(logits.device)
    return sample_with_noise(logits, temperature, top_p, noise, window,
                             top_k=top_k)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, key: np.ndarray | None,
                  window: int = TOPK_WINDOW,
                  top_k: torch.Tensor | None = None) -> torch.Tensor:
    """One key for the whole batch (a prompt's first token): the noise is
    ``gumbel(key, (B, W))``.  ``key`` None means every row is greedy."""
    noise = None
    if key is not None:
        w = noise_width(logits.shape[-1], window)
        noise = torch.from_numpy(
            prng.gumbel(key, (logits.shape[0], w))).to(logits.device)
    return sample_with_noise(logits, temperature, top_p, noise, window,
                             top_k=top_k)
