"""Sampling: greedy / temperature / top-k / nucleus (top-p), per slot.

Counterpart of ``crowdllama_tpu/engine/sampling.py``.  The nucleus filter
works on the top-``window`` logits, top-k applied before top-p; greedy
(temperature 0) is an exact argmax.  A sampled row draws its uniform from
its own ``torch.Generator`` (seeded per request by the scheduler), so a
seeded request reproduces on this package; the draws are not the JAX
package's threefry bits.
"""

from __future__ import annotations

import torch

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


def _nucleus_filter(logits, temperature, top_p, window: int, top_k=None):
    """Top-k + nucleus filtering: returns (filtered [B, W] scaled logits,
    top_idx [B, W], greedy [B]).  ``top_k`` [B] int (0 disables; the
    window truncation still applies)."""
    greedy = logits.argmax(dim=-1)
    temp = temperature.clamp_min(1e-6)[:, None]
    window = min(window, logits.shape[-1])
    top_logits, top_idx = logits.topk(window, dim=-1)  # [B, W] descending
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


def sample_tokens_slots(logits: torch.Tensor, temperature: torch.Tensor,
                        top_p: torch.Tensor,
                        generators: list[torch.Generator | None],
                        window: int = TOPK_WINDOW,
                        top_k: torch.Tensor | None = None) -> torch.Tensor:
    """One token per row of logits [B, V] (fp32): argmax where
    temperature is 0, else a draw from the filtered distribution using row
    i's ``generators[i]`` (rows without a generator must be greedy)."""
    filtered, top_idx, greedy = _nucleus_filter(logits, temperature, top_p,
                                                window, top_k=top_k)
    dev = logits.device
    u = torch.stack([
        torch.rand((), generator=g, device=dev) if g is not None
        else torch.zeros((), device=dev) for g in generators])
    cdf = torch.cumsum(torch.softmax(filtered, dim=-1), dim=-1)
    choice = (cdf < u[:, None]).sum(dim=-1).clamp(max=filtered.shape[-1] - 1)
    sampled = top_idx.gather(-1, choice[:, None])[:, 0]
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
