"""Rotary position embeddings (half-rotation layout, HF-compatible).

Counterpart of ``crowdllama_tpu/ops/rope.py``.
"""

from __future__ import annotations

import math

import torch


def rope_table(max_len: int, head_dim: int, theta: float, scaling=None,
               device: torch.device | str = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin) tables of shape [max_len, head_dim//2], fp32.

    ``scaling`` is a ``models.config.RopeScaling`` (or None): "llama3"
    applies the Llama-3.1 frequency-dependent long-context scaling (low
    frequencies divided by ``factor``, high frequencies untouched, a smooth
    ramp between); "linear" divides every frequency.
    """
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is not None:
        if scaling.rope_type == "linear":
            inv_freq = inv_freq / scaling.factor
        elif scaling.rope_type == "llama3":
            old_len = float(scaling.original_max_position_embeddings)
            low_wavelen = old_len / scaling.low_freq_factor
            high_wavelen = old_len / scaling.high_freq_factor
            wavelen = 2.0 * math.pi / inv_freq
            smooth = ((old_len / wavelen - scaling.low_freq_factor)
                      / (scaling.high_freq_factor - scaling.low_freq_factor))
            smoothed = ((1.0 - smooth) * inv_freq / scaling.factor
                        + smooth * inv_freq)
            inv_freq = torch.where(
                wavelen > low_wavelen, inv_freq / scaling.factor,
                torch.where(wavelen < high_wavelen, inv_freq, smoothed))
        else:  # pragma: no cover - rejected at config parse
            raise ValueError(f"unknown rope scaling {scaling.rope_type!r}")
    pos = torch.arange(max_len, dtype=torch.float32)
    angles = torch.outer(pos, inv_freq)  # [T, Dh/2]
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., T, H, Dh] by per-token ``positions`` [..., T]."""
    dtype = x.dtype
    c = cos[positions].unsqueeze(-2)  # [..., T, 1, Dh/2]
    s = sin[positions].unsqueeze(-2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)
