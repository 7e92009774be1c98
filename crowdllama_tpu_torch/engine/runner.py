"""ModelRunner: the serving surface the paged runner builds on.

Counterpart of the one-device part of ``crowdllama_tpu/engine/runner.py``
``ModelRunner``: the parameters, the prefill buckets, bucketed monolithic
prefill with first-token sampling, and the decode-chunk readback.  The
KV layout (insert, release, the decode step) belongs to the subclass
(``engine/paged.py``).  No mesh, sequence/pipeline parallelism or
contiguous cache here; those are not ported yet.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device, construction raises.
"""

from __future__ import annotations

import numpy as np
import torch

from crowdllama_tpu_torch.engine.sampling import (
    REPEAT_LAST_N,
    apply_repeat_penalty,
    sample_tokens_slots,
)
from crowdllama_tpu_torch.engine.weights import init_params
from crowdllama_tpu_torch.models import transformer as T
from crowdllama_tpu_torch.models.config import ModelConfig
from crowdllama_tpu_torch.ops.attention import prefill_attention


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device a runner serves on: ``device`` as given, else CUDA.
    Never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def prefill_buckets(max_seq: int) -> list[int]:
    buckets, b = [], 32
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return buckets


class ModelRunner:
    #: the scheduler admits prompts longer than this through the unified
    #: ragged step (engine/paged.py) instead of one monolithic prefill
    prefill_chunk = 512

    def __init__(self, cfg: ModelConfig, params: dict | None = None,
                 max_slots: int = 8, max_seq: int = 0,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_seq = max_seq or cfg.max_context_length
        if params is None:
            params = init_params(cfg, seed, dtype=dtype, device=self.device)
        self.params = params
        self.dtype = params["embed"].dtype
        self.buckets = prefill_buckets(self.max_seq)
        self.windows = T.layer_sliding_windows(cfg)
        self.scale = T.attn_scale(cfg)
        self.cos, self.sin = T.rope_for(cfg, self.device)
        #: no-context prefill attention (kernel A's dispatch); a seam that
        #: lets a caller run the same step through the plain version
        self.prefill_attn = prefill_attention

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_seq {self.max_seq}")

    def _recent_from_prompt(self, prompt_ids: list[int],
                            first_token: int | None = None,
                            plen: int | None = None) -> np.ndarray:
        """Last-N ring seeded from the prompt tail (+ the first sampled
        token at sequence position plen), padded with vocab_size (never
        penalized).  Token at position ``pos`` lives in slot ``pos % N``."""
        row = np.full((REPEAT_LAST_N,), self.cfg.vocab_size, np.int32)
        plen = len(prompt_ids) if plen is None else plen
        seq = {plen - len(prompt_ids) + i: t for i, t in enumerate(prompt_ids)}
        if first_token is not None:
            seq[plen] = first_token
        for pos in sorted(seq)[-REPEAT_LAST_N:]:
            row[pos % REPEAT_LAST_N] = seq[pos]
        return row

    def _sample_first(self, logits: torch.Tensor, prompt_ids: list[int],
                      temperature: float, top_p: float, generator,
                      top_k: int, repeat_penalty: float) -> int:
        """Sample a prompt's first token from its last logits row [1, V]."""
        dev = self.device
        logits = apply_repeat_penalty(
            logits,
            torch.as_tensor(self._recent_from_prompt(prompt_ids),
                            device=dev)[None],
            torch.tensor([repeat_penalty], dtype=torch.float32, device=dev))
        tok = sample_tokens_slots(
            logits, torch.tensor([temperature], device=dev),
            torch.tensor([top_p], device=dev), [generator],
            top_k=torch.tensor([top_k], dtype=torch.int32, device=dev))
        return int(tok[0])

    def _padded(self, ids: list[int], width: int) -> torch.Tensor:
        tokens = np.zeros((1, width), np.int64)
        tokens[0, :len(ids)] = ids
        return torch.from_numpy(tokens).to(self.device)

    @torch.inference_mode()
    def prefill(self, prompt_ids: list[int], temperature: float,
                top_p: float, generator=None, state=None, top_k: int = 0,
                repeat_penalty: float = 1.0):
        """Bucketed monolithic prefill; returns (first_token, ks, vs, plen)
        with ks/vs [L, 1, Hkv, bucket, Dh].  Padding positions clamp to
        plen-1 and ``kv_valid`` excludes them."""
        plen = len(prompt_ids)
        bucket = self.bucket_for(plen)
        ar = torch.arange(bucket, device=self.device, dtype=torch.int32)
        positions = torch.clamp(ar, max=plen - 1)[None]
        kv_valid = (ar < plen)[None]
        x = T._embed(self.params, self.cfg, self._padded(prompt_ids, bucket))
        x, ks, vs = T.scan_prefill_layers(
            self.params["layers"], self.windows, self.cfg, x, positions,
            kv_valid=kv_valid, attention=self.prefill_attn)
        logits = T._unembed(self.params, self.cfg, x[:, plen - 1])
        tok = self._sample_first(logits, prompt_ids, temperature, top_p,
                                 generator, top_k, repeat_penalty)
        return tok, ks, vs, plen

    def decode_steps(self, state, num_steps: int = 1):
        """Run ``num_steps`` decode steps; returns (tokens [K, B] numpy,
        state)."""
        tokens, state = self.decode_steps_device(state, num_steps)
        return tokens.cpu().numpy(), state
