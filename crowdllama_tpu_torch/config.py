"""Engine configuration: the fields of ``crowdllama_tpu/config.py``
``Configuration`` that the ported engine reads, under the same names and
defaults.  ``kv_layout`` and ``kv_dtype`` are normalized and checked as
the JAX package checks them; which combinations serve is
``engine/plan.py``'s decision."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Configuration:
    model: str = "tinyllama-1.1b"
    model_path: str = ""  # empty = random-init weights (only mode ported)
    max_batch_slots: int = 8
    max_context_length: int = 2048
    decode_chunk: int = 8  # decode steps per device dispatch
    # "paged": page pool + prefix cache (the default); "contiguous":
    # [L, B, Hkv, S, Dh] per slot, decode through kernel D.
    kv_layout: str = "paged"
    # "bf16" or "int8": int8 KV with per-(position, kv head) scales, on
    # both layouts (paged: kernels B and C read the int8 pages).
    kv_dtype: str = "bf16"
    quantize: str = ""  # "" = bf16 weights (only mode ported)
    spec_decode: str = ""  # "" = no speculation (only mode ported)
    # "" = one device (paged: tp over the visible CUDA devices the kv heads
    # divide, 1 on a one-card machine); "2" = tp=2 (paged only; the other
    # axes are not ported).  TorchEngine(devices=...) places the tp ranks.
    mesh_shape: str = ""
    kv_page_size: int = 128
    kv_pool_tokens: int = 0  # 0 = slots x context (no overcommit)
    kv_prefix_cache: bool = True
    # Unified ragged batch: long prompts prefill inside the decode dispatch
    # in chunks of (step_token_budget - max_batch_slots) tokens; 0 = auto
    # (prefill_chunk + max_batch_slots).  Off (or the contiguous layout):
    # long prompts admit through legacy chunked prefill.
    ragged_prefill: bool = True
    step_token_budget: int = 0
    warmup: bool = True  # run each serving path once at engine start
    admission_pending_max: int = 0  # 0 = no load-shedding threshold
    # Directory ``capture_profile`` writes its traces under; "" = off.
    profile_dir: str = ""

    def __post_init__(self) -> None:
        self.kv_layout = (self.kv_layout or "contiguous").strip().lower()
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv layout {self.kv_layout!r} "
                             "(want 'contiguous' or 'paged')")
        self.kv_dtype = (self.kv_dtype or "bf16").strip().lower()
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv dtype {self.kv_dtype!r} "
                             "(want 'bf16' or 'int8')")
