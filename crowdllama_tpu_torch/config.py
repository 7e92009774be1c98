"""Engine configuration: the fields of ``crowdllama_tpu/config.py``
``Configuration`` that the ported engine reads, under the same names and
defaults."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Configuration:
    model: str = "tinyllama-1.1b"
    model_path: str = ""  # empty = random-init weights (only mode ported)
    max_batch_slots: int = 8
    max_context_length: int = 2048
    decode_chunk: int = 8  # decode steps per device dispatch
    kv_page_size: int = 128
    kv_pool_tokens: int = 0  # 0 = slots x context (no overcommit)
    kv_prefix_cache: bool = True
    # Unified ragged batch: long prompts prefill inside the decode dispatch
    # in chunks of (step_token_budget - max_batch_slots) tokens; 0 = auto
    # (prefill_chunk + max_batch_slots).
    ragged_prefill: bool = True
    step_token_budget: int = 0
    warmup: bool = True  # run each serving path once at engine start
    admission_pending_max: int = 0  # 0 = no load-shedding threshold
