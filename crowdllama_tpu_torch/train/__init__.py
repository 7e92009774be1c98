"""Training: draft-model distillation for speculative decoding."""
