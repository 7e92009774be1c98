"""Test and chaos helpers (counterpart of ``crowdllama_tpu/testing``)."""
