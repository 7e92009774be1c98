"""The worker CLI (counterpart of ``crowdllama_tpu/cli``)."""
