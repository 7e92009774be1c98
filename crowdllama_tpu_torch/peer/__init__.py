"""The worker peer (counterpart of ``crowdllama_tpu/peer``)."""
