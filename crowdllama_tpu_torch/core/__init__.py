"""The wire layer: the llama.v1 codec without protobuf, framing and
message helpers (counterpart of ``crowdllama_tpu/core``)."""
