"""The consumer's Ollama- and OpenAI-compatible HTTP gateway."""

from crowdllama_tpu_torch.gateway.gateway import Gateway  # noqa: F401
