"""Unix-socket IPC surface for desktop-app embedding."""

from crowdllama_tpu_torch.ipc.server import IPCServer  # noqa: F401
