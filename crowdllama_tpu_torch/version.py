"""Version information (counterpart of ``crowdllama_tpu/version.py``):
packaging sets the env vars; the version string is the ``version`` field
of advertised peer metadata."""

from __future__ import annotations

import os

VERSION = os.environ.get("CROWDLLAMA_TPU_VERSION", "0.1.0-dev")
COMMIT_HASH = os.environ.get("CROWDLLAMA_TPU_COMMIT", "unknown")
BUILD_DATE = os.environ.get("CROWDLLAMA_TPU_BUILD_DATE", "unknown")


def version_string() -> str:
    """Human-readable version banner."""
    return (f"crowdllama-tpu-torch {VERSION} (commit {COMMIT_HASH}, "
            f"built {BUILD_DATE})")
