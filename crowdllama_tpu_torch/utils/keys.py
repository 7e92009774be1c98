"""Ed25519 identity key management.

Counterpart of ``crowdllama_tpu/utils/keys.py``: one Ed25519 identity per
component at ``~/.crowdllama-tpu/<component>.key`` (a 0700 directory, a
0600 file of the raw 32-byte seed), get-or-create under a lock so
concurrent starts produce exactly one key.  The file format and the peer
id derivation are the JAX package's, so a node keeps its peer id across
the two packages.
"""

from __future__ import annotations

import hashlib
import os
import threading
from pathlib import Path

from crowdllama_tpu_torch.utils.crypto import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

DEFAULT_DIR = Path(os.environ.get("CROWDLLAMA_TPU_HOME",
                                  "~/.crowdllama-tpu")).expanduser()


def peer_id_from_public_key(pub: Ed25519PublicKey) -> str:
    """Stable peer ID: hex SHA-256 of the raw public key, truncated to 40
    chars."""
    return hashlib.sha256(pub.public_bytes_raw()).hexdigest()[:40]


def peer_id_to_dht_id(peer_id: str) -> bytes:
    """Map a peer ID into the 256-bit DHT keyspace."""
    return hashlib.sha256(b"crowdllama-tpu:peer:" + peer_id.encode()).digest()


class KeyManager:
    """Get-or-create Ed25519 identities on disk."""

    def __init__(self, base_dir: str | os.PathLike | None = None):
        self.base_dir = Path(base_dir).expanduser() if base_dir else DEFAULT_DIR
        self._mu = threading.Lock()

    def key_path(self, component: str) -> Path:
        return self.base_dir / f"{component}.key"

    def get_or_create_private_key(self, component: str) -> Ed25519PrivateKey:
        with self._mu:
            path = self.key_path(component)
            if path.exists():
                return self._load(path)
            self.base_dir.mkdir(parents=True, exist_ok=True)
            os.chmod(self.base_dir, 0o700)
            key = Ed25519PrivateKey.generate()
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            except FileExistsError:
                # Another process won the race; use its key.
                return self._load(path)
            try:
                os.write(fd, key.private_bytes_raw())
            finally:
                os.close(fd)
            return key

    def load_private_key(self, component: str) -> Ed25519PrivateKey:
        path = self.key_path(component)
        if not path.exists():
            raise FileNotFoundError(
                f"no key for component {component!r} at {path}")
        return self._load(path)

    @staticmethod
    def _load(path: Path) -> Ed25519PrivateKey:
        raw = path.read_bytes()
        if len(raw) != 32:
            raise ValueError(f"invalid key file {path}: expected 32 raw "
                             f"bytes, got {len(raw)}")
        return Ed25519PrivateKey.from_private_bytes(raw)

    def peer_id(self, component: str) -> str:
        """Peer ID of an on-disk key, for logs."""
        return peer_id_from_public_key(
            self.load_private_key(component).public_key())
