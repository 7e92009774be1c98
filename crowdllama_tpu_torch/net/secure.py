"""Authenticated encryption for host streams (X25519 + ChaCha20-Poly1305).

Counterpart of ``crowdllama_tpu/net/secure.py``.  Each signed hello of the handshake
(``net/host.py``) carries an ephemeral X25519 key bound to the peer's
identity by the Ed25519 signature; both sides HKDF the ECDH secret into
two directional ChaCha20-Poly1305 keys (``derive_keys``: the JAX
package's salt and ``v2`` info).  Every byte after the handshake crosses
the wire as AEAD frames, ``4-byte BE ciphertext length || ciphertext``,
nonce = the 96-bit big-endian frame counter of its direction.
Tampering, truncation mid-frame and replay (counter reuse) fail the tag
and surface as ``TamperError``, a ``ConnectionResetError``, so every
wire-error handler treats it as a dead stream.  An empty plaintext frame
is the authenticated close.

Each direction seals through a native session (``native.AeadSession``,
the C++ ChaCha20-Poly1305 of ``native/_src``) when the library is
loaded, and through ``utils/crypto.py`` otherwise, with the fallback
counted (``native.record_fallback("aead")``).  The two paths put the same
bytes on the wire and share the counter semantics: one nonce a frame,
advanced on a successful open and on a failed tag alike.

The adapters expose the part of the asyncio Stream{Reader,Writer}
surface the protocol code uses (readexactly / read / at_eof, write /
drain / write_eof / close / is_closing).
"""

from __future__ import annotations

import asyncio
import time

from crowdllama_tpu_torch import native
from crowdllama_tpu_torch.utils.crypto import (
    ChaCha20Poly1305,
    InvalidTag,
    X25519PrivateKey,
    X25519PublicKey,
    hkdf_sha256,
)

MAX_FRAME = 1 * 1024 * 1024  # ciphertext cap per frame
CHUNK = 256 * 1024  # plaintext per frame

# Process-wide AEAD CPU attribution (seal + open), fed by every
# SecureWriter/SecureReader in the process.
_aead_ns = 0
_aead_ops = 0


def aead_stats() -> tuple[int, int]:
    """(total nanoseconds spent in AEAD seal/open, operation count)."""
    return _aead_ns, _aead_ops


class TamperError(ConnectionResetError):
    """AEAD verification failed: modified, truncated or replayed traffic."""


def derive_keys(
    shared: bytes, proto: str, client_id: str, server_id: str,
    client_nonce: str, server_nonce: str,
) -> tuple[bytes, bytes]:
    """(client->server key, server->client key) from the ECDH secret,
    bound to the protocol, both identities and both handshake nonces.
    ``v2`` (authenticated close frames) lives in the info, so a
    mixed-version pair fails at the first frame."""
    info = "|".join(["crowdllama-tpu-secure-v2", proto, client_id, server_id,
                     client_nonce, server_nonce]).encode()
    okm = hkdf_sha256(shared, 64, salt=b"crowdllama-tpu-hkdf-salt",
                      info=info)
    return okm[:32], okm[32:]


def ecdh(private: X25519PrivateKey, peer_public_raw: bytes) -> bytes:
    return private.exchange(X25519PublicKey.from_public_bytes(peer_public_raw))


def _count(t0: int, ops: int = 1) -> None:
    global _aead_ns, _aead_ops
    _aead_ns += time.perf_counter_ns() - t0
    _aead_ops += ops


def _native_session(key: bytes) -> "native.AeadSession | None":
    """A native AEAD context for one direction, or None (the counted
    Python path) when the library is not loaded."""
    lib = native.load()
    if lib is None:
        native.record_fallback("aead")
        return None
    return native.AeadSession(lib, key)


class SecureWriter:
    """Encrypting adapter over an asyncio StreamWriter."""

    def __init__(self, writer: asyncio.StreamWriter, key: bytes):
        self._w = writer
        self._native = _native_session(key)
        self._aead = None if self._native is not None else ChaCha20Poly1305(key)
        self._ctr = 0

    @property
    def counter(self) -> int:
        """Frames sealed so far (either path)."""
        return self._native.counter if self._native is not None else self._ctr

    def _frame(self, chunk: bytes) -> None:
        """Seal exactly one frame (empty chunk = authenticated close)."""
        t0 = time.perf_counter_ns()
        if self._native is not None:
            frame = (self._native.seal_frames(bytes(chunk), len(chunk))
                     if chunk else
                     self._native.seal_frames(b"", CHUNK, with_eof=True))
            _count(t0)
            self._w.write(frame)
            return
        nonce = self._ctr.to_bytes(12, "big")
        self._ctr += 1
        ct = self._aead.encrypt(nonce, chunk, None)
        _count(t0)
        self._w.write(len(ct).to_bytes(4, "big") + ct)

    def write(self, data: bytes) -> None:
        if self._native is not None:
            if not data:
                return
            t0 = time.perf_counter_ns()
            before = self._native.counter
            frames = self._native.seal_frames(bytes(data), CHUNK)
            _count(t0, self._native.counter - before)
            self._w.write(frames)
            return
        data = bytes(data)
        for off in range(0, len(data), CHUNK):
            self._frame(data[off:off + CHUNK])

    async def drain(self) -> None:
        await self._w.drain()

    def write_eof(self) -> None:
        # The empty frame tells an intentional end from a bare TCP FIN an
        # on-path attacker could inject at a frame boundary.
        self._frame(b"")
        self._w.write_eof()

    def close(self) -> None:
        self._w.close()

    def is_closing(self) -> bool:
        return self._w.is_closing()

    def get_extra_info(self, name, default=None):
        return self._w.get_extra_info(name, default)


class SecureReader:
    """Decrypting adapter over an asyncio StreamReader."""

    def __init__(self, reader: asyncio.StreamReader, key: bytes):
        self._r = reader
        self._native = _native_session(key)
        self._aead = None if self._native is not None else ChaCha20Poly1305(key)
        self._ctr = 0
        self._buf = bytearray()
        self._eof = False
        self._authenticated_eof = False  # saw the empty close frame

    @property
    def counter(self) -> int:
        """Frames consumed so far (either path)."""
        return self._native.counter if self._native is not None else self._ctr

    async def _fill(self) -> None:
        """Read and decrypt one frame into the plaintext buffer."""
        try:
            header = await self._r.readexactly(4)
        except asyncio.IncompleteReadError as e:
            if e.partial:
                raise TamperError("stream cut mid-frame header") from e
            self._eof = True  # bare FIN at a frame boundary
            return
        length = int.from_bytes(header, "big")
        if not 16 <= length <= MAX_FRAME:
            raise TamperError(f"bad frame length {length}")
        try:
            ct = await self._r.readexactly(length)
        except asyncio.IncompleteReadError as e:
            raise TamperError("stream cut mid-frame") from e
        # The counter advances on a failed tag too (on both paths): a
        # stream that failed authentication is dead.
        t0 = time.perf_counter_ns()
        if self._native is not None:
            pt = self._native.open(ct)
            _count(t0)
            if pt is None:
                raise TamperError("frame failed authentication")
        else:
            nonce = self._ctr.to_bytes(12, "big")
            self._ctr += 1
            try:
                pt = self._aead.decrypt(nonce, ct, None)
            except InvalidTag as e:
                raise TamperError("frame failed authentication") from e
            finally:
                _count(t0)
        if not pt:  # authenticated close (SecureWriter.write_eof)
            self._eof = True
            self._authenticated_eof = True
            return
        self._buf += pt

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            if self._eof:
                raise asyncio.IncompleteReadError(bytes(self._buf), n)
            await self._fill()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            while not self._eof:
                await self._fill()
            if not self._authenticated_eof:
                # A read-to-EOF consumer must not take a prefix cut by an
                # injected FIN as the whole message.
                raise TamperError("stream ended without authenticated close")
            out = bytes(self._buf)
            self._buf.clear()
            return out
        while not self._buf and not self._eof:
            await self._fill()
        if not self._buf and self._eof and not self._authenticated_eof:
            # Bounded-read loops (read(n) until b"") read to EOF too.
            raise TamperError("stream ended without authenticated close")
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def at_eof(self) -> bool:
        # The underlying reader is at EOF as soon as the transport fed a
        # FIN, so a pooled idle stream whose remote died shows here before
        # a borrower spends a round trip on it.
        return not self._buf and (self._eof or self._r.at_eof())
