"""The swarm's handshake and framing crypto, in Python and numpy alone.

Counterpart of ``crowdllama_tpu/utils/crypto_compat.py`` under the same
class and method names, without a ``cryptography`` branch: the port always
runs this code.

- X25519 (RFC 7748): the Montgomery ladder for ``exchange``; a public key
  is the fixed-base Edwards product mapped to Montgomery's u.
- Ed25519 (RFC 8032): extended Edwards coordinates, deterministic
  signatures, cofactorless verification; the base point's products use a
  table of its powers of two.
- HKDF-SHA256 (RFC 5869).
- ChaCha20-Poly1305 (RFC 8439), the AEAD every node puts on the wire: the
  ChaCha20 keystream of all the blocks of a message (the Poly1305 key
  block included) is made in one numpy ``uint32`` pass over the blocks
  (wrapping adds, rotates by shifts), Poly1305 runs on Python ints.

None of it is constant-time: this is a swarm's transport, keyed per
stream by ephemeral X25519 keys, not a general-purpose library.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

import numpy as np


class InvalidSignature(Exception):
    pass


class InvalidTag(Exception):
    pass


_P = 2**255 - 19

# ----------------------------------------------------------------- Ed25519

_L = 2**252 + 27742317777372353535851937790883648493
_D = -121665 * pow(121666, _P - 2, _P) % _P
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)
_IDENTITY = (0, 1, 1, 0)


def _ed_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _ed_mul(s: int, p):
    q = _IDENTITY
    while s:
        if s & 1:
            q = _ed_add(q, p)
        p = _ed_add(p, p)
        s >>= 1
    return q


def _recover_x(y: int, sign: int) -> int:
    if y >= _P:
        raise ValueError("bad point encoding")
    x2 = (y * y - 1) * pow(_D * y * y + 1, _P - 2, _P) % _P
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P:
        x = x * _SQRT_M1 % _P
    if (x * x - x2) % _P:
        raise ValueError("not a curve point")
    if x == 0 and sign:
        raise ValueError("bad point encoding")
    if x & 1 != sign:
        x = _P - x
    return x


_GY = 4 * pow(5, _P - 2, _P) % _P
_GX = _recover_x(_GY, 0)
_G = (_GX, _GY, 1, _GX * _GY % _P)


def _powers_of_two(p, n: int = 256) -> list:
    out = [p]
    for _ in range(n - 1):
        p = _ed_add(p, p)
        out.append(p)
    return out


_G_POW2 = _powers_of_two(_G)


def _ed_mul_base(s: int):
    """``s`` times the base point: one addition per set bit of ``s``
    (``s`` < 2^256), no doublings."""
    q = _IDENTITY
    i = 0
    while s:
        if s & 1:
            q = _ed_add(q, _G_POW2[i])
        s >>= 1
        i += 1
    return q


def _ed_encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, _P - 2, _P)
    x, y = x * zi % _P, y * zi % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _ed_decode(raw: bytes):
    if len(raw) != 32:
        raise ValueError("Ed25519 points are 32 bytes")
    enc = int.from_bytes(raw, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    return (x, y, 1, x * y % _P)


def _ed_eq(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % _P == 0 and (y1 * z2 - y2 * z1) % _P == 0


def _ed_secret_expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


class Ed25519PublicKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
        if len(raw) != 32:
            raise ValueError("Ed25519 public keys are 32 bytes")
        return cls(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        if len(signature) != 64:
            raise InvalidSignature("bad signature length")
        try:
            a = _ed_decode(self._raw)
            r = _ed_decode(signature[:32])
        except ValueError as e:
            raise InvalidSignature(str(e)) from e
        s = int.from_bytes(signature[32:], "little")
        if s >= _L:
            raise InvalidSignature("non-canonical s")
        k = int.from_bytes(
            hashlib.sha512(signature[:32] + self._raw + data).digest(),
            "little") % _L
        if not _ed_eq(_ed_mul_base(s), _ed_add(r, _ed_mul(k, a))):
            raise InvalidSignature("signature mismatch")


class Ed25519PrivateKey:
    def __init__(self, seed: bytes):
        self._seed = bytes(seed)
        self._scalar, self._prefix = _ed_secret_expand(self._seed)
        self._pub = _ed_encode(_ed_mul_base(self._scalar))

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, raw: bytes) -> "Ed25519PrivateKey":
        if len(raw) != 32:
            raise ValueError("Ed25519 private keys are 32 bytes")
        return cls(raw)

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._pub)

    def private_bytes_raw(self) -> bytes:
        return self._seed

    def sign(self, data: bytes) -> bytes:
        r = int.from_bytes(
            hashlib.sha512(self._prefix + data).digest(), "little") % _L
        r_enc = _ed_encode(_ed_mul_base(r))
        k = int.from_bytes(
            hashlib.sha512(r_enc + self._pub + data).digest(), "little") % _L
        s = (r + k * self._scalar) % _L
        return r_enc + s.to_bytes(32, "little")


# ------------------------------------------------------------------ X25519

_A24 = 121665


def _clamp(scalar32: bytes) -> int:
    k = int.from_bytes(scalar32, "little")
    k &= ~7
    k &= (1 << 254) - 1
    return k | (1 << 254)


def _x25519_ladder(k: int, u: int) -> int:
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P - 2, _P) % _P


def _x25519_base(scalar32: bytes) -> bytes:
    """X25519(k, 9) through the Edwards base point: u = (Z + Y) / (Z - Y)
    of [k]G (Curve25519 and Ed25519 are birationally equivalent, and 9 is
    the image of the Edwards base point)."""
    _, y, z, _ = _ed_mul_base(_clamp(scalar32))
    u = (z + y) * pow((z - y) % _P, _P - 2, _P) % _P
    return u.to_bytes(32, "little")


class X25519PublicKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
        if len(raw) != 32:
            raise ValueError("X25519 public keys are 32 bytes")
        return cls(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw


class X25519PrivateKey:
    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, raw: bytes) -> "X25519PrivateKey":
        if len(raw) != 32:
            raise ValueError("X25519 private keys are 32 bytes")
        return cls(raw)

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(_x25519_base(self._raw))

    def private_bytes_raw(self) -> bytes:
        return self._raw

    def exchange(self, peer_public: X25519PublicKey) -> bytes:
        u = int.from_bytes(peer_public.public_bytes_raw(),
                           "little") & ((1 << 255) - 1)
        shared = _x25519_ladder(_clamp(self._raw), u).to_bytes(32, "little")
        if shared == b"\x00" * 32:
            raise ValueError("X25519 exchange produced all-zero secret")
        return shared


# -------------------------------------------------------------------- HKDF

def hkdf_sha256(key_material: bytes, length: int, salt: bytes | None = None,
                info: bytes = b"") -> bytes:
    """RFC 5869 with SHA-256 (an empty salt is 32 zero bytes)."""
    if length > 255 * 32:
        raise ValueError("HKDF-SHA256 output is at most 8160 bytes")
    prk = hmac.new(salt or b"\x00" * 32, key_material,
                   hashlib.sha256).digest()
    okm, t, counter = b"", b"", 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([counter]),
                     hashlib.sha256).digest()
        okm += t
        counter += 1
    return okm[:length]


# -------------------------------------------------------- ChaCha20-Poly1305

_SIGMA = np.frombuffer(b"expand 32-byte k", "<u4")
# Row rotations taking the diagonal round to a column round (and back).
_ROT = tuple(np.array([(i + s) % 4 for i in range(4)]) for s in (1, 2, 3))
_UNROT = tuple(np.argsort(r) for r in _ROT)
_SHIFTS = tuple((np.uint32(s), np.uint32(32 - s)) for s in (16, 12, 8, 7))


def chacha20_keystream(key: bytes, nonce: bytes, counter: int,
                       nblocks: int) -> bytes:
    """``nblocks`` 64-byte ChaCha20 blocks (RFC 8439 §2.3) from block
    ``counter`` on, in one numpy pass with the blocks along the last
    axis: each quarter round works on a whole row of the state (four
    words) of every block at once, and the diagonal round rotates rows
    1-3 into columns first and back after."""
    if counter + nblocks > 1 << 32:
        raise ValueError("ChaCha20 block counter overflow")
    st = np.empty((4, 4, nblocks), np.uint32)
    st[0] = _SIGMA[:, None]
    st[1:3] = np.frombuffer(key, "<u4").reshape(2, 4)[:, :, None]
    st[3, 0] = np.arange(counter, counter + nblocks, dtype=np.uint32)
    st[3, 1:] = np.frombuffer(nonce, "<u4")[:, None]
    a, b, c, d = (st[i].copy() for i in range(4))
    b2, c2, d2, t = (np.empty_like(a) for _ in range(4))
    (l16, r16), (l12, r12), (l8, r8), (l7, r7) = _SHIFTS
    lsh, rsh, bor, take = np.left_shift, np.right_shift, np.bitwise_or, np.take

    def quarter(a, b, c, d):
        # Wrapping uint32 adds; rotates as two shifts and an or.
        a += b
        d ^= a
        lsh(d, l16, out=t)
        rsh(d, r16, out=d)
        bor(d, t, out=d)
        c += d
        b ^= c
        lsh(b, l12, out=t)
        rsh(b, r12, out=b)
        bor(b, t, out=b)
        a += b
        d ^= a
        lsh(d, l8, out=t)
        rsh(d, r8, out=d)
        bor(d, t, out=d)
        c += d
        b ^= c
        lsh(b, l7, out=t)
        rsh(b, r7, out=b)
        bor(b, t, out=b)

    for _ in range(10):
        quarter(a, b, c, d)
        take(b, _ROT[0], axis=0, out=b2)
        take(c, _ROT[1], axis=0, out=c2)
        take(d, _ROT[2], axis=0, out=d2)
        quarter(a, b2, c2, d2)
        take(b2, _UNROT[0], axis=0, out=b)
        take(c2, _UNROT[1], axis=0, out=c)
        take(d2, _UNROT[2], axis=0, out=d)
    x = np.stack((a, b, c, d)) + st
    return x.reshape(16, nblocks).T.astype("<u4").tobytes()


def _xor(data: bytes, stream: bytes) -> bytes:
    n = len(data)
    if not n:
        return b""
    return (np.frombuffer(data, np.uint8)
            ^ np.frombuffer(stream, np.uint8, n)).tobytes()


_P1305 = (1 << 130) - 5


def poly1305(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5 one-time authenticator, on Python ints."""
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    frombytes = int.from_bytes
    for off in range(0, len(msg), 16):
        block = msg[off:off + 16]
        acc = (acc + frombytes(block, "little")
               + (1 << (8 * len(block)))) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return b"\x00" * (-n % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD: ``encrypt(nonce, data, aad)`` -> ciphertext || 16-byte
    tag; ``decrypt`` raises ``InvalidTag`` on any forgery."""

    _TAG = 16

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _stream(self, nonce: bytes, n: int) -> tuple[bytes, bytes]:
        """(Poly1305 key, keystream of ``n`` bytes): block 0 and blocks
        1.. in one pass."""
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        ks = chacha20_keystream(self._key, nonce, 0, 1 + -(-n // 64))
        return ks[:32], ks[64:]

    @staticmethod
    def _tag(otk: bytes, aad: bytes, ct: bytes) -> bytes:
        return poly1305(otk, b"".join((
            aad, _pad16(len(aad)), ct, _pad16(len(ct)),
            struct.pack("<QQ", len(aad), len(ct)))))

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = bytes(aad or b"")
        otk, ks = self._stream(nonce, len(data))
        ct = _xor(bytes(data), ks)
        return ct + self._tag(otk, aad, ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        data = bytes(data)
        if len(data) < self._TAG:
            raise InvalidTag("ciphertext shorter than tag")
        ct, tag = data[:-self._TAG], data[-self._TAG:]
        otk, ks = self._stream(nonce, len(ct))
        if not hmac.compare_digest(tag, self._tag(otk, bytes(aad or b""),
                                                  ct)):
            raise InvalidTag("tag mismatch")
        return _xor(ct, ks)
