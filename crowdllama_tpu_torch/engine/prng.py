"""Threefry-2x32 keys and draws, bit-compatible with ``jax.random``.

A seeded request must sample the same tokens on this package as on a JAX
worker (failover replays a stream and trims it by count), so the key
chain and the random bits follow JAX's default ``threefry2x32`` PRNG with
``jax_threefry_partitionable`` on (the default since JAX 0.5):

- ``threefry2x32``: 20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16,
  24), key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``;
- ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]`` of a 32-bit
  seed (JAX without x64), so ``[0, seed]`` for ``0 <= seed < 2**31``;
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
- ``split(key, n)[i]`` hashes ``(0, i)`` (the partitionable layout);
- 32-bit ``random_bits`` of a shape hash the flat index ``n`` as
  ``(n >> 32, n & 0xFFFFFFFF)`` and xor the two output words;
- ``randint`` (int32) draws two 32-bit words per value from
  ``split(key)``'s two keys, ``hi`` and ``lo``, and returns ``minval +
  (hi % span * (2**32 % span) + lo % span) % span`` in wrapping uint32
  arithmetic, ``span`` being ``maxval - minval`` (1 where ``maxval <=
  minval``);
- ``uniform`` sets the top 23 bits as a mantissa of 1.x, subtracts 1,
  scales, then takes ``max(minval, .)``; ``gumbel`` (default "low" mode)
  is ``-log(-log(uniform(tiny, 1)))``; ``categorical`` is
  ``argmax(logits + gumbel)``, which keeps ``-inf`` logits at ``-inf``.

Everything here runs on the host in numpy ``uint32``/``float32``: a
slot's key chain never depends on the logits, so a runner derives the
noise for all K steps of a dispatch at once and copies it to the device in
one transfer.  The ``log`` of the gumbel transform also runs on the host
(numpy); keys, bits and uniforms equal JAX's bit for bit, while ``log``
differs between math libraries by at most one ulp (XLA's own CPU, GPU and
TPU backends differ there too), so a categorical draw can only differ
where two candidates tie within that ulp.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = np.finfo(np.float32).tiny


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function on uint32 arrays (broadcast):
    key words ``k0, k1``, counter words ``x0, x1``; returns two words."""
    k0, k1 = np.asarray(k0, _U32), np.asarray(k1, _U32)
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
    with np.errstate(over="ignore"):  # uint32 adds wrap, as in JAX
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return np.asarray(x[0], _U32), np.asarray(x[1], _U32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range: [2]
    uint32."""
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} outside the int32 range")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in`` over keys [..., 2] with uint32 ``data``
    (a scalar or an array broadcasting against the keys' batch)."""
    keys = np.asarray(keys, _U32)
    d = np.asarray(data, np.uint64).astype(_U32)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], _U32(0), d)
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1)


def split(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` over keys [..., 2]: returns [..., num, 2]."""
    keys = np.asarray(keys, _U32)
    i = np.arange(num, dtype=_U32)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], _U32(0), i)
    return np.stack([y0, y1], axis=-1)


def random_bits(keys: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32-bit ``jax.random.bits(key, shape)`` for keys [..., 2]: returns
    [..., *shape] uint32 (each key draws its own ``shape``)."""
    keys = np.asarray(keys, _U32)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)
    k0, k1 = keys[..., 0, None], keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(*keys.shape[:-1], *shape)


def randint(key: np.ndarray, shape: tuple[int, ...], minval,
            maxval) -> np.ndarray:
    """int32 ``jax.random.randint(key, shape, minval, maxval)`` for ONE key
    [2]; ``minval`` / ``maxval`` are ints or arrays broadcasting to
    ``shape`` (clipped to the int32 range, as JAX clips them)."""
    info = np.iinfo(np.int32)
    lo = np.broadcast_to(np.clip(np.asarray(minval, np.int64), info.min,
                                 info.max), shape)
    hi = np.broadcast_to(np.clip(np.asarray(maxval, np.int64), info.min,
                                 info.max), shape)
    k_hi, k_lo = split(key)
    higher = random_bits(k_hi, shape).astype(np.uint64)
    lower = random_bits(k_lo, shape).astype(np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    span = np.where(hi <= lo, 1, (hi - lo) & 0xFFFFFFFF).astype(np.uint64)
    mult = np.uint64(1 << 16) % span
    mult = (mult * mult & mask) % span
    offset = ((higher % span * mult & mask) + lower % span & mask) % span
    return ((lo + offset.astype(np.int64)) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def uniform(keys: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 ``jax.random.uniform`` in [minval, maxval)."""
    bits = random_bits(keys, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(32 - 23)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """float32 ``jax.random.gumbel`` (mode "low") for keys [..., 2]."""
    return -np.log(-np.log(uniform(keys, shape, TINY, 1.0)))


def categorical(keys: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis for ONE
    key [2] (noise drawn for the whole logits shape, as JAX does)."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(keys, logits.shape) + logits, axis=-1)
