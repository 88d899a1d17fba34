"""Threefry-2x32 in numpy, bit-exact with ``jax.random`` under the
partitionable threefry implementation (the default from JAX 0.5 on).

The reference consumes its per-session PRNG chains through
``jax.random.key`` / ``split`` / ``randint``; the draw targets every
sampling and AKR query feeds the fused retrieval scan come out of that
chain. Reproducing the chain bit for bit is what lets the port return the
same frame ids as the reference, not merely the same distribution. It is
host-side and tiny (a few dozen uint32 words per query); the targets it
yields go to the device as one ``(S, Q, T)`` tensor.

Keys are ``(..., 2)`` uint32 arrays — the ``jax.random.key_data`` layout.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs ``(x1, x2)``
    under key ``(k1, k2)``; every argument broadcasts, all uint32."""
    k1, k2, x1, x2 = (np.asarray(a, _U32) for a in (k1, k2, x1, x2))
    k1, k2, x1, x2 = np.broadcast_arrays(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for step in range(5):
        for r in _ROT[step % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(step + 1) % 3]
        x[1] = x[1] + ks[(step + 2) % 3] + _U32(step + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` key data with 64-bit types disabled (the
    reference's setting): the seed is taken as a 32-bit integer, so the
    high word is 0 and the low word its low 32 bits."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], _U32)


def _iota_2x32(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), i.astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: keys ``(..., 2)`` → ``(..., num, 2)``."""
    k = np.asarray(k, _U32)
    hi, lo = _iota_2x32(num)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(k: np.ndarray, n: int) -> np.ndarray:
    """32-bit ``jax.random.bits`` of ``n`` values per key: ``(..., n)``."""
    k = np.asarray(k, _U32)
    hi, lo = _iota_2x32(n)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)
    return b1 ^ b2


def randint(k: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, (n,), minval, maxval)`` (int32) for every
    key of a ``(..., 2)`` key array → ``(..., n)``. Same modulus scheme as
    JAX: two 32-bit words per value, combined modulo the span."""
    assert maxval > minval, (minval, maxval)
    ks = split(k, 2)
    higher = random_bits(ks[..., 0, :], n)
    lower = random_bits(ks[..., 1, :], n)
    # uint32 throughout, wrapping exactly where JAX's uint32 ops wrap
    span = np.asarray([maxval - minval], _U32)
    mult = (np.asarray([1 << 16], _U32) % span) ** _U32(2) % span
    off = ((higher % span) * mult + lower % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
