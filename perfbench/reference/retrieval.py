"""AKR retrieval (Eq. 5–7), plain, from a session's stored rows.

A session's questions consume its key chain in order: the chain starts
at the Threefry-2x32 key (0, seed) and each question splits it into the
next key and its own. The question's key gives ``n_max`` 20-bit variates
(JAX's ``randint`` scheme), each an inverse-CDF target (u + ½) / 2²⁰
over the temperature softmax of the rows' cosines with the query (both
made unit length: Eq. 4). AKR
takes draws in order, adding a row's probability once, and stops at
the first draw where the distinct mass reaches θ·β and the draws number
at least β·⌈θ / max p⌉. Each draw picks a member of its row's cluster
with a per-slot variate from NumPy ``default_rng(seed)``; the answer is
the sorted distinct frame ids. The probabilities and their CDF are
float64 here, so a target within rounding of a CDF step can land one
row apart from the program's float32: such a question is *ambiguous*
(a target within ``NEAR`` of a step, the stop rule's mass within
``NEAR`` of θ·β, or θ / max p within rounding of a whole number), and
its answer is not compared."""

from __future__ import annotations

import numpy as np

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
U_BITS = 20
NEAR = 1e-5         # f32 rounding of a CDF over thousands of rows is ~1e-6


def _rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, U32)
                                           for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ U32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for step in range(5):
        for r in _ROT[step % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(step + 1) % 3]
        x[1] = x[1] + ks[(step + 2) % 3] + U32(step + 1)
    return x[0], x[1]


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(U32), i.astype(U32)


def split(k, num: int = 2) -> np.ndarray:
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([b1, b2], -1)


def bits(k, n: int) -> np.ndarray:
    hi, lo = _counters(n)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return b1 ^ b2


def randint(k, n: int, lo: int, hi: int) -> np.ndarray:
    ks = split(k, 2)
    higher, lower = bits(ks[0], n), bits(ks[1], n)
    span = np.asarray([hi - lo], U32)
    mult = (np.asarray([1 << 16], U32) % span) ** U32(2) % span
    off = ((higher % span) * mult + lower % span) % span
    return lo + off.astype(np.int64)


class Chain:
    """A session's key chain from ``seed``."""

    def __init__(self, seed: int):
        self.key = np.asarray([0, int(seed) & 0xFFFFFFFF], U32)

    def next(self) -> np.ndarray:
        self.key, sub = split(self.key)
        return sub


def akr_frame_ids(query: np.ndarray, rows: np.ndarray, members, key, *,
                  tau: float, theta: float, beta: float, n_max: int,
                  seed: int):
    """(frame ids, ambiguous): what AKR returns for ``query`` over
    ``rows`` (n, d) with their clusters' ``members`` (in stored order),
    under ``key``."""
    r = rows.astype(np.float64)
    q = np.asarray(query, np.float64)
    sims = (r / np.sqrt((r * r).sum(-1, keepdims=True) + 1e-12)) @ (
        q / np.sqrt((q * q).sum() + 1e-12))
    z = sims / tau
    p = np.exp(z - z.max())
    p /= p.sum()
    cdf = np.cumsum(p)
    u = randint(key, n_max, 0, 1 << U_BITS)
    t = (u.astype(np.float64) + 0.5) / (1 << U_BITS)
    draws = np.searchsorted(cdf, t, side="right")      # #{cdf <= t}
    valid_draw = draws < len(rows)
    drawn_p = np.where(valid_draw, p[np.minimum(draws, len(rows) - 1)], 0.0)
    ratio = theta / max(p.max(), 1e-9)
    n_min = int(np.clip(beta * np.ceil(ratio), 1, n_max))
    ambiguous = abs(ratio - np.rint(ratio)) < 1e-6 * ratio
    seen, mass, n_drawn = set(), 0.0, n_max
    for i, (d, q) in enumerate(zip(draws, drawn_p)):
        near = np.abs(cdf[max(d - 1, 0):d + 1] - t[i]).min() < NEAR
        ambiguous = ambiguous or bool(near)
        if int(d) not in seen:
            mass += q
            seen.add(int(d))
        if i + 1 >= n_min:
            ambiguous = ambiguous or abs(mass / beta - theta) < NEAR
            if mass / beta >= theta:
                n_drawn = i + 1
                break
    pick_u = np.random.default_rng(seed).integers(0, 1 << U_BITS, size=n_max,
                                                  dtype=np.int64)
    out = set()
    for i in range(n_drawn):
        if not valid_draw[i]:
            continue
        mem = members[int(draws[i])]
        if len(mem):
            out.add(int(mem[(int(pick_u[i]) * len(mem)) >> U_BITS]))
    return np.asarray(sorted(out), np.int64), ambiguous
