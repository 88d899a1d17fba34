"""Canonical inverse-CDF draw primitives — the ONE definition of a
stochastic retrieval draw in the port, shared by the plain fused version
(``kernels.ref``), the materialised retrieval rules (``core.retrieval``)
and, as a contract, the CUDA fused retrieval kernel.

The CDF is chunked: DRAW_BLK lanes per chunk, an in-chunk prefix sum
plus a left fold of the chunk totals. The port fixes the order of both
sums to a sequential fp32 walk (lane 0, 1, 2, … inside a chunk; chunk 0,
1, 2, … for the fold) — the order one CUDA thread walks in the kernel —
so the plain version and the kernel compute the same CDF bits from the
same probabilities. ``torch.cumsum`` is not used: on the CPU it
accumulates float32 in double, on the GPU in a parallel scan order.

Variates: one 20-bit integer per draw (``prng.randint``), target
t = (u + 0.5) / 2^20 ∈ (0, 1); the draw is the count of lanes with
cdf ≤ t, clipped to cap-1.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import prng

DRAW_U_BITS = 20
DRAW_U_CARD = 1 << DRAW_U_BITS
DRAW_BLK = 256


def draw_variates(keys: np.ndarray, n: int) -> np.ndarray:
    """keys (..., 2) → (..., n) int32 variates in [0, 2^20): exactly
    ``jax.random.randint(key, (n,), 0, 2**20)`` per key."""
    return prng.randint(keys, n, 0, DRAW_U_CARD)


def draw_targets(u) -> torch.Tensor:
    """Integer variates → inverse-CDF targets in (0, 1), exact in fp32."""
    u = torch.as_tensor(u)
    return (u.to(torch.float32) + 0.5) * (1.0 / DRAW_U_CARD)


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis as a sequential fp32 walk
    (out[i] = out[i-1] + x[i]) — the port's one summation order."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def chunk_cdf(chunks: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """The canonical fold over (..., K, DRAW_BLK) chunk-major
    probabilities with an incoming (..., 1) carry: cdf = in-chunk prefix
    sum + (carry + totals of the earlier chunks), both sequential."""
    cc = seq_cumsum(chunks)
    totals = cc[..., -1]                                   # (..., K)
    ext = torch.cat([carry, totals[..., :-1]], dim=-1)
    off = seq_cumsum(ext)
    return cc + off[..., None]


def blockwise_cdf(probs: torch.Tensor) -> torch.Tensor:
    """The canonical chunked CDF of (..., cap) probabilities (zero-padded
    to a DRAW_BLK multiple, cut back to cap)."""
    cap = probs.shape[-1]
    pad = (-cap) % DRAW_BLK
    p = torch.nn.functional.pad(probs.to(torch.float32), (0, pad))
    lead = p.shape[:-1]
    cdf = chunk_cdf(p.reshape(*lead, -1, DRAW_BLK),
                    torch.zeros(*lead, 1, dtype=torch.float32,
                                device=p.device))
    return cdf.reshape(*lead, -1)[..., :cap]


def raw_counts(probs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """#{cdf ≤ t}: probs (..., cap), targets (..., n) → (..., n) int32."""
    cdf = blockwise_cdf(probs)
    return (cdf[..., None, :] <= t[..., :, None]).sum(-1).to(torch.int32)


def categorical_from_targets(probs: torch.Tensor, t: torch.Tensor
                             ) -> torch.Tensor:
    """Inverse-CDF draws over (..., cap) probabilities for (..., n)
    targets: the raw counts clipped to cap-1."""
    cap = probs.shape[-1]
    return raw_counts(probs, t).clamp(0, cap - 1)
