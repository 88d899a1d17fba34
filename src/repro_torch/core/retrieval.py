"""Query-relevant keyframe retrieval (paper §IV-D): the rules on the
fused path.

* ``sampling_retrieve`` — Eq. 5: N inverse-CDF draws from the
  temperature softmax over the indexed vectors.
* ``akr_progressive`` / ``akr_from_draws`` — Eq. 6/7: draw until the
  distinct drawn mass reaches θ·β, with at least N_min = β·⌈θ / max p⌉
  and at most n_max draws.
* ``topk_retrieve`` — greedy Top-K (the paper's vanilla baseline).

Keys are threefry key data ``(…, 2)`` uint32 arrays (``kernels.prng``);
each lane draws exactly what the reference draws with the same key. The
dense baselines (uniform, BOLT, MDF, AKS) belong to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.draws import (categorical_from_targets,
                                       draw_targets, draw_variates,
                                       seq_cumsum)
from repro_torch.kernels.ref import NEG_INF, topk_lowest_lane


def targets_from_keys(keys: np.ndarray, n: int, device) -> torch.Tensor:
    """keys (..., 2) → inverse-CDF targets (..., n) f32 on ``device``:
    the one variate block each key's query consumes."""
    return draw_targets(torch.from_numpy(draw_variates(keys, n))).to(device)


def sampling_retrieve(probs: torch.Tensor, keys: np.ndarray, n: int
                      ) -> torch.Tensor:
    """probs (..., cap) + keys (..., 2) → draws (..., n) int32."""
    return categorical_from_targets(
        probs, targets_from_keys(keys, n, probs.device))


class AKRResult(NamedTuple):
    draws: torch.Tensor         # (..., n_max) int32, -1 past the stop
    valid: torch.Tensor         # (..., n_max) bool — slot actually drawn
    n_drawn: torch.Tensor       # (...,) int32
    mass: torch.Tensor          # (...,) f32 distinct drawn mass
    n_min: torch.Tensor         # (...,) int32 Eq. 7 lower bound


def akr_from_draws(draws: torch.Tensor, drawn_p: torch.Tensor,
                   p_max: torch.Tensor, *, theta: float = 0.9,
                   beta: float = 1.0, n_max: int = 32) -> AKRResult:
    """Eq. 6/7 stop rule over precomputed draws (..., n_max), their
    probabilities and p_max (...,): a draw adds its probability only if
    no earlier draw hit the same lane; stop at the first n with
    mass/β ≥ θ and n ≥ N_min. The running mass is the port's sequential
    fp32 sum."""
    dev = draws.device
    p_max = p_max.to(torch.float32)
    n_min = (beta * torch.ceil(theta / torch.clamp(p_max, min=1e-9))
             ).to(torch.int32)
    n_min = torch.clamp(n_min, min=1, max=n_max)
    eq = draws[..., :, None] == draws[..., None, :]
    seen_before = torch.tril(eq, diagonal=-1).any(-1)
    inc = torch.where(seen_before, torch.zeros_like(drawn_p),
                      drawn_p.to(torch.float32))
    cum = seq_cumsum(inc)
    steps = torch.arange(1, n_max + 1, device=dev)
    done = (cum / beta >= theta) & (steps >= n_min[..., None])
    first = done.to(torch.int32).argmax(-1) + 1
    n_drawn = torch.where(done.any(-1), first,
                          torch.full_like(first, n_max)).to(torch.int32)
    valid = torch.arange(n_max, device=dev) < n_drawn[..., None]
    mass = torch.gather(cum, -1, (n_drawn - 1).long()[..., None])[..., 0]
    out = torch.where(valid, draws, torch.full_like(draws, -1))
    return AKRResult(out.to(torch.int32), valid, n_drawn, mass, n_min)


def akr_progressive(probs: torch.Tensor, keys: np.ndarray, *,
                    theta: float = 0.9, beta: float = 1.0,
                    n_max: int = 32) -> AKRResult:
    """Progressive sampling over (..., cap) probabilities, one key per
    lane: the full n_max variate budget is drawn up front and the stop
    rule applied by ``akr_from_draws``."""
    draws = sampling_retrieve(probs, keys, n_max)
    drawn_p = torch.gather(probs, -1, draws.long())
    return akr_from_draws(draws, drawn_p, probs.amax(-1), theta=theta,
                          beta=beta, n_max=n_max)


def topk_retrieve(sims: torch.Tensor, valid: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Greedy Top-K over (..., cap) similarities with a broadcastable
    valid mask: value-descending, ties to the lowest lane."""
    masked = torch.where(valid, sims, torch.full_like(sims, NEG_INF))
    return topk_lowest_lane(masked, k)[1]

