"""Query-relevant keyframe retrieval (paper §IV-D) and its baselines.

* ``sampling_retrieve`` — Eq. 5: N inverse-CDF draws from the
  temperature softmax over the indexed vectors.
* ``akr_progressive`` / ``akr_from_draws`` — Eq. 6/7: draw until the
  distinct drawn mass reaches θ·β, with at least N_min = β·⌈θ / max p⌉
  and at most n_max draws.
* Baselines over dense scan outputs: greedy Top-K (the paper's
  vanilla), uniform sampling, BOLT inverse-transform sampling, MDF
  dominant-frame filtering and AKS judge-&-split.

Keys are threefry key data ``(…, 2)`` uint32 arrays (``kernels.prng``);
each lane draws exactly what the reference draws with the same key. The
functions take any leading batch axes in place of the reference's
``vmap``s; each lane is the reference's single-lane function.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.draws import (blockwise_cdf,
                                       categorical_from_targets,
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



def topk_retrieve_batch(sims: torch.Tensor, valid: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """Stacked Top-K: sims (S, Q, cap) + valid (S, cap) → (S, Q, k)."""
    return topk_retrieve(sims, valid[:, None, :], k)


def uniform_retrieve_batch(total_frames, n: int, device=None
                           ) -> torch.Tensor:
    """Uniform baseline: total_frames (S,) → (S, n) int32 fixed-interval
    frame ids, ``jnp.linspace(0, total - 1, n)`` truncated: the points
    stop·(i / (n-1)) in fp32 and the endpoint exactly."""
    stop = (torch.as_tensor(total_frames, device=device).to(torch.float32)
            - 1.0)[:, None]
    if n == 1:
        out = torch.zeros_like(stop)
    else:
        step = (torch.arange(n - 1, dtype=torch.float32,
                             device=stop.device) / float(n - 1))
        out = torch.cat([stop * step, stop], dim=-1)[:, :n]
    return out.to(torch.int32)


def uniform_retrieve(total_frames: int, n: int) -> torch.Tensor:
    """Uniform sampling baseline for one stream: (n,) int32 frame ids."""
    return uniform_retrieve_batch([total_frames], n)[0]


def bolt_inverse_transform(sims: torch.Tensor, valid: torch.Tensor, n: int,
                           *, tau: float = 0.1) -> torch.Tensor:
    """BOLT: deterministic quantiles u = (i + 0.5)/n of the time-ordered
    CDF of softmax(sims/τ) over (..., cap) with a broadcastable valid
    mask → (..., n) int32. The CDF is the port's canonical chunked one
    (``draws.blockwise_cdf``); the reference takes ``jnp.cumsum``, so a
    quantile within ulps of a CDF value may land one lane apart."""
    cap = sims.shape[-1]
    logits = torch.where(valid, sims / tau, torch.full_like(sims, NEG_INF))
    cdf = blockwise_cdf(torch.softmax(logits, dim=-1))
    u = ((torch.arange(n, dtype=torch.float32, device=sims.device) + 0.5)
         / n)
    idx = torch.searchsorted(cdf.contiguous(),
                             u.expand(*cdf.shape[:-1], n).contiguous())
    return idx.clamp(0, cap - 1).to(torch.int32)


def bolt_inverse_transform_batch(sims: torch.Tensor, valid: torch.Tensor,
                                 n: int, *, tau: float = 0.1
                                 ) -> torch.Tensor:
    """Stacked BOLT: sims (S, Q, cap) + valid (S, cap) → (S, Q, n)."""
    return bolt_inverse_transform(sims, valid[:, None, :], n, tau=tau)


def mdf_retrieve_batch(embs: torch.Tensor, valid: torch.Tensor, n: int, *,
                       sim_threshold: float = 0.95) -> torch.Tensor:
    """MDF dominant-frame filtering, query-agnostic: embs (S, cap, d) +
    valid (S, cap) → (S, n) int32. Scan rows in time order keeping a row
    whose cosine to the last kept row is below the threshold, then
    sub-sample the kept rows uniformly. The reference's ``lax.scan``
    becomes a loop over the cap rows, batched across sessions."""
    x = embs.to(torch.float32)
    x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    s, cap, _ = x.shape
    last = torch.zeros_like(x[:, 0])
    keep = torch.empty((s, cap), dtype=torch.bool, device=x.device)
    for i in range(cap):
        v = x[:, i]
        k = valid[:, i] & ((last * v).sum(-1) < sim_threshold)
        last = torch.where(k[:, None], v, last)
        keep[:, i] = k
    n_kept = keep.sum(-1, dtype=torch.int32)
    # the kept rows in time order, then zeros (jnp.nonzero's fill)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    j = torch.arange(cap, device=x.device)
    kept_idx = torch.where(j < n_kept[:, None], order, torch.zeros_like(order))
    pick = (torch.arange(n, dtype=torch.int32, device=x.device)[None, :]
            * torch.clamp(n_kept, min=1)[:, None]) // n
    return torch.gather(kept_idx, -1, pick.long()).to(torch.int32)


def mdf_retrieve(embs: torch.Tensor, valid: torch.Tensor, n: int, *,
                 sim_threshold: float = 0.95) -> torch.Tensor:
    """MDF for one stream: embs (cap, d) + valid (cap,) → (n,) int32."""
    return mdf_retrieve_batch(embs[None], valid[None], n,
                              sim_threshold=sim_threshold)[0]


def aks_retrieve(sims: torch.Tensor, valid: torch.Tensor, n: int, *,
                 depth: int = 3) -> torch.Tensor:
    """AKS judge-&-split over one lane (cap,): split the timeline
    recursively, give each half a share of the budget proportional to its
    softmax mass (``torch.round``: half to even, as ``jnp.round``), and
    take the top scores inside each leaf region. Host-driven: each split
    reads its two masses back. → (n,) int32."""
    cap = sims.shape[0]
    neg = torch.full_like(sims, NEG_INF)
    s = torch.where(valid, sims, neg)
    mass = torch.where(valid, torch.softmax(s, dim=-1),
                       torch.zeros_like(sims))

    def alloc(lo: int, hi: int, budget: int, d: int):
        if budget <= 0:
            return []
        if d == 0 or hi - lo <= budget:
            k = min(budget, hi - lo)
            return [topk_lowest_lane(s[lo:hi], k)[1] + lo]
        mid = (lo + hi) // 2
        m_l = mass[lo:mid].sum()
        m_r = mass[mid:hi].sum()
        b_l = torch.round(budget * m_l / torch.clamp(m_l + m_r, min=1e-9))
        b_l = int(torch.clamp(b_l, 0, budget))
        return (alloc(lo, mid, b_l, d - 1)
                + alloc(mid, hi, budget - b_l, d - 1))

    parts = alloc(0, cap, n, depth)
    idx = (torch.cat(parts) if parts
           else torch.zeros((0,), dtype=torch.int32, device=sims.device))
    if idx.shape[0] < n:
        idx = torch.cat([idx, torch.zeros(n - idx.shape[0], dtype=idx.dtype,
                                          device=idx.device)])
    return idx[:n].to(torch.int32)
