"""Kernel dispatch layer.

The route is the device of the tensors: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor takes the kernel's plain
PyTorch version. There is no backend switch and no fallback.

The scan counters keep the reference's 11 names (``repro.kernels.ops``)
so the same invariants read the same way in both packages; the ones of
paths outside the port so far (sharding, the coarse tier, standing
queries) stay at 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import ref
from repro_torch.kernels import scene_score as _scene
from repro_torch.kernels import similarity as _sim

_scan_counts = {"similarity": 0, "similarity_stack": 0,
                "scan_bytes": 0, "fused_draw_launches": 0,
                "dense_score_launches": 0,
                "sharded_stack_launches": 0, "shard_gather_bytes": 0,
                "coarse_scan_bytes": 0, "fine_gather_rows": 0,
                "two_stage_scans": 0, "standing_scan_bytes": 0}


def scan_counts() -> dict:
    return dict(_scan_counts)


def reset_scan_counts() -> None:
    for k in _scan_counts:
        _scan_counts[k] = 0


_KERNELS = {"fused_retrieve": _sim.fused_retrieve_scan_stack,
            "similarity_scan_stack": _sim.similarity_scan_stack,
            "similarity_scan": _sim.similarity_scan,
            "scene_score": _scene.scene_score,
            "gqa_decode": _decode.gqa_decode,
            "mla_decode": _decode.mla_decode}


def kernel_launches() -> dict:
    """Launch count of each hand-written kernel (bumped where the kernel
    is launched, never on the plain path)."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_kernel_launches() -> None:
    """Zero every launch count, and the decode wrappers' counts by route."""
    for fn in _KERNELS.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", ()):
            fn.route_launches[route] = 0


def _count_scan(index: torch.Tensor) -> None:
    _scan_counts["scan_bytes"] += index.numel() * index.element_size()


def decode_attention(q, k, v, valid, *, scale: float, softcap: float = 0.0,
                     q_per_kv: int = 1) -> torch.Tensor:
    """q (B,1,H,D); k/v (B,C,Hkv,D); valid (B or 1, C) → (B,1,H,D)."""
    return _decode.gqa_decode(q, k, v, valid, scale=scale, softcap=softcap,
                              q_per_kv=q_per_kv)


def mla_decode_attention(q_abs, q_rope, ckv, krope, valid, *,
                         scale: float) -> torch.Tensor:
    """q_abs (B,1,H,R), q_rope (B,1,H,Dr), ckv (B,C,R), krope (B,C,Dr),
    valid (B or 1, C) → latent context (B,1,H,R)."""
    return _decode.mla_decode(q_abs, q_rope, ckv, krope, valid, scale=scale)


def similarity(query, index, *, tau: float, valid
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q,d) × index (N,d) f32 or int8 + valid (N,) bool → (sims
    (Q,N), probs (Q,N)): the 2-D dense scan (the kernel on the card, its
    plain version on the CPU) and the probability epilogue."""
    _scan_counts["similarity"] += 1
    _scan_counts["dense_score_launches"] += 1
    _count_scan(index)
    valid = valid.to(index.device)
    sims, m, l = _sim.similarity_scan(query, index, valid, tau=tau)
    return sims, ref.scan_probs(sims, m, l, valid[None, :], tau)


def similarity_stack(query, index, *, tau: float, valid
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-session dense scan in ONE launch: query (S,Q,d) × index
    (S,N,d) f32 or int8 + valid in any canonical form → (sims (S,Q,N),
    probs (S,Q,N)). The mask is built once, for the scan and the
    epilogue. The sharded form is a later slice."""
    _scan_counts["similarity_stack"] += 1
    _scan_counts["dense_score_launches"] += 1
    _count_scan(index)
    vmask = ref.as_valid_mask(valid.to(index.device), index.shape[1])
    sims, m, l = _sim.similarity_scan_stack(query, index, vmask, tau=tau)
    return sims, ref.scan_probs(sims, m, l, vmask[:, None, :], tau)


class FusedRetrieval(NamedTuple):
    """Finalised fused-retrieval result — what the query-plan executor
    consumes. No (S, Q, N) tensor anywhere in the contract."""
    draws: torch.Tensor         # (S, Q, T) int32 lane draws (clipped)
    drawn_p: torch.Tensor       # (S, Q, T) f32 probability of each draw
    topk_v: torch.Tensor        # (S, Q, K) f32 top-k scores (desc)
    topk_i: torch.Tensor        # (S, Q, K) int32 top-k lane indices
    m: torch.Tensor             # (S, Q, 1) f32 softmax max logit
    l: torch.Tensor             # (S, Q, 1) f32 softmax sum-exp
    p_max: torch.Tensor         # (S, Q, 1) f32 max probability


def fused_retrieve_stack(query, index, *, tau: float, valid, targets,
                         n_topk: int, tier: str = "fine") -> FusedRetrieval:
    """One-launch fused retrieval: query (S,Q,d) × index (S,N,d) f32 or
    int8 + valid (any canonical mask form) + targets (S,Q,T) → draws,
    drawn probabilities, top-k and softmax stats. Targets beyond the
    accumulated mass clip to lane N-1 and take ``p_last`` as their drawn
    probability, identically for both routes."""
    if tier in ("coarse", "standing"):
        raise NotImplementedError(
            f"tier={tier!r} belongs to a later slice of the port "
            f"(ROADMAP.md, Queue 1: hierarchical tier / standing queries)")
    if tier != "fine":
        raise ValueError(f"unknown tier {tier!r}")
    _scan_counts["similarity_stack"] += 1
    _scan_counts["fused_draw_launches"] += 1
    _count_scan(index)
    return finalize(_sim.fused_retrieve_scan_stack(
        query, index, valid, targets, tau=tau, n_topk=n_topk),
        index.shape[1])


def finalize(r, n: int) -> FusedRetrieval:
    """Raw fused outputs over n lanes → ``FusedRetrieval``: counts clip
    to n-1, and a target beyond the accumulated mass takes ``p_last``."""
    draws = r.counts.clamp(0, n - 1).to(torch.int32)
    drawn_p = torch.where(r.counts >= n, r.p_last, r.drawn_p)
    return FusedRetrieval(draws, drawn_p, r.topk_v, r.topk_i, r.m, r.l,
                          r.p_max)


def scene_score(frames: torch.Tensor, weights,
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames (T,H,W,3) in [0,1] → φ (T,); ``prev``, the frame before
    them, or None (φ[0] = 0)."""
    return _scene.scene_score(frames, tuple(weights), prev)
