"""Hierarchical two-level memory: two-stage (coarse → fine) retrieval
over the arena's coarse tier (paper §IV-C).

Each slot's coarse tier holds ``n_coarse = n_blocks + coarse_capacity``
rows (``memory.coarse_rows_for``): block summaries (one centroid per
``coarse_block`` physical fine rows, no reservoir) and consolidated
summaries of evicted history (running centroids with merged reservoirs).

``two_stage_retrieve`` makes two launches of the fused scan:

1. **Stage 1** over the ``(S, n_coarse, d)`` coarse tier
   (``tier="coarse"``; one launch a slab over a sharded arena) picks
   each query's top-B coarse rows.
2. **Stage 2** gathers each (session, query)'s candidates — a block
   winner's ``coarse_block`` fine rows, a consolidated winner itself in
   slot 0 with the rest masked — into one ``(S·Q, B·block, d)`` operand
   and scans it with the group's own inverse-CDF targets, so draws, top-k
   and AKR's state resolve over the candidates only. Each slab gathers
   its own slots' candidates; the operand, on the arena's first device,
   is scanned unsharded.

The executor enters this path only once the tier holds a consolidated
row (``MemoryArena.has_consolidated``); before that, and always with
``coarse=False``, queries take the flat scan unchanged. The targets come
from the same keys either way, so session PRNG chains advance alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.memory import MemoryArena, expand_gather
from repro_torch.kernels import ops as kops


class TwoStageResult(NamedTuple):
    """``fr`` is candidate-local: its draw and top-k indices address the
    gathered candidate tables, which map them to reservoirs and frame
    ids."""
    fr: kops.FusedRetrieval        # (S, Q, ·) candidate-local outputs
    cand_members: torch.Tensor     # (S, Q, C, K) per-candidate reservoirs
    cand_counts: torch.Tensor      # (S, Q, C) reservoir counts
    cand_ifr: torch.Tensor         # (S, Q, C) candidate frame ids
    cand_valid: torch.Tensor       # (S, Q, C) candidate validity
    winners: torch.Tensor          # (S, Q, B) stage-1 coarse rows


def _gather_candidates(arena: MemoryArena, winners: torch.Tensor):
    """winners (S, Q, B) coarse rows → the candidate tables (emb (S, Q, C,
    d) f32, members (S, Q, C, K), counts, ifr, valid (S, Q, C)), C =
    B·block, on the arena's first device. A block winner (< n_blocks)
    contributes its block's fine rows (clipped to the capacity; int8 rows
    as raw values in f32, which the scan's normalisation makes
    scale-free); a consolidated winner contributes its row in slot 0 and
    zero rows, masked, in the others. Each slab gathers its own slots'
    winners (``MemoryArena.map_slabs``)."""
    return arena.map_slabs(
        lambda k, w, valid, cvalid: _gather_slab(arena, k, w, valid, cvalid),
        winners, arena.device_valid(), arena.device_coarse_valid())


def _gather_slab(arena: MemoryArena, k: int, winners: torch.Tensor,
                 fine_valid: torch.Tensor, coarse_valid: torch.Tensor):
    """``_gather_candidates`` over slab k: its slots' winners, fine and
    coarse masks on its device. The embeddings are one gather over the
    slab's ``rows``, whose last row is zero, with slot 0 of the
    consolidated winners set after."""
    s, q, b = winners.shape
    blk, cap, d = arena.coarse_block, arena.capacity, arena.dim
    dev = winners.device
    slab = {name: arena.slabs(name)[k] for name in (
        "rows", "members", "member_count", "index_frame", "coarse_emb",
        "coarse_members", "coarse_member_count", "coarse_index_frame")}
    w = winners.long()
    is_blk = w < arena.n_blocks                               # (S, Q, B)
    offs = torch.arange(blk, device=dev)
    first = offs == 0
    sidx = torch.arange(s, device=dev)[:, None, None]
    rows = (w[..., None] * blk + offs).clamp(0, cap - 1)      # (S,Q,B,blk)
    srows = sidx[..., None]
    cw = w.clamp(0, arena.n_coarse - 1)
    flat = torch.where(is_blk[..., None], srows * cap + rows, s * cap)
    emb = slab["rows"].index_select(0, flat.reshape(-1)).to(
        torch.float32).view(s, q, b, blk, d)
    emb[..., 0, :] = torch.where(is_blk[..., None], emb[..., 0, :],
                                 slab["coarse_emb"][sidx, cw])
    blk_ = is_blk[..., None]
    mem = torch.where(blk_[..., None], slab["members"][srows, rows],
                      slab["coarse_members"][sidx, cw][..., None, :])
    cnt = torch.where(blk_, slab["member_count"][srows, rows],
                      slab["coarse_member_count"][sidx, cw][..., None]
                      * first)
    ifr = torch.where(blk_, slab["index_frame"][srows, rows],
                      slab["coarse_index_frame"][sidx, cw][..., None]
                      * first)
    cvalid = coarse_valid[sidx, cw] & ~is_blk
    valid = torch.where(blk_, fine_valid[srows, rows] & blk_,
                        cvalid[..., None] & first)
    c = b * blk
    return (emb.view(s, q, c, d), mem.reshape(s, q, c, -1),
            cnt.reshape(s, q, c), ifr.reshape(s, q, c),
            valid.reshape(s, q, c))


def two_stage_retrieve(arena: MemoryArena, q_stack: torch.Tensor,
                       targets: torch.Tensor, *, tau: float, n_topk: int,
                       topb: int) -> TwoStageResult:
    """One group's coarse → fine retrieval: ``q_stack`` (S, Q, d) and the
    group's own targets (S, Q, T) on the arena's device; ``topb`` is B,
    the stage-1 winners a query keeps."""
    assert arena.n_coarse, "arena has no coarse tier"
    s, q, d = q_stack.shape
    topb = max(1, min(int(topb), arena.n_coarse))
    fr1 = kops.fused_retrieve_stack(
        q_stack, arena.operand("coarse_emb"), tau=tau,
        valid=arena.device_coarse_valid(),
        targets=torch.zeros((s, q, 1), dtype=torch.float32,
                            device=q_stack.device),
        n_topk=topb, mesh=arena.mesh, mesh_axis=arena.mesh_axis,
        tier="coarse")
    winners = fr1.topk_i
    emb, mem, cnt, ifr, valid = _gather_candidates(arena, winners)
    c = topb * arena.coarse_block
    kops.count_fine_gather(s * q * c)
    fr2 = kops.fused_retrieve_stack(
        q_stack.reshape(s * q, 1, d), emb.view(s * q, c, d), tau=tau,
        valid=valid.view(s * q, c), targets=targets.reshape(s * q, 1, -1),
        n_topk=max(1, min(int(n_topk), c)))
    fr = kops.FusedRetrieval(*(x.reshape(s, q, -1) for x in fr2))
    return TwoStageResult(fr, mem, cnt, ifr, valid, winners)


# --- candidate-local post-processing: the executor's flat expansion, one
# --- (session, query) table deeper


def gather_candidate_ifr(cand_ifr: torch.Tensor, draws: torch.Tensor
                         ) -> torch.Tensor:
    """cand_ifr (S, Q, C) × candidate-local draws (S, Q, n) → frame ids
    (S, Q, n)."""
    c = cand_ifr.shape[-1]
    return torch.gather(cand_ifr, -1, draws.long().clamp(0, c - 1))


def expand_candidates(cand_mem, cand_cnt, draws, valid, u):
    """Reservoir expansion over the (S, Q) candidate tables: the flat
    ``expand_gather`` with each (s, q) as a session of its own."""
    s, q, c, k = cand_mem.shape
    n = draws.shape[-1]
    fids, ok = expand_gather(cand_mem.reshape(s * q, c, k),
                             cand_cnt.reshape(s * q, c),
                             draws.reshape(s * q, 1, n),
                             valid.reshape(s * q, 1, n), u)
    return fids.view(s, q, n), ok.view(s, q, n)

