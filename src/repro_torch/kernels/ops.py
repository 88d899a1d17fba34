"""Kernel dispatch layer.

The route is the device of the tensors: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor takes the kernel's plain
PyTorch version. There is no backend switch and no fallback.

The scan counters keep the reference's 11 names (``repro.kernels.ops``)
so the same invariants read the same way in both packages. Sharded
accounting: ``sharded_stack_launches`` counts the stack scans that ran
once per slab (K > 1 on ``mesh_axis``; a K == 1 mesh is the single
launch, bit for bit), ``shard_gather_bytes`` the bytes of their outputs
brought to the mesh's first device — the 8 raw outputs of #1, sims and
probs of #3 — so "only the epilogue crosses" is a counter. Two-stage
accounting: ``coarse_scan_bytes`` is the part of ``scan_bytes`` that
stage-1 scans over the coarse tier stream, ``fine_gather_rows`` the
candidate rows stage 2 gathers (padding slots included) and
``two_stage_scans`` the coarse→fine retrievals. ``standing_scan_bytes``
is the part that standing-query launches stream over a tick's new-row
slab.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import cluster as _cluster
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import ref
from repro_torch.kernels import scene_score as _scene
from repro_torch.kernels import similarity as _sim
from repro_torch.launch.sharding import mesh_axis_size, slab_devices

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
            "cluster_partition": _cluster.cluster_partition,
            "gqa_decode": _decode.gqa_decode,
            "merge_partials": _decode.merge_partials,
            "mla_decode": _decode.mla_decode}


def kernel_launches() -> dict:
    """Launch count of each hand-written kernel (bumped where the kernel
    is launched, never on the plain path)."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_kernel_launches() -> None:
    """Zero every launch count, and the decode wrappers' counts by route."""
    for fn in _KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "partial_launches"):
            fn.partial_launches = 0
        for route in getattr(fn, "route_launches", ()):
            fn.route_launches[route] = 0


def _index_bytes(index) -> int:
    """Bytes of an index operand: one tensor or a list of slabs."""
    return sum(x.numel() * x.element_size() for x in
               (index if isinstance(index, (list, tuple)) else (index,)))


def count_fine_gather(n_rows: int) -> None:
    """Stage 2 of one two-stage retrieval gathered ``n_rows`` candidate
    rows out of the fine arena."""
    _scan_counts["fine_gather_rows"] += int(n_rows)
    _scan_counts["two_stage_scans"] += 1


def decode_attention(q, k, v, valid, *, scale: float, softcap: float = 0.0,
                     q_per_kv: int = 1, partials: bool = False):
    """q (B,1,H,D); k/v (B,C,Hkv,D); valid (B or 1, C) → (B,1,H,D); with
    ``partials`` the unmerged softmax partials (m, l, acc) instead."""
    return _decode.gqa_decode(q, k, v, valid, scale=scale, softcap=softcap,
                              q_per_kv=q_per_kv, partials=partials)


def merge_partials(m, l, acc, dtype) -> torch.Tensor:
    """Softmax partials (m, l (B,H,N), acc (B,H,N,D)) → (B,1,H,D)."""
    return _decode.merge_partials(m, l, acc, dtype)


def mla_decode_attention(q_abs, q_rope, ckv, krope, valid, *,
                         scale: float, partials: bool = False):
    """q_abs (B,1,H,R), q_rope (B,1,H,Dr), ckv (B,C,R), krope (B,C,Dr),
    valid (B or 1, C) → latent context (B,1,H,R); with ``partials`` the
    unmerged softmax partials (m, l, acc) instead."""
    return _decode.mla_decode(q_abs, q_rope, ckv, krope, valid, scale=scale,
                              partials=partials)


def similarity(query, index, *, tau: float, valid
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q,d) × index (N,d) f32 or int8 + valid (N,) bool → (sims
    (Q,N), probs (Q,N)): the 2-D dense scan (the kernel on the card, its
    plain version on the CPU) and the probability epilogue."""
    _scan_counts["similarity"] += 1
    _scan_counts["dense_score_launches"] += 1
    _scan_counts["scan_bytes"] += _index_bytes(index)
    valid = valid.to(index.device)
    sims, m, l = _sim.similarity_scan(query, index, valid, tau=tau)
    return sims, ref.scan_probs(sims, m, l, valid[None, :], tau)


def _slab_devices(mesh, mesh_axis: str, s: int
                  ) -> Optional[List[torch.device]]:
    """The slabs' devices of a sharded launch over S sessions, or None
    for the single launch (no mesh, or K == 1). S must split into K."""
    k = mesh_axis_size(mesh, mesh_axis)
    if k <= 1:
        return None
    if s % k:
        raise ValueError(f"{s} sessions do not split into {k} slabs "
                         f"over mesh axis {mesh_axis!r}")
    return slab_devices(mesh, mesh_axis)


def _split(x: torch.Tensor, devs: Sequence[torch.device]
           ) -> List[torch.Tensor]:
    """An (S, …) operand → its K contiguous slabs, each on its device."""
    return [p.to(d) for p, d in zip(x.chunk(len(devs)), devs)]


def _index_slabs(index, devs) -> List[torch.Tensor]:
    """The index operand's slabs: a list of K slab tensors as the sharded
    arena keeps them, or one (S, N, d) tensor split along S."""
    if isinstance(index, (list, tuple)):
        if len(index) != len(devs):
            raise ValueError(f"{len(index)} index slabs for {len(devs)} "
                             f"mesh devices")
        return [x.to(d) for x, d in zip(index, devs)]
    return _split(index, devs)


def _gather(parts, home: torch.device) -> List[torch.Tensor]:
    """Per-slab output tuples → each output concatenated along S on
    ``home``, their bytes counted into ``shard_gather_bytes``."""
    out = [torch.cat([p[i].to(home) for p in parts])
           for i in range(len(parts[0]))]
    _scan_counts["sharded_stack_launches"] += 1
    _scan_counts["shard_gather_bytes"] += sum(
        x.numel() * x.element_size() for x in out)
    return out


IndexOperand = Union[torch.Tensor, Sequence[torch.Tensor]]


def similarity_stack(query, index: IndexOperand, *, tau: float, valid,
                     mesh=None, mesh_axis: str = "model"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-session dense scan in ONE launch: query (S,Q,d) × index
    (S,N,d) f32 or int8 + valid in any canonical form → (sims (S,Q,N),
    probs (S,Q,N)). The mask is built once, for the scan and the
    epilogue.

    With ``mesh`` carrying K > 1 shards on ``mesh_axis`` the scan runs
    once per contiguous slot slab on the slab's device — ``index`` the
    arena's K slab tensors or one tensor split along S — and sims and
    probs come back to the mesh's first device; the per-lane math makes
    the result bit-identical to the single launch. K == 1 (or no mesh)
    is the single launch."""
    _scan_counts["similarity_stack"] += 1
    _scan_counts["dense_score_launches"] += 1
    _scan_counts["scan_bytes"] += _index_bytes(index)
    devs = _slab_devices(mesh, mesh_axis, query.shape[0])
    if devs is None:
        return _stack_local(query, index, valid, tau)
    parts = [_stack_local(q, x, v, tau) for q, x, v in zip(
        _split(query, devs), _index_slabs(index, devs),
        _split(valid, devs))]
    return tuple(_gather(parts, devs[0]))


def _stack_local(query, index, valid, tau: float):
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


def fused_retrieve_stack(query, index: IndexOperand, *, tau: float, valid,
                         targets, n_topk: int, mesh=None,
                         mesh_axis: str = "model",
                         tier: str = "fine") -> FusedRetrieval:
    """One-launch fused retrieval: query (S,Q,d) × index (S,N,d) f32 or
    int8 + valid (any canonical mask form) + targets (S,Q,T) → draws,
    drawn probabilities, top-k and softmax stats. Targets beyond the
    accumulated mass clip to lane N-1 and take ``p_last`` as their drawn
    probability, identically for both routes.

    With ``mesh`` carrying K > 1 shards on ``mesh_axis`` the launch runs
    once per contiguous slot slab on the slab's device (``index`` as in
    ``similarity_stack``), and only the 8 raw epilogue outputs, O(S·Q·(T
    + K)), come back to the mesh's first device: draws and top-k are
    session-local lanes, so the gather is a concatenation. K == 1 (or no
    mesh) is the single launch.

    ``tier="coarse"`` is the same launch over the coarse tier (stage 1 of
    a two-stage retrieval): its bytes also count into
    ``coarse_scan_bytes``. ``tier="standing"`` is the single launch over
    a tick's compact new-row slab (``core.standing``), never sharded: its
    bytes also count into ``standing_scan_bytes``."""
    if tier not in ("fine", "coarse", "standing"):
        raise ValueError(f"unknown tier {tier!r}")
    _scan_counts["similarity_stack"] += 1
    _scan_counts["fused_draw_launches"] += 1
    nbytes = _index_bytes(index)
    _scan_counts["scan_bytes"] += nbytes
    if tier != "fine":
        _scan_counts[f"{tier}_scan_bytes"] += nbytes
    devs = (None if tier == "standing"
            else _slab_devices(mesh, mesh_axis, query.shape[0]))
    if devs is None:
        n = index.shape[1]
        return finalize(_sim.fused_retrieve_scan_stack(
            query, index, valid, targets, tau=tau, n_topk=n_topk), n)
    slabs = _index_slabs(index, devs)
    parts = [_sim.fused_retrieve_scan_stack(q, x, v, t, tau=tau,
                                            n_topk=n_topk)
             for q, x, v, t in zip(_split(query, devs), slabs,
                                   _split(valid, devs),
                                   _split(targets, devs))]
    return finalize(ref.FusedRetrieveResult(*_gather(parts, devs[0])),
                    slabs[0].shape[1])


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
