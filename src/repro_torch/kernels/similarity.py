"""The cosine-scan kernels' wrappers beside their plain versions:

* ``fused_retrieve_scan_stack`` — the fused retrieval scan
  (``csrc/fused_retrieve.cu``), returning the raw fused contract
  (``ref.FusedRetrieveResult``; ``ops.fused_retrieve_stack`` finalises it);
* ``similarity_scan_stack`` — the dense scan over the session stack
  (``csrc/similarity_scan.cu``), and ``similarity_scan`` — its 2-D form
  over one memory (``csrc/similarity_scan_2d.cu``, its tiles planned by
  ``scan2d_plan``), each returning the raw triple (sims, m, l);
  ``ops.similarity_stack`` / ``ops.similarity`` add the probabilities.

Each takes the device of its tensors as the route: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version in ``ref``.
Each counts its own launches in ``.launches``. Every form takes any width
d and any index base. The stack and fused scans share one score pass
(``csrc/scan_tile.cuh``): rows that start on 16 bytes stream through a
``cp.async`` ring where it fits (``scan_stages``), else they are read in
4-element vectors where d is a multiple of 4 and the base is aligned to a
vector, else one element a load.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.device import bool_bytes, on_device, sm_count

_BLK = 256          # rows per kernel tile (DRAW_BLK)
_QG = 8             # queries per kernel tile
_SLAB = 32          # chunks the statistics kernels hold at once (kSlab)
# C entry points: source, name stem, argument types
_FUSED = ("fused_retrieve.cu", "fused_retrieve",
          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
          + [ctypes.c_void_p] * 14)
_SCAN = ("similarity_scan.cu", "similarity_scan",
         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
         + [ctypes.c_void_p] * 6)
_SCAN2D = ("similarity_scan_2d.cu", "similarity_scan_2d",
           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float]
           + [ctypes.c_void_p] * 4)
# the 2-D kernel (kTileMax in its source): rows per full tile
SCAN2D_TILE = 32
_SMEM = 227 * 1024                  # a block's shared memory
_SM_SMEM = 228 * 1024               # an SM's, 1 KB of it reserved a block


_FNS = {}


def _kernel_fn(entry, index_dtype: torch.dtype):
    key = (entry[1], index_dtype)
    fn = _FNS.get(key)
    if fn is None:
        from repro_torch.kernels import build
        source, stem, argtypes = entry
        fn = getattr(build.load(source), f"{stem}_i8"
                     if index_dtype == torch.int8 else f"{stem}_f32")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def unit_queries(query: torch.Tensor) -> torch.Tensor:
    """L2-normalised f32 queries (rsqrt(Σq² + 1e-12)), as the reference
    wrapper hands them to its kernel (the port's kernels normalise their
    own)."""
    q = query.to(torch.float32)
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)


def scan_smem_bytes(d: int, elt: int = 4, stages: int = 0) -> int:
    """Shared memory of a block of the stack and fused scans' score pass
    on the CUDA cores (``scan::scan_smem`` in ``csrc/scan_tile.cuh``), in
    bytes: the 8 queries at a row stride of d rounded up to 4 in f32, then
    each of the 8 warps' rings of ``stages`` groups of 4 rows of d
    elements of ``elt`` bytes."""
    return 4 * _QG * (-(-d // 4) * 4) + stages * 8 * 4 * d * elt


def scan_stages(d: int, elt: int, aligned: bool) -> int:
    """Ring stages of the score pass (``scan::scan_stages``): 3 where
    they fit a block's shared memory, else 2, else 0 (rows read straight
    into registers). Staging needs rows that start on 16 bytes: an index
    base so aligned and d × elt a multiple of 16."""
    if not aligned or d * elt % 16:
        return 0
    return next((st for st in (3, 2)
                 if scan_smem_bytes(d, elt, st) <= _SMEM), 0)


def mma_smem_bytes(d: int) -> int:
    """Shared memory of the tensor-core pass over int8 rows
    (``scan::mma_smem``): the queries' f16 fragments (two terms, d/16
    column blocks, 8 bytes a lane) and their 8 scales."""
    return 2 * (d // 16) * 32 * 8 + 4 * _QG


def scan_plan(d: int, elt: int, aligned: bool) -> Tuple[str, int, int]:
    """How the score pass takes rows of d elements of ``elt`` bytes from
    an index base aligned (or not) to 16 bytes (``scan::mma_ok``,
    ``scan::scan_stages``): ("mma", 0, smem) for int8 rows on the tensor
    cores (d a multiple of 64, the base aligned, ``mma_smem_bytes``
    within 227 KB), else ("ring", stages, smem) or ("direct", 0, smem)."""
    if elt == 1 and aligned and d % 64 == 0 and mma_smem_bytes(d) <= _SMEM:
        return "mma", 0, mma_smem_bytes(d)
    st = scan_stages(d, elt, aligned)
    return ("ring" if st else "direct"), st, scan_smem_bytes(d, elt, st)


def _scan_operands(query, index, valid):
    """Check a stacked scan's operands (query (S,Q,d), index (S,N,d) f32
    or int8 on one CUDA device; a block's 8 queries, which grow with d,
    must fit 227 KB of shared memory) → (f32 queries, which the kernels
    normalise, contiguous index, uint8 valid mask), each contiguous on
    the index's device."""
    s, q, d = query.shape
    n = index.shape[1]
    dev = index.device
    if index.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"index must be float32 or int8, got {index.dtype}")
    if (index.shape[0], index.shape[2]) != (s, d):
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, "
                         f"index {tuple(index.shape)}")
    if scan_smem_bytes(d) > _SMEM:
        raise ValueError(f"d={d}: a block's 8 queries take "
                         f"{scan_smem_bytes(d)} bytes of shared memory, "
                         f"more than {_SMEM}")
    if n < 1 or q < 1:
        raise ValueError(f"need N >= 1 and Q >= 1, got N={n}, Q={q}")
    if query.device != dev:
        raise ValueError(f"query on {query.device}, index on {dev}")
    index = index.contiguous()
    q32 = query.to(torch.float32).contiguous()
    vmask = bool_bytes(ref.as_valid_mask(valid.to(dev), n), dev)
    if vmask.shape != (s, n):
        raise ValueError(f"valid gives a mask of {tuple(vmask.shape)}, "
                         f"need {(s, n)}")
    return q32, index, vmask


def _launch(query, index, valid, targets, *, tau: float, n_topk: int
            ) -> ref.FusedRetrieveResult:
    s, q, d = query.shape
    n = index.shape[1]
    t = targets.shape[2]
    dev = index.device
    if targets.shape[:2] != (s, q) or targets.device != dev:
        raise ValueError(f"targets {tuple(targets.shape)} on "
                         f"{targets.device}, need {(s, q)} on {dev}")
    if not 1 <= n_topk <= n or t < 1:
        raise ValueError(f"need 1 <= n_topk <= N and T >= 1, got "
                         f"n_topk={n_topk}, N={n}, T={t}")
    q32, index, vmask = _scan_operands(query, index, valid)
    tg = targets.to(torch.float32).contiguous()
    # scratch: the valid rows' scores (S·Q·N f32: the only O(S·Q·N)
    # buffer, L2-sized at the smoke shape and never returned), each 256-row
    # chunk's stats and each slab's (32 chunks') top-K
    nch = -(-n // _BLK)
    nslab = -(-nch // _SLAB)
    f32 = dict(dtype=torch.float32, device=dev)
    ws = torch.empty((s, q, n), **f32)
    part_m, part_l = (torch.empty((s, q, nch), **f32) for _ in range(2))
    ptv = torch.empty((s, q, nslab, n_topk), **f32)
    pti = torch.empty((s, q, nslab, n_topk), dtype=torch.int32, device=dev)
    # every output is written by the kernel
    cnt = torch.empty((s, q, t), dtype=torch.int32, device=dev)
    dp = torch.empty((s, q, t), **f32)
    p_last, m, l, p_max = (torch.empty((s, q, 1), **f32) for _ in range(4))
    tv = torch.empty((s, q, n_topk), **f32)
    ti = torch.empty((s, q, n_topk), dtype=torch.int32, device=dev)
    fn = _kernel_fn(_FUSED, index.dtype)
    rc = on_device(dev, lambda stream: fn(
        q32.data_ptr(), index.data_ptr(), vmask.data_ptr(), tg.data_ptr(), s,
        q, n, d, t, n_topk, float(tau), ws.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), ptv.data_ptr(), pti.data_ptr(), cnt.data_ptr(),
        dp.data_ptr(), p_last.data_ptr(), tv.data_ptr(), ti.data_ptr(),
        m.data_ptr(), l.data_ptr(), p_max.data_ptr(), stream))
    if rc != 0:
        raise RuntimeError(f"fused_retrieve kernel launch failed: "
                           f"cudaError {rc}")
    fused_retrieve_scan_stack.launches += 1
    return ref.FusedRetrieveResult(cnt, dp, p_last, tv, ti, m, l, p_max)


def fused_retrieve_scan_stack(query: torch.Tensor, index: torch.Tensor,
                              valid: torch.Tensor, targets: torch.Tensor, *,
                              tau: float, n_topk: int
                              ) -> ref.FusedRetrieveResult:
    """One-launch fused retrieval over the session stack: query (S,Q,d),
    index (S,N,d) f32 or int8, valid in any ``as_valid_mask`` form,
    targets (S,Q,T) → raw counts, drawn_p, p_last, top-k, m, l, p_max.
    CUDA tensors run the kernel, CPU tensors the plain version."""
    if index.device.type == "cuda":
        return _launch(query, index, valid, targets, tau=tau, n_topk=n_topk)
    if index.device.type == "cpu":
        return ref.fused_retrieve_stack_ref(query, index, valid, targets,
                                            tau=tau, n_topk=n_topk)
    raise ValueError(f"no fused retrieval route for device {index.device}")


fused_retrieve_scan_stack.launches = 0


def _launch_scan(query, index, valid, *, tau: float):
    s, q, _ = query.shape
    n = index.shape[1]
    dev = index.device
    q32, index, vmask = _scan_operands(query, index, valid)
    nch = -(-n // _BLK)
    f32 = dict(dtype=torch.float32, device=dev)
    part_m, part_l = (torch.empty((s, q, nch), **f32) for _ in range(2))
    sims = torch.empty((s, q, n), **f32)
    m = torch.empty((s, q, 1), **f32)
    l = torch.empty((s, q, 1), **f32)
    fn = _kernel_fn(_SCAN, index.dtype)
    rc = on_device(dev, lambda stream: fn(
        q32.data_ptr(), index.data_ptr(), vmask.data_ptr(), s, q, n,
        index.shape[2], float(tau), part_m.data_ptr(), part_l.data_ptr(),
        sims.data_ptr(), m.data_ptr(), l.data_ptr(), stream))
    if rc != 0:
        raise RuntimeError(f"similarity_scan kernel launch failed: "
                           f"cudaError {rc}")
    return sims, m, l


def similarity_scan_stack(query: torch.Tensor, index: torch.Tensor,
                          valid: torch.Tensor, *, tau: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Dense scan over the session stack: query (S,Q,d), index (S,N,d)
    f32 or int8, valid in any ``as_valid_mask`` form → (sims (S,Q,N),
    m (S,Q,1), l (S,Q,1)). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if index.device.type == "cuda":
        out = _launch_scan(query, index, valid, tau=tau)
        similarity_scan_stack.launches += 1
        return out
    if index.device.type == "cpu":
        return ref.similarity_scan_stack_ref(query, index, valid, tau=tau)
    raise ValueError(f"no dense scan route for device {index.device}")


similarity_scan_stack.launches = 0


def _scan2d_smem(tile: int, stages: int, qg: int, d: int, elt: int) -> int:
    """Shared memory of a 2-D scan block (the source's ``smem_bytes``):
    the queries, two tiles of staged scores and the halves' partials in
    f32, the ring."""
    qp, dq = -(-qg // 8) * 8, -(-d // 4) * 4
    stage = -(-(tile * d * elt + 16) // 16) * 16
    return 4 * (qp * dq + 2 * qp * SCAN2D_TILE + 384) + stages * stage


@functools.lru_cache(maxsize=256)
def scan2d_plan(n: int, d: int, elt: int, q: int, sms: int) -> tuple:
    """(rows per tile, ring stages, queries per block, blocks along the
    rows, tiles per block) of the 2-D kernel for N rows of d elements of
    ``elt`` bytes and Q queries on ``sms`` SMs. A block holds all Q
    queries where shared memory allows, with the largest tile of 32, 16
    or 8 rows and a ring of 3 stages, else 2; else groups of a multiple
    of 8 queries (the grid's second axis) with 2 stages, the tile halving
    for rows so wide that 8 queries do not fit. The blocks fill every SM
    as often as shared memory lets them be resident, each walking
    ``per`` contiguous tiles: block b takes tiles [b*per, min((b+1)*per,
    tiles)), none empty."""
    plan = next(((tile, st, q) for tile in (SCAN2D_TILE, 16, 8)
                 for st in (3, 2)
                 if _scan2d_smem(tile, st, q, d, elt) <= _SMEM), None)
    tile = SCAN2D_TILE
    while plan is None:
        ring = _scan2d_smem(tile, 2, 0, d, elt)
        per_q = _scan2d_smem(tile, 2, 8, d, elt) - ring
        fit = (_SMEM - ring) // per_q * 8
        if fit >= 8:
            plan = (tile, 2, min(q, fit))
        elif tile == 1:
            raise ValueError(f"rows of {d} elements do not fit the 2-D "
                             f"scan's shared memory")
        else:
            tile //= 2
    tile, stages, qg = plan
    smem = _scan2d_smem(tile, stages, qg, d, elt)
    resident = max(1, _SM_SMEM // (smem + 1024))
    want = -(-resident * sms // -(-q // qg))
    tiles = -(-n // tile)
    per = -(-tiles // max(1, min(tiles, want)))
    return tile, stages, qg, -(-tiles // per), per


def _launch_scan_2d(query, index, valid, *, tau: float):
    q, d = query.shape
    n = index.shape[0]
    dev = index.device
    if index.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"index must be float32 or int8, got {index.dtype}")
    if index.dim() != 2 or index.shape[1] != d or n < 1 or q < 1:
        raise ValueError(f"shapes query {tuple(query.shape)}, index "
                         f"{tuple(index.shape)}")
    if query.device != dev:
        raise ValueError(f"query on {query.device}, index on {dev}")
    if tuple(valid.shape) != (n,):
        raise ValueError(f"valid must be ({n},), got {tuple(valid.shape)}")
    if 8 * -(-n // _BLK) > _SMEM:
        raise ValueError(f"N={n}: the statistics pass keeps two floats a "
                         f"256-row chunk in shared memory")
    query = query.to(torch.float32).contiguous()
    index = index.contiguous()
    vmask = bool_bytes(valid, dev)
    tile, stages, qg, _, per = scan2d_plan(n, d, index.element_size(), q,
                                           sm_count(dev))
    # one allocation: sims, then m and l
    buf = torch.empty(q * n + 2 * q, dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    fn = _kernel_fn(_SCAN2D, index.dtype)
    rc = on_device(dev, lambda stream: fn(
        query.data_ptr(), index.data_ptr(), vmask.data_ptr(), q, n, d, tile,
        stages, qg, per, float(tau), base, base + 4 * q * n,
        base + 4 * (q * n + q), stream))
    if rc != 0:
        raise RuntimeError(f"similarity_scan kernel launch failed: "
                           f"cudaError {rc}")
    return (buf[:q * n].view(q, n), buf[q * n:q * n + q].view(q, 1),
            buf[q * n + q:q * n + 2 * q].view(q, 1))


def similarity_scan(query: torch.Tensor, index: torch.Tensor,
                    valid: torch.Tensor, *, tau: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 2-D form: query (Q,d), index (N,d) f32 or int8, valid (N,) bool
    → (sims (Q,N), m (Q,1), l (Q,1)). CUDA tensors run the 2-D kernel,
    CPU tensors the plain version."""
    if index.device.type == "cuda":
        out = _launch_scan_2d(query, index, valid, tau=tau)
        similarity_scan.launches += 1
        return out
    if index.device.type == "cpu":
        return ref.similarity_scan_ref(query, index, valid, tau=tau)
    raise ValueError(f"no dense scan route for device {index.device}")


similarity_scan.launches = 0
