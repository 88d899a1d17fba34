"""The cosine-scan kernels' wrappers beside their plain versions:

* ``fused_retrieve_scan_stack`` — the fused retrieval scan
  (``csrc/fused_retrieve.cu``), returning the raw fused contract
  (``ref.FusedRetrieveResult``; ``ops.fused_retrieve_stack`` finalises it);
* ``similarity_scan_stack`` / ``similarity_scan`` — the dense scan
  (``csrc/similarity_scan.cu``), returning the raw triple (sims, m, l);
  ``ops.similarity_stack`` / ``ops.similarity`` add the probabilities.

Each takes the device of its tensors as the route: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version in ``ref``.
Each counts its own launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref

_BLK = 256          # rows per kernel tile (DRAW_BLK)
_QG = 8             # queries per kernel tile
# C entry points: source, name stem, argument types
_FUSED = ("fused_retrieve.cu", "fused_retrieve",
          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
          + [ctypes.c_void_p] * 14)
_SCAN = ("similarity_scan.cu", "similarity_scan",
         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
         + [ctypes.c_void_p] * 6)


def _kernel_fn(entry, index_dtype: torch.dtype):
    from repro_torch.kernels import build
    source, stem, argtypes = entry
    lib = build.load(source)
    fn = getattr(lib, f"{stem}_i8" if index_dtype == torch.int8
                 else f"{stem}_f32")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def unit_queries(query: torch.Tensor) -> torch.Tensor:
    """L2-normalised f32 queries (rsqrt(Σq² + 1e-12)), as the reference
    wrapper hands them to its kernel."""
    q = query.to(torch.float32)
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)


def _scan_operands(query, index, valid):
    """Check a stacked scan's operands (query (S,Q,d), index (S,N,d) f32
    or int8 on one CUDA device) → (unit queries, contiguous index, uint8
    valid mask), each contiguous on the index's device."""
    s, q, d = query.shape
    n = index.shape[1]
    dev = index.device
    if index.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"index must be float32 or int8, got {index.dtype}")
    if (index.shape[0], index.shape[2]) != (s, d):
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, "
                         f"index {tuple(index.shape)}")
    if d % 4:
        raise ValueError(f"the kernel loads rows in 4-element vectors; "
                         f"d={d} is not a multiple of 4")
    if n < 1 or q < 1:
        raise ValueError(f"need N >= 1 and Q >= 1, got N={n}, Q={q}")
    if query.device != dev:
        raise ValueError(f"query on {query.device}, index on {dev}")
    index = index.contiguous()
    if index.data_ptr() % 16:
        raise ValueError("index rows must be 16-byte aligned")
    qn = unit_queries(query).contiguous()
    vmask = ref.as_valid_mask(valid.to(dev), n).to(torch.uint8).contiguous()
    if vmask.shape != (s, n):
        raise ValueError(f"valid gives a mask of {tuple(vmask.shape)}, "
                         f"need {(s, n)}")
    return qn, index, vmask


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
    qn, index, vmask = _scan_operands(query, index, valid)
    tg = targets.to(torch.float32).contiguous()
    # scratch: per-chunk stats, totals, offsets and top-K partials —
    # O(S·Q·N/256), never O(S·Q·N)
    nch = -(-n // _BLK)
    qp = -(-q // _QG) * _QG
    f32 = dict(dtype=torch.float32, device=dev)
    part_m, part_l, totals, offs = (torch.empty((s, qp, nch), **f32)
                                    for _ in range(4))
    ptv = torch.empty((s, qp, nch, n_topk), **f32)
    pti = torch.empty((s, qp, nch, n_topk), dtype=torch.int32, device=dev)
    # counts are integer atomics and drawn_p is written only at a
    # crossing lane: both start at zero
    cnt = torch.zeros((s, q, t), dtype=torch.int32, device=dev)
    dp = torch.zeros((s, q, t), dtype=torch.float32, device=dev)
    p_last = torch.empty((s, q, 1), dtype=torch.float32, device=dev)
    tv = torch.empty((s, q, n_topk), dtype=torch.float32, device=dev)
    ti = torch.empty((s, q, n_topk), dtype=torch.int32, device=dev)
    m = torch.empty((s, q, 1), dtype=torch.float32, device=dev)
    l = torch.empty((s, q, 1), dtype=torch.float32, device=dev)
    fn = _kernel_fn(_FUSED, index.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qn.data_ptr(), index.data_ptr(), vmask.data_ptr(),
                tg.data_ptr(), s, q, n, d, t, n_topk, float(tau),
                part_m.data_ptr(), part_l.data_ptr(), totals.data_ptr(),
                offs.data_ptr(), ptv.data_ptr(), pti.data_ptr(),
                cnt.data_ptr(), dp.data_ptr(), p_last.data_ptr(),
                tv.data_ptr(), ti.data_ptr(), m.data_ptr(), l.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"fused_retrieve kernel launch failed: "
                           f"cudaError {rc}")
    fused_retrieve_scan_stack.launches += 1
    # the max-probability lane is exp(m - m) / l
    p_max = 1.0 / torch.clamp(l, min=1e-30)
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
    qn, index, vmask = _scan_operands(query, index, valid)
    nch = -(-n // _BLK)
    qp = -(-q // _QG) * _QG
    f32 = dict(dtype=torch.float32, device=dev)
    part_m, part_l = (torch.empty((s, qp, nch), **f32) for _ in range(2))
    sims = torch.empty((s, q, n), **f32)
    m = torch.empty((s, q, 1), **f32)
    l = torch.empty((s, q, 1), **f32)
    fn = _kernel_fn(_SCAN, index.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qn.data_ptr(), index.data_ptr(), vmask.data_ptr(), s, q, n,
                index.shape[2], float(tau), part_m.data_ptr(),
                part_l.data_ptr(), sims.data_ptr(), m.data_ptr(),
                l.data_ptr(), stream)
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


def similarity_scan(query: torch.Tensor, index: torch.Tensor,
                    valid: torch.Tensor, *, tau: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 2-D form: query (Q,d), index (N,d), valid (N,) bool → (sims
    (Q,N), m (Q,1), l (Q,1)); on the card the stack kernel at S = 1."""
    if index.device.type == "cuda":
        sims, m, l = _launch_scan(query[None], index[None], valid[None],
                                  tau=tau)
        similarity_scan.launches += 1
        return sims[0], m[0], l[0]
    if index.device.type == "cpu":
        return ref.similarity_scan_ref(query, index, valid, tau=tau)
    raise ValueError(f"no dense scan route for device {index.device}")


similarity_scan.launches = 0
