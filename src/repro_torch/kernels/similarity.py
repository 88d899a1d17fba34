"""Fused retrieval scan: the wrapper of the hand-written CUDA kernel
(``csrc/fused_retrieve.cu``) beside its plain version.

``fused_retrieve_scan_stack`` takes the device of its tensors as the
route: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``ref.fused_retrieve_stack_ref``. It returns the raw fused contract
(``ref.FusedRetrieveResult``); ``ops.fused_retrieve_stack`` finalises it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

_SOURCE = "fused_retrieve.cu"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_void_p] * 14)
_BLK = 256          # rows per kernel tile (DRAW_BLK)
_QG = 8             # queries per kernel tile


def _kernel_fn(index_dtype: torch.dtype):
    from repro_torch.kernels import build
    lib = build.load(_SOURCE)
    fn = (lib.fused_retrieve_i8 if index_dtype == torch.int8
          else lib.fused_retrieve_f32)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def unit_queries(query: torch.Tensor) -> torch.Tensor:
    """L2-normalised f32 queries (rsqrt(Σq² + 1e-12)), as the reference
    wrapper hands them to its kernel."""
    q = query.to(torch.float32)
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)


def _launch(query, index, valid, targets, *, tau: float, n_topk: int
            ) -> ref.FusedRetrieveResult:
    s, q, d = query.shape
    n = index.shape[1]
    t = targets.shape[2]
    dev = index.device
    if index.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"index must be float32 or int8, got {index.dtype}")
    if (index.shape[0], index.shape[2]) != (s, d) \
            or targets.shape[:2] != (s, q):
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, "
                         f"index {tuple(index.shape)}, targets "
                         f"{tuple(targets.shape)}")
    if d % 4:
        raise ValueError(f"the kernel loads rows in 4-element vectors; "
                         f"d={d} is not a multiple of 4")
    if not 1 <= n_topk <= n or t < 1:
        raise ValueError(f"need 1 <= n_topk <= N and T >= 1, got "
                         f"n_topk={n_topk}, N={n}, T={t}")
    for name, x in (("query", query), ("targets", targets)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, index on {dev}")
    index = index.contiguous()
    if index.data_ptr() % 16:
        raise ValueError("index rows must be 16-byte aligned")
    qn = unit_queries(query).contiguous()
    vmask = ref.as_valid_mask(valid.to(dev), n).to(torch.uint8).contiguous()
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
    fn = _kernel_fn(index.dtype)
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
