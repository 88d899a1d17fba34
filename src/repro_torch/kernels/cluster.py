"""Incremental clustering of one scene partition: the wrapper of the
hand-written CUDA kernel (``csrc/cluster.cu``) beside its plain version
``ref.cluster_partition_ref``.

A CUDA tensor launches the kernel (or raises): the whole partition in one
launch, one block walking the frames in order. A CPU tensor runs the plain
loop. ``cluster_partition.launches`` counts the launches. Where the running
means live is chosen from the shapes alone (``cluster_plan``): in shared
memory where the K × d means, a ring of two frames and the block's small
state fit in 227 KB (route ``smem``), else in device memory, where L2
holds them (route ``global``).

Both routes return one int32 buffer ``packed`` = [n_clusters, assignments
(T), index frames (K)], so a caller reads the partition's result back to
the host once.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.device import on_device

_SOURCE, _ENTRY = "cluster.cu", "cluster_f32"
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7)
CHUNK = 16                # clusters a block reduction (kChunk)
_MAX_THREADS = 1024
_SMEM = 227 * 1024        # a block's shared memory

_FN = []


def _kernel_fn():
    if not _FN:
        from repro_torch.kernels import build
        lib = build.load(_SOURCE)
        fn = getattr(lib, _ENTRY)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        smem = lib.cluster_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_longlong
        _FN.extend((fn, smem))
    return _FN[0]


def kernel_smem_bytes(d: int, k: int, threads: int, on_chip: bool) -> int:
    """The source's own count of a block's shared memory (built on first
    use), against which ``cluster_smem_bytes`` is checked on the card."""
    _kernel_fn()
    return int(_FN[1](d, k, threads, int(on_chip)))


def cluster_smem_bytes(d: int, k: int, threads: int, on_chip: bool) -> int:
    """A block's shared memory (the source's ``smem_bytes``): each warp's
    partial distances of ``CHUNK`` clusters, twice; on chip also the K × d
    means, a ring of two frames, each warp's counts and the K index-frame
    keys (8 bytes each, 8-byte aligned)."""
    warps = threads // 32
    b = 4 * 2 * warps * CHUNK
    if not on_chip:
        return b
    b += 4 * (k * d + 2 * d + warps * k)
    return -(-b // 8) * 8 + 8 * k


class ClusterPlan(NamedTuple):
    route: str     # "smem" (means on chip) or "global" (in device memory)
    threads: int   # a block's threads: about 4 dimensions each
    smem: int      # a block's shared memory in bytes


def cluster_plan(t: int, d: int, k: int) -> ClusterPlan:
    """The launch of one partition of ``t`` frame vectors of ``d`` into at
    most ``k`` clusters: about 4 dimensions a thread (32 to 1,024
    threads), and the means on chip where they fit."""
    if t < 1 or d < 1 or k < 1:
        raise ValueError(f"cluster_plan({t}, {d}, {k}): every size must be "
                         f">= 1")
    threads = min(_MAX_THREADS, 32 * -(-d // 128))
    smem = cluster_smem_bytes(d, k, threads, True)
    if smem <= _SMEM:
        return ClusterPlan("smem", threads, smem)
    return ClusterPlan("global", threads,
                       cluster_smem_bytes(d, k, threads, False))


def cluster_route(device: torch.device, t: int, d: int, k: int) -> str:
    """``plain`` for a CPU tensor, else the kernel's route."""
    if torch.device(device).type == "cpu":
        return "plain"
    return cluster_plan(t, d, k).route


def _launch(vecs: torch.Tensor, threshold: float, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the vectors' device, on ``cluster_plan``'s
    route."""
    vecs = vecs.contiguous()
    t, d = vecs.shape
    plan = cluster_plan(t, d, k)
    dev = vecs.device
    on_chip = plan.route == "smem"
    # one f32 allocation: centroids (k, d), counts (k), sums (k, d), and
    # off chip each warp's counts
    warps = plan.threads // 32
    fbuf = torch.empty(2 * k * d + k + (0 if on_chip else warps * k),
                       dtype=torch.float32, device=dev)
    keys = None if on_chip else torch.empty(k, dtype=torch.int64,
                                            device=dev)
    packed = torch.empty(1 + t + k, dtype=torch.int32, device=dev)
    base = fbuf.data_ptr()
    fn = _kernel_fn()
    rc = on_device(dev, lambda stream: fn(
        vecs.data_ptr(), t, d, k, float(threshold), plan.threads,
        int(on_chip), base, base + 4 * k * d, base + 4 * (k * d + k),
        None if on_chip else base + 4 * (2 * k * d + k),
        None if keys is None else keys.data_ptr(), packed.data_ptr(),
        stream))
    if rc != 0:
        raise RuntimeError(f"cluster kernel launch failed: cudaError {rc} "
                           f"(plan {plan})")
    cluster_partition.launches += 1
    return packed, fbuf[:k * d].view(k, d), fbuf[k * d:k * d + k]


def cluster_partition(vecs: torch.Tensor, threshold: float,
                      max_clusters: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """vecs (T, d) f32 → (packed (1 + T + K,) int32 = [n_clusters,
    assignments, index frames], centroids (K, d), counts (K,)). CUDA
    tensors run the kernel, CPU tensors the plain version."""
    if vecs.dim() != 2 or vecs.shape[0] < 1 or vecs.shape[1] < 1:
        raise ValueError(f"vecs must be (T, d) with T, d >= 1, got "
                         f"{tuple(vecs.shape)}")
    if vecs.dtype != torch.float32:
        raise TypeError(f"vecs must be float32, got {vecs.dtype}")
    k = int(max_clusters)
    if vecs.device.type == "cuda":
        return _launch(vecs, threshold, k)
    if vecs.device.type == "cpu":
        assign, n, cent, counts, index = ref.cluster_partition_ref(
            vecs, threshold, k)
        return torch.cat([n[None], assign, index]), cent, counts
    raise ValueError(f"no clustering route for device {vecs.device}")


cluster_partition.launches = 0
