"""Scene score (Eq. 1): the wrapper of the hand-written CUDA kernel
(``csrc/scene_score.cu``) beside its plain version ``ref.scene_score_ref``.

φ(f_t) = Σ_c w_c · Σ_px |v_t − v_{t−1}| / (Σw · H·W), v = [hue, sat,
light, edge], φ_0 = 0; with ``prev`` (the frame before the clip) φ_t for
every frame of the clip, frame −1 = prev, and no leading zero.

A CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version; ``scene_score.launches`` counts the launches. The kernel cuts each
frame into bands of rows and the differences into chunks
(``scene_plan``); the source says how.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.device import on_device, sm_count

_SOURCE, _ENTRY = "scene_score.cu", "scene_score_f32"
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 3)
_THREADS = 256            # a block's threads (kThreads in the source)
_WARPS = _THREADS // 32
MAX_CHUNK = 16            # differences a block, at most (kMaxChunk)
_MAX_BAND = 64            # rows a band, at most
_RESIDENT = 2             # blocks an SM holds (the registers k_scene takes)
_SMEM = 227 * 1024        # a block's shared memory

_FN = []


def _kernel_fn():
    if not _FN:
        from repro_torch.kernels import build
        lib = build.load(_SOURCE)
        fn = getattr(lib, _ENTRY)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        smem = lib.scene_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_longlong
        _FN.extend((fn, smem))
    return _FN[0]


def kernel_smem_bytes(rb: int, w: int, stages: int, fc: int) -> int:
    """The source's own count of a block's shared memory (built on first
    use), against which ``scene_smem_bytes`` is checked on the card."""
    _kernel_fn()
    return int(_FN[1](rb, w, stages, fc))


def scene_smem_bytes(rb: int, w: int, stages: int, fc: int) -> int:
    """A block's shared memory (the source's ``smem_bytes``): ``stages``
    ring stages of a band of ``rb`` rows and its halo, in quads of 4
    pixels (12 floats), the band's lightness with its halo (4 floats a
    quad), and each warp's sum of each of ``fc`` differences."""
    quads = -(-((rb + 1) * w) // 4)
    return 4 * ((12 * stages + 4) * quads + _WARPS * fc)


def _band_fits(rb: int, w: int, pix: int) -> bool:
    """A band's quads, one more where the halo ends inside one, are at
    most the threads' (``pix`` pixels, pix / 4 quads, a thread)."""
    return (rb * w + 6) // 4 <= _THREADS * pix // 4


class ScenePlan(NamedTuple):
    rb: int        # rows a band (the last band may be shorter)
    fc: int        # differences a chunk (the last chunk may be shorter)
    bands: int     # the grid's first axis
    chunks: int    # its second
    stages: int    # ring stages, 3 or 2
    copy: int      # bytes a cp.async: 16, or 4
    pix: int       # pixels a thread (8, or 32 for rows wider than 2,045)
    smem: int      # a block's shared memory in bytes


@functools.lru_cache(maxsize=256)
def scene_plan(n_frames: int, h: int, w: int, sms: int,
               aligned: bool = True) -> ScenePlan:
    """The kernel's grid for a sequence of ``n_frames`` frames of h × w
    (the clip's, with ``prev`` in front when it is given: n_frames − 1
    differences) on ``sms`` SMs. Block (b, c) takes rows [b·rb,
    min((b+1)·rb, h)) with row b·rb − 1 as its halo (none for b = 0), and
    differences [c·fc, min((c+1)·fc, n_frames − 1)), featurising frames
    c·fc .. c·fc + fc of the sequence (odd chunks walk them backwards),
    the first walked only to diff against.

    Every thread computes ``pix`` pixels a frame (4-pixel quads; 8, or 32
    where a row does not fit 8), whatever the band holds, so a band is as
    tall as the threads hold (at most 64 rows), and halved where 2 ring
    stages do not fit in 227 KB. The chunks then give about
    ``_RESIDENT`` blocks an SM: ⌊_RESIDENT·sms / bands⌋ chunks of at most
    16 differences (fewer where shared memory runs out), in 3 ring stages
    where they fit, else 2. Copies are 16 bytes where w % 4 == 0 and the
    frames' bases are 16-byte ``aligned``, else 4. Raises, naming the
    limit, where one row with its halo does not fit in 2 stages."""
    if n_frames < 1 or h < 1 or w < 1 or sms < 1:
        raise ValueError(f"scene_plan({n_frames}, {h}, {w}, {sms}): every "
                         f"size must be >= 1")
    pix = 8 if _band_fits(1, w, 8) else 32
    rb = min(h, _MAX_BAND)
    while rb > 1 and not _band_fits(rb, w, pix):
        rb -= 1
    while rb > 1 and scene_smem_bytes(rb, w, 2, 1) > _SMEM:
        rb //= 2
    if scene_smem_bytes(rb, w, 2, 1) > _SMEM:
        raise ValueError(
            f"a row of {w} pixels with its halo row does not fit a block's "
            f"{_SMEM} bytes of shared memory in 2 ring stages "
            f"({scene_smem_bytes(1, w, 2, 1)} bytes)")
    bands = -(-h // rb)
    n_diff = n_frames - 1
    chunks = max(1, min(n_diff, _RESIDENT * sms // bands))
    fc = min(MAX_CHUNK, max(1, -(-n_diff // chunks)))
    while fc > 1 and scene_smem_bytes(rb, w, 2, fc) > _SMEM:
        fc -= 1
    chunks = max(1, -(-n_diff // fc))
    stages = 3 if scene_smem_bytes(rb, w, 3, fc) <= _SMEM else 2
    return ScenePlan(rb, fc, bands, chunks, stages,
                     16 if aligned and w % 4 == 0 else 4, pix,
                     scene_smem_bytes(rb, w, stages, fc))


def _check(frames: torch.Tensor, prev: Optional[torch.Tensor]) -> None:
    if frames.dim() != 4 or frames.shape[-1] != 3 or frames.shape[0] < 1:
        raise ValueError(f"frames must be (T,H,W,3) with T >= 1, got "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if prev is not None:
        if tuple(prev.shape) != tuple(frames.shape[1:]):
            raise ValueError(f"prev must be {tuple(frames.shape[1:])}, got "
                             f"{tuple(prev.shape)}")
        if prev.dtype != torch.float32 or prev.device != frames.device:
            raise ValueError(f"prev is {prev.dtype} on {prev.device}, "
                             f"frames float32 on {frames.device}")


def _launch(frames: torch.Tensor, weights: Sequence[float],
            prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on the frames' device, on ``scene_plan``'s grid."""
    _check(frames, prev)
    frames = frames.contiguous()
    prev = None if prev is None else prev.contiguous()
    t, h, w, _ = frames.shape
    dev = frames.device
    n = t + (prev is not None)
    aligned = (frames.data_ptr() % 16 == 0
               and (prev is None or prev.data_ptr() % 16 == 0))
    plan = scene_plan(n, h, w, sm_count(dev), aligned)
    wts = np.asarray([float(x) for x in weights], np.float32)
    # Σw·H·W in fp32, as the reference forms it
    norm = np.float32(wts.sum(dtype=np.float32) * np.float32(h * w))
    # one allocation: φ (t floats), then the (n − 1, bands) partials
    buf = torch.empty(t + (n - 1) * plan.bands, dtype=torch.float32,
                      device=dev)
    base = buf.data_ptr()
    fn = _kernel_fn()
    rc = on_device(dev, lambda stream: fn(
        frames.data_ptr(), 0 if prev is None else prev.data_ptr(), t, h, w,
        plan.rb, plan.fc, plan.stages, plan.copy, plan.pix, *map(float, wts),
        float(norm), base + 4 * t, base, stream))
    if rc != 0:
        raise RuntimeError(f"scene_score kernel launch failed: cudaError "
                           f"{rc} (plan {plan})")
    scene_score.launches += 1
    return buf[:t]


def scene_score(frames: torch.Tensor, weights: Sequence[float],
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames (T,H,W,3) f32 in [0,1] → φ (T,) f32: φ[0] = 0, or with
    ``prev`` (H,W,3) the score of frames[0] against it. CUDA tensors run
    the kernel, CPU tensors the plain version."""
    if frames.device.type == "cuda":
        return _launch(frames, weights, prev)
    if frames.device.type == "cpu":
        return ref.scene_score_ref(frames, weights, prev)
    raise ValueError(f"no scene-score route for device {frames.device}")


scene_score.launches = 0
