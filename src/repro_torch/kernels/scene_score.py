"""Scene score (Eq. 1) as a hand-written Triton kernel, beside its plain
version ``ref.scene_score_ref``.

φ(f_t) = Σ_c w_c · Σ_px |v_t − v_{t−1}| / (Σw · H·W), v = [hue, sat,
light, edge], φ_0 = 0.

Replaces: src/repro/kernels/scene_score.py::scene_score (_scene_kernel,
the TPU Pallas kernel), which walks the frames sequentially and carries
frame t−1's feature maps in VMEM.

What bounds it on an H100: bytes. Each frame must be read once (T·H·W·3
f32; 65 frames of 224² are 39.1 MB, ~11.7 µs at 3.35 TB/s); the
arithmetic per pixel is a few dozen flops.

Design: one program per frame t, with no state carried between programs
— each program recomputes frame t−1's features itself (program 0 stores
φ_0 = 0). Frame t−1 and the left/up
neighbours come from L2 when the neighbouring program has just read
them, so device-memory traffic stays near one read per frame. A program
walks its frame in 1024-pixel blocks and reduces once at the end, so φ
is deterministic (no atomics). Traps kept from the reference: the hue
modulo takes the divisor's sign (x − 6·floor(x/6)), the edge map has a
zero first row and column, saturation's denominator carries +1e-6.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import BUILD_DIR

# triton.language, bound at first launch (this module must import where
# Triton is absent); the kernel body below resolves ``tl`` through it
tl = None
_JIT: Optional[object] = None


def _scene_phi_kernel(f_ptr, phi_ptr, H, W, w_h, w_s, w_l, w_e, norm):
    t = tl.program_id(0)
    hw = H * W
    cur = f_ptr + t.to(tl.int64) * hw * 3
    prv = f_ptr + tl.maximum(t - 1, 0).to(tl.int64) * hw * 3
    acc = tl.zeros([1024], dtype=tl.float32)
    for start in range(0, hw, 1024):
        pix = start + tl.arange(0, 1024)
        inb = pix < hw
        left = inb & ((pix % W) > 0)
        up = inb & (pix >= W)
        # ---- frame t ----
        r = tl.load(cur + pix * 3, mask=inb, other=0.0)
        g = tl.load(cur + pix * 3 + 1, mask=inb, other=0.0)
        b = tl.load(cur + pix * 3 + 2, mask=inb, other=0.0)
        mx = tl.maximum(tl.maximum(r, g), b)
        mn = tl.minimum(tl.minimum(r, g), b)
        c = mx - mn
        lc = 0.5 * (mx + mn)
        sc = c / (1.0 - tl.abs(2.0 * lc - 1.0) + 1e-6)
        safe = tl.where(c > 0, c, 1.0)
        hr = (g - b) / safe
        hr = hr - 6.0 * tl.floor(hr / 6.0)
        hc = tl.where(mx == r, hr,
                      tl.where(mx == g, (b - r) / safe + 2.0,
                               (r - g) / safe + 4.0)) / 6.0
        hc = tl.where(c > 0, hc, 0.0)
        r = tl.load(cur + (pix - 1) * 3, mask=left, other=0.0)
        g = tl.load(cur + (pix - 1) * 3 + 1, mask=left, other=0.0)
        b = tl.load(cur + (pix - 1) * 3 + 2, mask=left, other=0.0)
        ll = 0.5 * (tl.maximum(tl.maximum(r, g), b)
                    + tl.minimum(tl.minimum(r, g), b))
        r = tl.load(cur + (pix - W) * 3, mask=up, other=0.0)
        g = tl.load(cur + (pix - W) * 3 + 1, mask=up, other=0.0)
        b = tl.load(cur + (pix - W) * 3 + 2, mask=up, other=0.0)
        lu = 0.5 * (tl.maximum(tl.maximum(r, g), b)
                    + tl.minimum(tl.minimum(r, g), b))
        ec = (tl.where(left, tl.abs(lc - ll), 0.0)
              + tl.where(up, tl.abs(lc - lu), 0.0))
        # ---- frame t-1 ----
        r = tl.load(prv + pix * 3, mask=inb, other=0.0)
        g = tl.load(prv + pix * 3 + 1, mask=inb, other=0.0)
        b = tl.load(prv + pix * 3 + 2, mask=inb, other=0.0)
        mx = tl.maximum(tl.maximum(r, g), b)
        mn = tl.minimum(tl.minimum(r, g), b)
        c = mx - mn
        lp = 0.5 * (mx + mn)
        sp = c / (1.0 - tl.abs(2.0 * lp - 1.0) + 1e-6)
        safe = tl.where(c > 0, c, 1.0)
        hr = (g - b) / safe
        hr = hr - 6.0 * tl.floor(hr / 6.0)
        hp = tl.where(mx == r, hr,
                      tl.where(mx == g, (b - r) / safe + 2.0,
                               (r - g) / safe + 4.0)) / 6.0
        hp = tl.where(c > 0, hp, 0.0)
        r = tl.load(prv + (pix - 1) * 3, mask=left, other=0.0)
        g = tl.load(prv + (pix - 1) * 3 + 1, mask=left, other=0.0)
        b = tl.load(prv + (pix - 1) * 3 + 2, mask=left, other=0.0)
        ll = 0.5 * (tl.maximum(tl.maximum(r, g), b)
                    + tl.minimum(tl.minimum(r, g), b))
        r = tl.load(prv + (pix - W) * 3, mask=up, other=0.0)
        g = tl.load(prv + (pix - W) * 3 + 1, mask=up, other=0.0)
        b = tl.load(prv + (pix - W) * 3 + 2, mask=up, other=0.0)
        lu = 0.5 * (tl.maximum(tl.maximum(r, g), b)
                    + tl.minimum(tl.minimum(r, g), b))
        ep = (tl.where(left, tl.abs(lp - ll), 0.0)
              + tl.where(up, tl.abs(lp - lu), 0.0))
        acc += (w_h * tl.abs(hc - hp) + w_s * tl.abs(sc - sp)
                + w_l * tl.abs(lc - lp) + w_e * tl.abs(ec - ep))
    # φ_0 is 0 by definition (the reference prepends it), whatever
    # rounding the compiler gives the two copies of frame 0's features
    tl.store(phi_ptr + t, tl.where(t > 0, tl.sum(acc, axis=0) / norm, 0.0))


def _jit():
    global tl, _JIT
    if _JIT is None:
        # keep Triton's compile cache inside the checkout
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(BUILD_DIR, "triton"))
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_scene_phi_kernel)
    return _JIT


def _launch(frames: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T,H,W,3), got "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    frames = frames.contiguous()
    t, h, w, _ = frames.shape
    wts = [float(x) for x in weights]
    # Σw·H·W in fp32, as the reference forms it
    norm = float(torch.tensor(wts, dtype=torch.float32).sum()
                 * torch.tensor(float(h * w), dtype=torch.float32))
    phi = torch.empty((t,), dtype=torch.float32, device=frames.device)
    kern = _jit()
    with torch.cuda.device(frames.device):
        kern[(t,)](frames, phi, h, w, *wts, norm, num_warps=8)
    scene_score.launches += 1
    return phi


def scene_score(frames: torch.Tensor, weights: Sequence[float]
                ) -> torch.Tensor:
    """frames (T,H,W,3) f32 in [0,1] → φ (T,) f32, φ[0] = 0. CUDA
    tensors run the Triton kernel, CPU tensors the plain version."""
    if frames.device.type == "cuda":
        return _launch(frames, weights)
    if frames.device.type == "cpu":
        return ref.scene_score_ref(frames, weights)
    raise ValueError(f"no scene-score route for device {frames.device}")


scene_score.launches = 0
