"""Small shared helpers."""

from __future__ import annotations

import torch

# The reference compares in full fp32, and so do the port's parity checks:
# TF32 keeps about three decimal digits, enough to move a draw target
# across a CDF value or reorder near-tied top-k scores. Both switches
# are set (matmul and cuDNN) because they default differently.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two ≥ n, floored at ``lo`` (itself a power of
    two). Used to bucket dynamic batch sizes."""
    b = lo
    while b < n:
        b *= 2
    return b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another one explicitly. With no card and no explicit device this
    raises — the port never drops silently to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev
