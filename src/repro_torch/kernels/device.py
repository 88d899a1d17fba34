"""Host-side helpers the CUDA wrappers share: the SM count of a card, a
launch on a device's current stream without a needless device switch, and
a bool mask viewed as the uint8 bytes the kernels read.

Nothing here touches a card at import; every function is called with a
CUDA tensor's device.
"""

from __future__ import annotations

import torch

_SMS = {}


def sm_count(dev: torch.device) -> int:
    """The streaming multiprocessors of ``dev`` (read once)."""
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def on_device(dev: torch.device, launch):
    """Run ``launch(stream)`` on ``dev``'s current stream, switching the
    device context only when ``dev`` is not the current device."""
    if dev.index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return launch(torch._C._cuda_getCurrentRawStream(dev.index))


def bool_bytes(valid: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``valid`` as uint8 bytes on ``dev``: a view, without a copy, of a
    contiguous bool tensor already there; else one conversion."""
    if (valid.dtype != torch.bool or valid.device != dev
            or not valid.is_contiguous()):
        valid = valid.to(dev, torch.bool).contiguous()
    return valid.view(torch.uint8)
