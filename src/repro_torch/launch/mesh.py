"""Device meshes for the sharded memory path.

A ``Mesh`` names a grid of devices: ``shape`` maps each axis name to its
size (``{"data": D, "model": K}``) and ``devices`` lists the D·K devices
in row-major order. The memory path shards over the ``model`` axis:
slab k of a sharded ``MemoryArena`` or ``DistributedVenusMemory`` lives
on ``devices[k]``.

A device may appear more than once: ``make_memory_mesh(4,
devices=["cuda:0"] * 4)`` gives four slabs on one card, and ``["cpu"] *
4`` four on the CPU — the same per-slab code a box with four cards runs.
Nothing here touches a card at import.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """A device grid: ``shape`` (axis name → size, in ``axis_names``
    order) and ``devices`` (row-major over the axes)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        n = 1
        for s in self.sizes:
            n *= s
        if len(self.axis_names) != len(self.sizes) or n != len(self.devices):
            raise ValueError(f"mesh {dict(zip(self.axis_names, self.sizes))}"
                             f" needs {n} devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def _devices(devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    """The devices given, or every visible CUDA device. With none visible
    this raises: the port never drops silently to the CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; pass devices= (e.g. "
                "devices=['cpu'] * 4) to build a mesh on the CPU")
        return tuple(torch.device("cuda", i) for i in range(n))
    out = tuple(torch.device(d) for d in devices)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def make_host_mesh(model: int = 1, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """A ``(data, model)`` mesh over the devices: ``model`` (at most the
    device count) on the model axis, the rest on the data axis."""
    devs = _devices(devices)
    model = max(1, min(int(model), len(devs)))
    data = len(devs) // model
    return Mesh(("data", "model"), (data, model), devs[:data * model])


def make_memory_mesh(shards: int = 0, devices: Optional[Sequence] = None
                     ) -> Mesh:
    """The mesh a sharded ``MemoryArena`` or ``DistributedVenusMemory``
    takes: ``shards`` devices on the ``model`` axis (the slot or row slab
    axis), data = 1; ``shards=0`` means every device given."""
    devs = _devices(devices)
    k = len(devs) if shards <= 0 else min(int(shards), len(devs))
    return make_host_mesh(model=k, devices=devs[:k])


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
