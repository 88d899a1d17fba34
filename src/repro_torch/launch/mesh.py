"""Device meshes: the memory path's, the rule tables' and the trainer's.

A ``Mesh`` names a grid of devices: ``shape`` maps each axis name to its
size (``{"data": D, "model": K}``) and ``devices`` lists the D·K devices
in row-major order. The memory path shards over the ``model`` axis:
slab k of a sharded ``MemoryArena`` or ``DistributedVenusMemory`` lives
on ``devices[k]``.

An abstract mesh (``make_abstract_mesh``, ``make_production_mesh``) has
axes and sizes and no devices: the rule tables of ``launch.sharding``
and the dry run read it; whatever places a tensor raises on it. A
process group runs over a ``torch.distributed`` ``DeviceMesh`` of the
same axes (``to_device_mesh``).

A device may appear more than once: ``make_memory_mesh(4,
devices=["cuda:0"] * 4)`` gives four slabs on one card, and ``["cpu"] *
4`` four on the CPU — the same per-slab code a box with four cards runs.
Nothing here touches a card at import.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """A device grid: ``shape`` (axis name → size, in ``axis_names``
    order) and ``devices`` (row-major over the axes), None for an
    abstract mesh."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names}, sizes {self.sizes}")
        if self.devices is not None and self.size != len(self.devices):
            raise ValueError(f"mesh {self.shape} needs {self.size} devices,"
                             f" got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def device_list(self) -> Tuple[torch.device, ...]:
        """The devices, row-major; an abstract mesh places nothing and
        raises."""
        if self.devices is None:
            raise ValueError(f"the abstract mesh {self.shape} has no "
                             f"devices to place a tensor on")
        return self.devices


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


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A device-free mesh for the rule tables and the dry run."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape), None)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract: (data 16, model 16),
    or (pod 2, data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_abstract_mesh((16, 16), ("data", "model"))


def init_ranks(device=None) -> Tuple[torch.device, str]:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, the rendezvous
    address) → (this rank's device, the backend). On the cards (``device``
    None or a CUDA device): where there is a card for every local rank,
    rank r runs on ``cuda:<local rank>`` over NCCL; with fewer cards the
    ranks share them (``cuda:<local rank % cards>``) over gloo, which
    takes CUDA tensors through the host (NCCL refuses two ranks on one
    card). ``device="cpu"``: the CPU over gloo. Prints the choice on rank
    0: nothing is chosen silently."""
    import os

    import torch.distributed as dist
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", local % n)
        backend = "nccl" if n >= local_world else "gloo"
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if rank == 0:
        print(f"[ranks] world {world}, backend "
              f"{dist.get_backend()}, rank 0 on {dev}"
              + ("" if dev.type == "cpu" else
                 f" ({torch.cuda.device_count()} card(s) for "
                 f"{local_world} local ranks)"), flush=True)
    return dev, dist.get_backend()


def to_device_mesh(mesh: Mesh, device_type: str):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh``'s axes and
    sizes over the ranks of the initialised process group, which must
    hold exactly ``mesh.size`` ranks: row-major, so a ``(data, model)``
    mesh puts ranks ``[d·K, (d+1)·K)`` on model group d."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("to_device_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def abstract_of(device_mesh) -> Mesh:
    """The abstract ``Mesh`` of a ``DeviceMesh``'s axes and sizes: what
    the rule tables read."""
    return make_abstract_mesh(tuple(device_mesh.shape),
                              tuple(device_mesh.mesh_dim_names))


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes (``pod``, ``data``), in order; the
    axis names of a ``Mesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(a for a in names if a in ("pod", "data"))


def _card() -> Tuple[Optional[str], Optional[float]]:
    """(name, power limit in W) of the first card by ``nvidia-smi``, or
    (None, None) where none answers. Runs no CUDA call."""
    if shutil.which("nvidia-smi") is None:
        return None, None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        name, limit = (f.strip() for f in out[0].split(","))
        return name, float(limit.split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None, None


# One NVIDIA H100 SXM5 80GB: the peaks of its data sheet (dense, no
# sparsity). ``name`` and ``power_limit_w`` are the card's own, read by
# ``hardware()`` where one is visible: a card set below 700 W runs
# slower under load.
HARDWARE = {
    "name": None,
    "power_limit_w": None,
    "peak_bf16_flops": 989e12,        # FLOP/s, tensor cores
    "peak_f32_flops": 67e12,          # FLOP/s, CUDA cores
    "hbm_bw": 3.35e12,                # bytes/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 900e9,               # bytes/s a card, both directions
}


def hardware() -> Dict[str, object]:
    """``HARDWARE`` with the visible card's name and power limit (None
    for both where ``nvidia-smi`` finds no card)."""
    name, limit = _card()
    return {**HARDWARE, "name": name, "power_limit_w": limit}
