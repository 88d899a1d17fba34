"""Sharding of the memory path: the slot (or row) axis of a memory buffer
in K contiguous slabs over a mesh axis.

A ``(S, …)`` buffer sharded over an axis of size K is K tensors: slab k
holds rows ``[k·S/K, (k+1)·S/K)`` on ``slab_devices(mesh)[k]``, every
trailing dim whole. The arena keeps its super-buffers so, and the sharded
scans of ``kernels.ops`` launch once per slab on the slab's device.
"""

from __future__ import annotations

from typing import List

import torch

MODEL = "model"


def mesh_axis_size(mesh, axis: str = MODEL) -> int:
    """Shard count of ``axis`` on ``mesh`` (1 when mesh is None or the
    axis is absent): the K every sharded memory path branches on."""
    if mesh is None:
        return 1
    return dict(mesh.shape).get(axis, 1)


def slab_devices(mesh, axis: str = MODEL) -> List[torch.device]:
    """The device of each of the K slabs along ``axis``: the first K
    devices of the mesh's first row (the model axis is the last)."""
    k = mesh_axis_size(mesh, axis)
    if axis != mesh.axis_names[-1] and k > 1:
        raise ValueError(f"memory slabs run along the mesh's last axis, "
                         f"not {axis!r}")
    return list(mesh.devices[:k])
