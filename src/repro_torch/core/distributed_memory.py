"""Distributed Venus memory: one flat index sharded over a mesh.

A site with many cameras pools its indexed vectors into one memory,
sharded over the mesh's ``model`` axis: K slabs of ``capacity / K`` rows,
slab k on mesh device k (``launch.sharding``). Retrieval:

  1. every shard scans its slab with the 2-D dense scan (kernel #4,
     ``ops.similarity``, Eq. 4), on its own device;
  2. each shard keeps its local top-M candidates (M = ``top_m``, so no
     recall loss for any budget ≤ M);
  3. the K·M (score, global id) pairs come to the first device —
     K·M·8 bytes, whatever the index size;
  4. the temperature softmax (Eq. 5) runs over the gathered candidates.

The probabilities of the true global top-(≤ M) rows equal the dense
softmax's restricted to them. An empty (or all-invalid) index gives ZERO
mass: invalid candidates carry ``probs == 0``, so no sampler can draw a
garbage id (a plain softmax over all-masked logits would be uniform).

Inserts are batched: a block of rows is round-robined over the shards
(insert order s → row ``(s % K)·per + s // K``) with one in-place write
per shard and buffer, so an insert moves O(rows) bytes, never the whole
``(capacity, d)`` buffer (``io_stats["scatter_bytes"]``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import topk_lowest_lane
from repro_torch.launch.sharding import mesh_axis_size, slab_devices


class DistributedVenusMemory:
    """Mesh-resident index: batched host inserts, per-shard retrieval."""

    def __init__(self, capacity: int, dim: int, mesh, *,
                 mesh_axis: str = "model", top_m: int = 64):
        k = mesh_axis_size(mesh, mesh_axis)
        if capacity % k:
            raise ValueError(f"capacity {capacity} does not split into "
                             f"{k} shards")
        self.capacity, self.dim = capacity, dim
        self.mesh, self.mesh_axis, self.top_m = mesh, mesh_axis, top_m
        self.devices = slab_devices(mesh, mesh_axis)
        per = capacity // k
        self._emb = [torch.zeros((per, dim), dtype=torch.float32, device=d)
                     for d in self.devices]
        self._valid = [torch.zeros((per,), dtype=torch.bool, device=d)
                       for d in self.devices]
        self._size = 0
        self.io_stats = {"inserts": 0, "scatter_rows": 0,
                         "scatter_bytes": 0, "searches": 0}

    @property
    def size(self) -> int:
        return self._size

    @property
    def _shards(self) -> int:
        return len(self.devices)

    def insert(self, embeddings) -> None:
        """Append a batch of vectors, round-robined over the shards: one
        write per shard and buffer (rows, validity)."""
        rows = np.asarray(embeddings, np.float32)
        n = rows.shape[0]
        if self._size + n > self.capacity:
            raise RuntimeError("distributed memory capacity exhausted")
        k = self._shards
        s = self._size + np.arange(n)              # insert orders
        shard, local = s % k, s // k
        for j, dev in enumerate(self.devices):
            sel = np.nonzero(shard == j)[0]
            if len(sel):
                pos = torch.from_numpy(local[sel]).to(dev)
                self._emb[j][pos] = torch.from_numpy(rows[sel]).to(dev)
                self._valid[j][pos] = True
        self._size += n
        self.io_stats["inserts"] += 1
        self.io_stats["scatter_rows"] += n
        # rows (n·d f32) + validity (n bool) + positions (n int32)
        self.io_stats["scatter_bytes"] += n * (self.dim * 4 + 1 + 4)

    def insert_orders(self, gids: torch.Tensor) -> torch.Tensor:
        """Global row ids → insert orders, on the ids' device."""
        per = self.capacity // self._shards
        return (gids % per) * self._shards + gids // per

    def global_id_to_insert_order(self, gid: int) -> int:
        return int(self.insert_orders(torch.tensor(int(gid))))

    def search(self, query_emb, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_emb (d,) → (candidate insert orders (K·M,), probs
        (K·M,)) on the first device: Eq. 4 + 5 over the gathered
        candidates, with the softmax MASKED — a non-finite candidate
        score (an invalid row) adds nothing to the numerator or the
        normaliser, so an empty index returns all-zero probabilities."""
        self.io_stats["searches"] += 1
        q = torch.as_tensor(np.asarray(query_emb, np.float32)).reshape(1, -1)
        home = self.devices[0]
        per = self.capacity // self._shards
        m = min(self.top_m, per)
        scores, gids = [], []
        for j, (x, v) in enumerate(zip(self._emb, self._valid)):
            sims, _ = kops.similarity(q.to(x.device), x, tau=1.0, valid=v)
            s = torch.where(v, sims[0], -torch.inf)
            # lax.top_k's order: descending, ties to the lowest lane
            top_s, top_i = topk_lowest_lane(s, m)
            scores.append(top_s.to(home))
            gids.append((top_i.to(torch.int64) + j * per).to(home))
        scores, gids = torch.cat(scores), torch.cat(gids)
        finite = torch.isfinite(scores)
        logits = torch.where(finite, scores / tau, -1e30)
        e = torch.where(finite, torch.exp(logits - logits.max()), 0.0)
        z = e.sum()
        probs = torch.where(z > 0, e / torch.clamp(z, min=1e-30), 0.0)
        return self.insert_orders(gids), probs
