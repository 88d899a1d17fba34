"""Incremental frame clustering within a scene partition (paper §IV-B2).

The first frame seeds cluster c₀; each later frame joins the nearest
running-mean centroid if its L2 distance is within ``threshold``, else it
seeds a new cluster; past ``max_clusters`` it joins the nearest one
regardless. Each cluster's **index frame** is its member closest to the
final centroid. The reference's ``lax.scan`` is one launch of a
hand-written kernel a partition on the card (``kernels/cluster.py``) and
a loop of tensor ops on the CPU (``kernels/ref.py``): the same fp32
distance, the same first-minimum ``argmin`` ties and the same overflow
rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cluster as kcluster


def frame_vectors(frames: torch.Tensor, pool: int = 8) -> torch.Tensor:
    """(T,H,W,3) → (T, d) average-pooled, flattened pixel vectors."""
    t, h, w, c = frames.shape
    ph, pw = h // pool, w // pool
    x = frames[:, : ph * pool, : pw * pool].to(torch.float32)
    x = x.reshape(t, ph, pool, pw, pool, c).mean(dim=(2, 4))
    return x.reshape(t, -1)


class ClusterResult(NamedTuple):
    assignments: torch.Tensor      # (T,) int32 cluster id per frame
    n_clusters: torch.Tensor       # () int32
    centroids: torch.Tensor        # (K_max, d) running-mean centroids
    counts: torch.Tensor           # (K_max,) member counts
    index_frames: torch.Tensor     # (K_max,) member closest to centroid
    # (1 + T + K_max,) int32 [n_clusters, assignments, index_frames]: the
    # three integer fields above are views of it, read back in one copy
    packed: torch.Tensor


def cluster_partition(vecs: torch.Tensor, *, threshold: float,
                      max_clusters: int) -> ClusterResult:
    """vecs (T, d) frame vectors of one partition."""
    vecs = vecs.to(torch.float32)
    t = vecs.shape[0]
    packed, centroids, counts = kcluster.cluster_partition(vecs, threshold,
                                                           max_clusters)
    return ClusterResult(packed[1:1 + t], packed[0], centroids, counts,
                         packed[1 + t:], packed)
