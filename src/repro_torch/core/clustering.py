"""Incremental frame clustering within a scene partition (paper §IV-B2).

The first frame seeds cluster c₀; each later frame joins the nearest
running-mean centroid if its L2 distance is within ``threshold``, else it
seeds a new cluster; past ``max_clusters`` it joins the nearest one
regardless. The reference's ``lax.scan`` is a loop of tensor ops here,
on the device the vectors live on, with no host synchronisation per
frame: the same fp32 distance, the same first-minimum ``argmin`` ties and
the same overflow rule. Each cluster's **index frame** is its member
closest to the final centroid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


def cluster_partition(vecs: torch.Tensor, *, threshold: float,
                      max_clusters: int) -> ClusterResult:
    """vecs (T, d) frame vectors of one partition."""
    vecs = vecs.to(torch.float32)
    t, d = vecs.shape
    kmax = int(max_clusters)
    dev = vecs.device
    sums = torch.zeros((kmax, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((kmax,), dtype=torch.float32, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.arange(kmax, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    assignments = torch.zeros((t,), dtype=torch.int64, device=dev)
    for i in range(t):
        v = vecs[i]
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        dist = torch.sqrt(((means - v[None]) ** 2).sum(-1) + 1e-12)
        dist = torch.where(lanes < n, dist, inf)
        nearest = torch.argmin(dist)                # first minimum
        near_ok = dist[nearest] <= threshold
        make_new = (~near_ok & (n < kmax)) | (n == 0)
        cid = torch.where(make_new, n, nearest)
        sums.index_add_(0, cid[None], v[None])
        counts.index_add_(0, cid[None], torch.ones(1, device=dev))
        n = n + make_new.to(torch.int64)
        assignments[i] = cid
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    d2 = ((vecs[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)  # (T,K)
    member = assignments[:, None] == lanes[None, :]
    d2 = torch.where(member, d2, inf)
    index_frames = torch.argmin(d2, dim=0).to(torch.int32)
    return ClusterResult(assignments.to(torch.int32), n.to(torch.int32),
                         centroids, counts, index_frames)
