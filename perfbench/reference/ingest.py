"""Scene segmentation (Eq. 1) and incremental clustering, plain, in
float64 over the float32 frames.

φ of a frame is the weighted mean absolute change of its hue,
saturation, lightness and edge (the L1 gradient of lightness) against
the frame before; a stream's first frame has φ = 0. A partition opens
at frame 0 and closes where φ passes the threshold or it has reached
``max_partition_len`` frames. Within a closed partition, frames (pooled
``pool``² blocks) join the nearest running-mean centroid within the
threshold, else seed a new cluster, and past ``max_clusters`` join the
nearest; a cluster's index frame is its member nearest its centroid.
Members can tie for nearest (a cluster of two is always a tie), and
float32 then picks either: every member within ``TIE`` of the least
distance is an index frame the reference accepts."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

WEIGHTS = (1.0, 1.0, 1.0, 2.0)
TIE = 1e-4          # relative: squared distances this close are a tie


def hsle(frames: torch.Tensor) -> torch.Tensor:
    rgb = frames.to(torch.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    light = 0.5 * (mx + mn)
    sat = c / (1.0 - torch.abs(2.0 * light - 1.0) + 1e-6)
    safe = torch.where(c > 0, c, torch.ones_like(c))
    hue = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                      torch.where(mx == g, (b - r) / safe + 2.0,
                                  (r - g) / safe + 4.0)) / 6.0
    hue = torch.where(c > 0, hue, torch.zeros_like(hue))
    edge = torch.zeros_like(light)
    edge[..., :, 1:] += torch.abs(light[..., :, 1:] - light[..., :, :-1])
    edge[..., 1:, :] += torch.abs(light[..., 1:, :] - light[..., :-1, :])
    return torch.stack([hue, sat, light, edge], -1)


def scene_scores(frames: torch.Tensor, prev: torch.Tensor = None
                 ) -> torch.Tensor:
    """φ of each frame (T,) in f64; the first against ``prev``, or 0."""
    w = torch.tensor(WEIGHTS, dtype=torch.float64, device=frames.device)
    f = hsle(frames)
    before = (torch.cat([hsle(prev[None]), f[:-1]]) if prev is not None
              else torch.cat([f[:1], f[:-1]]))
    num = (torch.abs(f - before) * w).sum((1, 2, 3))
    return num / (w.sum() * frames.shape[1] * frames.shape[2])


def closed_partitions(phi: np.ndarray, *, threshold: float,
                      max_partition_len: int) -> List[Tuple[int, int]]:
    out, start, since = [], 0, 0
    for t, p in enumerate(phi):
        if t > 0 and (p > threshold or since >= max_partition_len):
            out.append((start, t))
            start, since = t, 1
        else:
            since += 1
    return out


def frame_vectors(frames: torch.Tensor, pool: int) -> np.ndarray:
    t, h, w, c = frames.shape
    ph, pw = h // pool, w // pool
    x = frames[:, :ph * pool, :pw * pool].to(torch.float64)
    x = x.reshape(t, ph, pool, pw, pool, c).mean(dim=(2, 4))
    return x.reshape(t, -1).cpu().numpy()


def cluster(vecs: np.ndarray, *, threshold: float, max_clusters: int
            ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """→ [(accepted index frames, members), ...] in cluster order, local
    ids."""
    t, d = vecs.shape
    sums = np.zeros((max_clusters, d))
    counts = np.zeros(max_clusters)
    n = 0
    assign = np.zeros(t, np.int64)
    for i, v in enumerate(vecs):
        if n:
            means = sums[:n] / np.maximum(counts[:n], 1.0)[:, None]
            dist = np.sqrt(((means - v) ** 2).sum(-1) + 1e-12)
            nearest = int(np.argmin(dist))
            near_ok = dist[nearest] <= threshold
        else:
            nearest, near_ok = 0, False
        new = n == 0 or (not near_ok and n < max_clusters)
        cid = n if new else nearest
        sums[cid] += v
        counts[cid] += 1
        n += int(new)
        assign[i] = cid
    cent = sums[:n] / np.maximum(counts[:n], 1.0)[:, None]
    out = []
    for c in range(n):
        mem = np.nonzero(assign == c)[0]
        d2 = ((vecs[mem] - cent[c]) ** 2).sum(-1)
        near = mem[d2 <= d2.min() * (1 + TIE)]
        out.append((tuple(int(m) for m in near), tuple(int(m) for m in mem)))
    return out


def stream_clusters(world, s: int, n_chunks: int, vc: dict
                    ) -> Tuple[List[Tuple[int, int]], List[list]]:
    """The closed partitions of stream ``s``'s first ``n_chunks`` chunks
    and each one's clusters with absolute frame ids."""
    phis, prev = [], None
    for c in range(n_chunks):
        ch = world.render(s, c)
        phis.append(scene_scores(ch, prev).cpu().numpy())
        prev = ch[-1]
    phi = np.concatenate(phis)
    phi[0] = 0.0
    parts = closed_partitions(phi, threshold=vc["scene_threshold"],
                              max_partition_len=vc["max_partition_len"])
    clusters = []
    for a, b in parts:
        frames = world.frames(s, np.arange(a, b))
        cl = cluster(frame_vectors(frames, vc["cluster_pool"]),
                     threshold=vc["cluster_threshold"],
                     max_clusters=vc["max_clusters_per_partition"])
        clusters.append([(tuple(a + i for i in near),
                          tuple(a + m for m in mem)) for near, mem in cl])
    return parts, clusters
