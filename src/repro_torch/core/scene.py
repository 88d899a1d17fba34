"""Scene detection & segmentation (paper §IV-B1, Eq. 1).

The stream is cut where the frame-difference score φ exceeds a threshold,
or where a partition reaches ``max_partition_len`` frames (static
cameras). ``scene_scores`` computes φ (the CUDA kernel on the card, the
plain version on the CPU); ``segment`` makes the boundary decisions;
``StreamSegmenter`` is the online wrapper that carries the last frame
and the frames-since-boundary counter across chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops

DEFAULT_WEIGHTS = (1.0, 1.0, 1.0, 2.0)       # (hue, sat, light, edge)


def scene_scores(frames: torch.Tensor,
                 weights: Tuple[float, float, float, float] = DEFAULT_WEIGHTS,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames (T,H,W,3) float in [0,1] → φ (T,); φ[0] = 0, or with
    ``prev`` (H,W,3) the score of frames[0] against it."""
    return kops.scene_score(frames, weights, prev)


def segment(phi, *, threshold: float, max_partition_len: int,
            carry_in: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Boundary decision per frame → (boundary (T,) bool — frame i starts
    a partition; part_id (T,) int32 within this call; carry_out — frames
    since the last boundary after the final frame)."""
    phi = np.asarray(torch.as_tensor(phi).cpu(), np.float32)
    since = 0 if carry_in is None else int(carry_in)
    carry0 = since
    boundary = np.zeros(phi.shape, bool)
    for i, p in enumerate(phi):
        new = bool(p > threshold) or since >= max_partition_len
        since = 1 if new else since + 1
        boundary[i] = new
    if len(phi):
        boundary[0] |= carry0 == 0       # frame 0 with no carry starts one
    part_id = np.maximum(np.cumsum(boundary.astype(np.int32)) - 1, 0)
    return boundary, part_id.astype(np.int32), since


@dataclass
class Partition:
    """A closed scene partition: [start, end) absolute frame indices."""
    start: int
    end: int


@dataclass
class StreamSegmenter:
    threshold: float = 0.08
    max_partition_len: int = 256
    weights: Tuple[float, float, float, float] = DEFAULT_WEIGHTS

    _since: int = 0
    _open_start: int = 0
    _abs: int = 0
    _started: bool = False
    _last_frame: Optional[torch.Tensor] = None

    def ingest(self, frames: torch.Tensor) -> List[Partition]:
        """Consume a chunk (T,H,W,3); return the partitions it closed.
        The previous chunk's last frame is scored against as ``prev``, so
        φ across the chunk boundary is the same as in one long chunk."""
        phi = scene_scores(frames, self.weights,
                           self._last_frame).cpu().numpy()
        self._last_frame = frames[-1]
        closed: List[Partition] = []
        for i, p in enumerate(phi):
            t = self._abs + i
            if self._started and (p > self.threshold
                                  or self._since >= self.max_partition_len):
                closed.append(Partition(self._open_start, t))
                self._open_start = t
                self._since = 1
            else:
                self._since += 1
            self._started = True
        self._abs += len(phi)
        return closed

    def flush(self) -> List[Partition]:
        if self._started and self._abs > self._open_start:
            part = [Partition(self._open_start, self._abs)]
            self._open_start = self._abs
            return part
        return []
