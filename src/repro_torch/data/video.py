"""Procedural video world with ground-truth events (a copy of the
reference's numpy-only world, so both packages see identical frames).

Drives every accuracy-shaped experiment: the world emits a frame stream
partitioned into scenes; each scene carries a latent *event* (type id +
object labels + OCR-able text). Queries target event types; a retrieval
is *correct* when the selected frames cover the queried event's scenes
(coverage/recall — the measurable analogue of the paper's VQA accuracy,
since we cannot host LLaVA/Qwen checkpoints offline).

Scenes are visually coherent (static seeded background + a moving sprite
whose colour encodes the event) so Venus's scene segmentation and
clustering see realistic structure: high φ at scene cuts, low within.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_OBJECTS = ["person", "dog", "cat", "car", "cup", "pan", "pill", "book",
            "phone", "ball", "plant", "door", "kettle", "laptop", "broom",
            "remote"]


@dataclass(frozen=True)
class WorldConfig:
    n_scenes: int = 10
    scene_len_min: int = 30
    scene_len_max: int = 90
    resolution: int = 48
    n_event_types: int = 8
    event_repeat_prob: float = 0.35   # chance a scene reuses an event type
    noise: float = 0.01
    seed: int = 0


@dataclass
class Scene:
    scene_id: int
    start: int
    end: int                          # exclusive
    event: int
    objects: List[str]
    text: str
    # the event *moment*: the sprite (the visual evidence) is only
    # visible inside [w_start, w_end) — answering a query about the event
    # requires a frame from the window, not just any scene frame.
    w_start: int = 0
    w_end: int = 0


class VideoWorld:
    def __init__(self, cfg: WorldConfig = WorldConfig()):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.scenes: List[Scene] = []
        frames: List[np.ndarray] = []
        t = 0
        used_events: List[int] = []
        for s in range(cfg.n_scenes):
            if used_events and rng.random() < cfg.event_repeat_prob:
                ev = int(rng.choice(used_events))
            else:
                ev = int(rng.integers(cfg.n_event_types))
            used_events.append(ev)
            length = int(rng.integers(cfg.scene_len_min,
                                      cfg.scene_len_max + 1))
            objs = [_OBJECTS[ev % len(_OBJECTS)],
                    _OBJECTS[(ev * 3 + s) % len(_OBJECTS)]]
            text = f"event{ev}"
            # event window: ~30% of the scene, somewhere in the middle
            wlen = max(length // 3, 4)
            woff = int(rng.integers(2, max(length - wlen - 1, 3)))
            self.scenes.append(Scene(s, t, t + length, ev, objs, text,
                                     w_start=t + woff,
                                     w_end=t + woff + wlen))
            frames.append(self._render_scene(rng, s, ev, length,
                                             woff, woff + wlen))
            t += length
        self.frames = np.concatenate(frames, axis=0)      # (T,H,W,3) f32
        self.total_frames = t
        self.scene_of_frame = np.zeros((t,), np.int32)
        for sc in self.scenes:
            self.scene_of_frame[sc.start:sc.end] = sc.scene_id

    # ------------------------------------------------------------- rendering
    def _render_scene(self, rng, scene_id: int, event: int,
                      length: int, w0: int = 0, w1: int = 10**9
                      ) -> np.ndarray:
        r = self.cfg.resolution
        base_rng = np.random.default_rng(self.cfg.seed * 1000 + scene_id)
        # static background: smooth gradient + fixed texture
        gx = np.linspace(0, 1, r)[None, :, None]
        gy = np.linspace(0, 1, r)[:, None, None]
        base_color = base_rng.random((1, 1, 3)) * 0.5 + 0.2
        texture = base_rng.random((r, r, 3)) * 0.08
        bg = np.clip(base_color + 0.25 * gx + 0.15 * gy + texture, 0, 1)

        # sprite colour encodes the event type
        hue = (event / max(self.cfg.n_event_types, 1))
        sprite = np.array([hue, 1.0 - hue, 0.5 + 0.5 * hue])
        size = max(r // 8, 2)
        out = np.empty((length, r, r, 3), np.float32)
        lim = r - size
        cx = int(base_rng.integers(0, lim))
        cy = int(base_rng.integers(0, lim))
        vx, vy = (int(v) for v in base_rng.integers(1, 3, size=2))
        for i in range(length):
            f = bg.copy()
            if w0 <= i < w1:    # sprite visible only during the event
                # bouncing motion (no teleport ⇒ smooth within-scene φ)
                x = cx + vx * i
                y = cy + vy * i
                x = int(lim - abs(lim - (x % (2 * lim))))
                y = int(lim - abs(lim - (y % (2 * lim))))
                f[y:y + size, x:x + size] = sprite
            f += rng.normal(0, self.cfg.noise, f.shape)
            out[i] = np.clip(f, 0, 1)
        return out

    # ------------------------------------------------------------- metadata
    def annotations(self, frame_idx: int) -> Dict:
        sc = self.scenes[int(self.scene_of_frame[frame_idx])]
        vis = sc.w_start <= int(frame_idx) < sc.w_end
        return {"objects": sc.objects if vis else [],
                "text": sc.text if vis else "",
                "event": sc.event, "event_visible": vis}

    def frame_in_window(self, frame_idx: int) -> bool:
        sc = self.scenes[int(self.scene_of_frame[int(frame_idx)])]
        return sc.w_start <= int(frame_idx) < sc.w_end

    def scenes_with_event(self, event: int) -> List[Scene]:
        return [s for s in self.scenes if s.event == event]

    # --------------------------------------------------------------- queries
    def make_queries(self, n: int, seed: int = 1
                     ) -> List["Query"]:
        rng = np.random.default_rng(seed)
        events = sorted({s.event for s in self.scenes})
        out = []
        for i in range(n):
            ev = int(events[rng.integers(len(events))])
            scs = self.scenes_with_event(ev)
            out.append(Query(
                text=f"find event{ev} {_OBJECTS[ev % len(_OBJECTS)]}",
                event=ev,
                relevant_scenes=[s.scene_id for s in scs],
                dispersion=len(scs)))
        return out


@dataclass
class Query:
    text: str
    event: int
    relevant_scenes: List[int]
    dispersion: int               # number of scenes holding the answer


# ---------------------------------------------------------------------------
# Oracle embedder: a "perfect MEM" for isolating retrieval-algorithm
# quality (documented in DESIGN.md; the trained MEM path is exercised by
# examples/train_mem.py + the end-to-end integration test).
# ---------------------------------------------------------------------------


class OracleEmbedder:
    """Embeds frames/queries into an event+scene structured space.

    embedding(frame) = unit(event_basis[ev] + w·scene_basis[scene] + ε).
    embedding(query) = unit(event_basis[ev] + w·scene_basis[anchor] + ε/2)
    where ``anchor`` is one occurrence of the event — reproducing the
    paper's Fig. 5 structure: the query matches one occurrence's frames
    *most* strongly (temporal neighbourhood), other occurrences of the
    same event somewhat less, everything else weakly. Greedy Top-K then
    concentrates on the anchor scene; sampling spreads over all relevant
    scenes.
    """

    def __init__(self, world: VideoWorld, dim: int = 64,
                 noise: float = 0.08, scene_weight: float = 0.45,
                 seed: int = 7):
        self.world = world
        self.dim = dim
        self.noise = noise
        self.scene_weight = scene_weight
        rng = np.random.default_rng(seed)
        self._event_basis = self._unit_rows(rng.normal(
            0, 1, (world.cfg.n_event_types, dim)))
        self._scene_basis = self._unit_rows(rng.normal(
            0, 1, (world.cfg.n_scenes, dim)))
        self._rng = rng

    @staticmethod
    def _unit_rows(x):
        x = np.asarray(x, np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def embed_frames(self, frames, aux_texts=None,
                     frame_ids: Optional[Sequence[int]] = None
                     ) -> np.ndarray:
        """Pipeline-compatible: identifies frames by id (frame_ids if
        given, else ``frames`` is itself a sequence of ids)."""
        frame_idx = frame_ids if frame_ids is not None else frames
        frame_idx = np.asarray(frame_idx)
        anns = [self.world.annotations(int(i)) for i in frame_idx]
        evs = np.asarray([a["event"] for a in anns])
        vis = np.asarray([a.get("event_visible", True) for a in anns],
                         np.float32)[:, None]
        scs = self.world.scene_of_frame[frame_idx]
        # the MEM only "sees" the event while its evidence is on screen
        e = (self._event_basis[evs] * (0.2 + 0.8 * vis)
             + self.scene_weight * self._scene_basis[scs])
        e = e + self._rng.normal(0, self.noise, e.shape)
        return self._unit_rows(e)

    def embed_query(self, query: Query) -> np.ndarray:
        anchor = query.relevant_scenes[0]
        e = (self._event_basis[query.event]
             + self.scene_weight * self._scene_basis[anchor])
        e = e + self._rng.normal(0, self.noise * 0.5, e.shape)
        return self._unit_rows(e)

    def embed_queries(self, queries: Sequence[Query]) -> np.ndarray:
        return np.stack([self.embed_query(q) for q in queries])


class PixelEmbedder:
    """Deterministic content-only embedder: pooled pixels through a fixed
    seeded random projection, L2-normalised — on the device the frames
    are on.

    The projection is the reference's (numpy ``default_rng(seed)``), so
    both packages embed with the same matrix. Rows are projected one at
    a time: a batched product may change its summation order with the
    batch size, and each row's embedding must be a pure function of its
    frame, independent of who shares the batch.
    """

    def __init__(self, dim: int = 64, pool: int = 8, seed: int = 13):
        self.dim = dim
        self.pool = pool
        self.seed = seed
        self._proj = None

    def _projection(self, d_in: int, device):
        p = self._proj
        if p is None or p.shape[0] != d_in or p.device != device:
            rng = np.random.default_rng(self.seed)
            proj = rng.normal(0, 1.0 / np.sqrt(d_in),
                              (d_in, self.dim)).astype(np.float32)
            p = self._proj = torch.from_numpy(proj).to(device)
        return p

    def embed_frames(self, frames, aux_texts=None, frame_ids=None
                     ) -> np.ndarray:
        from repro_torch.core.clustering import frame_vectors
        x = torch.as_tensor(frames, dtype=torch.float32)
        v = frame_vectors(x, self.pool)
        proj = self._projection(v.shape[-1], v.device)
        e = torch.stack([row @ proj for row in v])
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        return e.cpu().numpy()

    def embed_query(self, text: str) -> np.ndarray:
        # crc32, not hash(): Python's str hash is salted per process
        rng = np.random.default_rng(
            (zlib.crc32(str(text).encode()) ^ self.seed) & 0x7FFFFFFF)
        e = rng.normal(0, 1, (self.dim,)).astype(np.float32)
        return e / np.linalg.norm(e)

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.embed_query(t) for t in texts])
