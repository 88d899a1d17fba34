"""Camera streams, rendered on the device from the seed.

The pattern is the port's procedural world (``data/video.py``): each
stream is a run of scenes of ``scene_len`` frames; a scene has a static
background (a colour, a gradient and a fixed texture) and, inside its
event window (about a third of the scene), a bouncing sprite whose
colour encodes the scene's event; every frame gets Gaussian noise.

What sets the work (each scene's length, event, event window, colour,
texture and sprite path) is drawn from the traffic's ``mix_seed``, one
timeline a camera; the run's seed deals these timelines to the cameras
in another order and draws the noise. So every seed offers the same
scenes. The numbers
are drawn on the host (a few a scene) and the pixels made on the
device, one chunk of ``chunk`` frames at a time, with a generator seeded
by (seed, camera, chunk) for the noise, so any chunk of any camera can
be made again, alone, by the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

OBJECTS = ["person", "dog", "cat", "car", "cup", "pan", "pill", "book",
           "phone", "ball", "plant", "door", "kettle", "laptop", "broom",
           "remote"]


def derive_seed(*parts) -> int:
    """A 63-bit seed from any parts (stable across processes)."""
    h = hashlib.blake2b("/".join(str(p) for p in parts).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") >> 1


@dataclass
class _Timeline:
    starts: List[int] = field(default_factory=list)
    lengths: List[int] = field(default_factory=list)
    events: List[int] = field(default_factory=list)
    windows: List[tuple] = field(default_factory=list)    # (w0, w1) in scene
    colours: List[np.ndarray] = field(default_factory=list)
    sprites: List[tuple] = field(default_factory=list)    # cx, cy, vx, vy
    end: int = 0


class CameraWorld:
    """``streams`` cameras of ``resolution``² RGB frames in [0, 1]."""

    def __init__(self, *, seed: int, mix_seed: int, streams: int,
                 resolution: int, chunk: int, scene_len=(30, 90),
                 n_event_types: int = 8, event_repeat_prob: float = 0.35,
                 noise: float = 0.01, device="cuda"):
        self.seed = int(seed)
        self.mix_seed = int(mix_seed)
        self.deal = np.random.default_rng(
            derive_seed("world-deal", seed)).permutation(streams)
        self.streams = int(streams)
        self.r = int(resolution)
        self.chunk = int(chunk)
        self.scene_len = (int(scene_len[0]), int(scene_len[1]))
        self.n_event_types = int(n_event_types)
        self.event_repeat_prob = float(event_repeat_prob)
        self.noise = float(noise)
        self.device = torch.device(device)
        self._tl: Dict[int, _Timeline] = {}
        self._rng: Dict[int, tuple] = {}
        r = self.r
        g = torch.linspace(0, 1, r, device=self.device)
        self._grad = 0.25 * g[None, :, None] + 0.15 * g[:, None, None]

    @classmethod
    def from_traffic(cls, traffic: dict, seed: int, device) -> "CameraWorld":
        """The world of a traffic file's ``cameras`` and ``mix_seed``."""
        c = traffic["cameras"]
        return cls(seed=seed, mix_seed=traffic["mix_seed"],
                   streams=c["streams"], resolution=c["resolution"],
                   chunk=c["chunk_frames"], scene_len=c["scene_len"],
                   n_event_types=c["n_event_types"],
                   event_repeat_prob=c["event_repeat_prob"],
                   noise=c["noise"], device=device)

    # ------------------------------------------------------------ scenes
    def _timeline(self, s: int, upto: int) -> _Timeline:
        tl = self._tl.get(s)
        if tl is None:
            tl = self._tl[s] = _Timeline()
            self._rng[s] = np.random.default_rng(derive_seed(
                "world-shape", self.mix_seed, int(self.deal[s])))
        shape = self._rng[s]
        lim = self.r - max(self.r // 8, 2)
        while tl.end < upto:
            if tl.events and shape.random() < self.event_repeat_prob:
                ev = int(shape.choice(tl.events))
            else:
                ev = int(shape.integers(self.n_event_types))
            n = int(shape.integers(self.scene_len[0], self.scene_len[1] + 1))
            wlen = max(n // 3, 4)
            woff = int(shape.integers(2, max(n - wlen - 1, 3)))
            vx, vy = (int(v) for v in shape.integers(1, 3, size=2))
            tl.starts.append(tl.end)
            tl.lengths.append(n)
            tl.events.append(ev)
            tl.windows.append((woff, woff + wlen))
            tl.colours.append(shape.random(3) * 0.5 + 0.2)
            cx, cy = (int(v) for v in shape.integers(0, lim, size=2))
            tl.sprites.append((cx, cy, vx, vy))
            tl.end += n
        return tl

    def events_seen(self, s: int, upto: int) -> List[int]:
        """The events of the scenes that start before frame ``upto``."""
        tl = self._timeline(s, upto)
        return [e for st, e in zip(tl.starts, tl.events) if st < upto]

    # ------------------------------------------------------------ pixels
    def _background(self, s: int, k: int) -> torch.Tensor:
        tl = self._tl[s]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed("texture", self.mix_seed,
                                    int(self.deal[s]), k))
        tex = torch.rand((self.r, self.r, 3), generator=gen,
                         device=self.device) * 0.08
        col = torch.as_tensor(tl.colours[k], dtype=torch.float32,
                              device=self.device)
        return torch.clamp(col + self._grad + tex, 0, 1)

    def render(self, s: int, index: int) -> torch.Tensor:
        """Chunk ``index`` of stream ``s``: frames [index·chunk,
        (index+1)·chunk) as (chunk, r, r, 3) f32 on the device."""
        n, r = self.chunk, self.r
        lo = index * n
        tl = self._timeline(s, lo + n)
        first = int(np.searchsorted(tl.starts, lo, side="right") - 1)
        last = int(np.searchsorted(tl.starts, lo + n - 1, side="right") - 1)
        size = max(r // 8, 2)
        lim = r - size
        scene = np.empty(n, np.int64)
        xs = np.zeros(n, np.int64)
        ys = np.zeros(n, np.int64)
        vis = np.zeros(n, bool)
        hue = np.zeros(n, np.float32)
        for k in range(first, last + 1):
            a = max(tl.starts[k], lo) - lo
            b = min(tl.starts[k] + tl.lengths[k], lo + n) - lo
            i = np.arange(a, b) + lo - tl.starts[k]     # frame in scene
            cx, cy, vx, vy = tl.sprites[k]
            x, y = cx + vx * i, cy + vy * i
            xs[a:b] = lim - np.abs(lim - (x % (2 * lim)))
            ys[a:b] = lim - np.abs(lim - (y % (2 * lim)))
            w0, w1 = tl.windows[k]
            vis[a:b] = (i >= w0) & (i < w1)
            hue[a:b] = tl.events[k] / max(self.n_event_types, 1)
            scene[a:b] = k - first
        dev = self.device
        bgs = torch.stack([self._background(s, k)
                           for k in range(first, last + 1)])
        frames = bgs[torch.from_numpy(scene).to(dev)]
        pix = torch.arange(r, device=dev)
        x0 = torch.from_numpy(xs).to(dev)[:, None]
        y0 = torch.from_numpy(ys).to(dev)[:, None]
        inside = (((pix[None] >= y0) & (pix[None] < y0 + size))[:, :, None]
                  & ((pix[None] >= x0) & (pix[None] < x0 + size))[:, None, :]
                  & torch.from_numpy(vis).to(dev)[:, None, None])
        h = torch.from_numpy(hue).to(dev)
        sprite = torch.stack([h, 1.0 - h, 0.5 + 0.5 * h], -1)[:, None, None]
        frames = torch.where(inside[..., None], sprite, frames)
        gen = torch.Generator(device=dev)
        gen.manual_seed(derive_seed("noise", self.seed, s, index))
        frames = frames + torch.randn(frames.shape, generator=gen,
                                      device=dev) * self.noise
        return torch.clamp(frames, 0, 1)

    def tick(self, index: int, streams=None) -> Dict[int, np.ndarray]:
        """Chunk ``index`` of every stream (or of ``streams``) as host
        arrays: one device-to-host copy of the stacked chunks."""
        sids = list(range(self.streams) if streams is None else streams)
        stacked = torch.stack([self.render(s, index) for s in sids])
        host = stacked.cpu().numpy()
        return {s: host[j] for j, s in enumerate(sids)}

    def frames(self, s: int, ids) -> torch.Tensor:
        """Frames ``ids`` of stream ``s`` (any order) on the device, each
        chunk rendered once."""
        ids = np.asarray(ids, np.int64)
        out = torch.empty((len(ids), self.r, self.r, 3), device=self.device)
        for c in np.unique(ids // self.chunk):
            sel = np.nonzero(ids // self.chunk == c)[0]
            ch = self.render(s, int(c))
            out[torch.from_numpy(sel).to(self.device)] = ch[
                torch.from_numpy(ids[sel] - c * self.chunk).to(self.device)]
        return out


class TickProducer:
    """Makes tick after tick of ``world`` from ``first`` on, one ahead of
    the consumer, in a thread of its own and (on a card) on a stream of
    its own, so the window's ticks do not wait for the frames unless the
    program outruns the generator (``get``'s wait says by how much)."""

    def __init__(self, world: CameraWorld, first: int):
        import queue
        import threading
        self.world = world
        self._q = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self.stream = (torch.cuda.Stream(world.device)
                        if world.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._work, args=(first,),
                                        daemon=True)
        self._thread.start()

    def _work(self, i: int) -> None:
        import contextlib
        import queue
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                while not self._stop.is_set():
                    item = self.world.tick(i)
                    i += 1
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except Exception as e:         # handed to the consumer, raised there
            self._q.put(e)

    def get(self) -> Dict[int, np.ndarray]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        import queue
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()
