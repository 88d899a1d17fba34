"""Hierarchical memory (paper §IV-C): an index layer over a raw data
layer, with a coarse summary tier.

* ``FrameStore`` — the raw data layer: every captured frame by absolute
  id, on the host, and with a spill directory on disk below the host
  tier (trimming then demotes; reads fault back).
* ``VenusMemory`` — one session's index rows (cluster centroid
  embeddings) with bounded member reservoirs. Host mirrors in numpy are
  authoritative; the device copy lives in a ``MemoryArena`` slot (or, for
  a detached memory, is uploaded at first use and appended in place).
* ``MemoryArena`` — the device-resident ``(S, capacity, ·)`` super-buffers
  every session's rows live in. A tick's appends land with one in-place
  ``index_put_`` per super-buffer, so the buffers ARE the fused scan's
  operand and no ingest↔query interleaving ever restacks anything. Given
  a mesh, each buffer is K slabs of contiguous slots, one a device; with
  ``double_buffer`` a tick is written into a back set, then swapped in.
* ``MemoryStack`` / ``ArenaStackView`` — the stacked scan views: the
  fused retrieval launch and the dense ``search``.

Validity is a ``(head, size)`` ring window per session; the scans take
``(S, 2)`` windows and derive masks on the device. Eviction ``none``
raises on overflow; ``sliding_window`` advances the head (O(1));
``cluster_merge`` first folds each evictee's reservoir into its most
similar survivor; ``consolidate`` folds it into the coarse tier
(``coarse_capacity > 0``): block summaries of the fine rows plus
consolidated rows of evicted history, which ``tiering``'s two-stage
retrieval scans first.
"""

from __future__ import annotations

import bisect
import contextlib
import os
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import as_valid_mask
from repro_torch.launch.sharding import mesh_axis_size, slab_devices
from repro_torch.util import resolve_device


class FrameStore:
    """Raw data layer: a host archive of frames by absolute id, with an
    optional disk tier.

    ``trim(keep_from)`` drops every host frame below an absolute id; ids
    stay stable (``base`` offsets the retained list). Without a
    ``spill_dir`` trimming deletes, and reading a trimmed id raises
    ``IndexError``. With one, trimming DEMOTES: the dropped frames go to
    append-only ``seg-<start:012d>-<count:05d>.npy`` files of at most
    ``segment_frames`` frames, tiling ``[0, base)``, and ``get`` faults
    them back bit for bit through an LRU cache of ``cache_segments`` whole
    segments. The names and the npy layout are the reference's, so either
    package reopens the other's directory. Segments are written at once
    and made durable by ``sync()`` (the session manager calls it at the
    tick boundary). ``io_stats`` counts demotions (``spilled_frames``,
    ``spilled_bytes``) and reads (``spill_faults``: segment loads;
    ``spill_cache_hits``). ``close()`` releases both tiers."""

    def __init__(self, spill_dir: Optional[str] = None, *,
                 segment_frames: int = 64, cache_segments: int = 4):
        if segment_frames < 1 or cache_segments < 1:
            raise ValueError(f"segment_frames and cache_segments must be "
                             f">= 1, got {segment_frames}, {cache_segments}")
        self._frames: List[np.ndarray] = []
        self._base = 0            # absolute id of _frames[0]
        self.trimmed = 0          # frames dropped from the host so far
        self.spill_dir = spill_dir
        self.segment_frames = int(segment_frames)
        self.cache_segments = int(cache_segments)
        # (start, count, path, nbytes) per segment, tiling [0, _base)
        self._segments: List[Tuple[int, int, str, int]] = []
        self._seg_starts: List[int] = []       # bisect key of _segments
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._unsynced: List[str] = []         # written, not yet fsync'd
        self._disk_bytes = 0
        self.io_stats = {"spilled_frames": 0, "spilled_bytes": 0,
                         "spill_faults": 0, "spill_cache_hits": 0}
        self.recovered_frames = 0     # adopted from disk at open
        self.dropped_segments = 0     # rejected: short, corrupt or gapped
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            self._recover_segments()

    def _recover_segments(self) -> None:
        """Adopt the segments a previous process left: the longest run of
        ``seg-<start>-<count>.npy`` files, in start order, that tiles
        ``[0, base)`` and whose payload loads as a ``(count, ...)`` array
        (a torn header or a short data section fails to load). A rejected
        segment, and every one after it, is deleted; files that are not
        segments are left alone. The host tier restarts empty at
        ``base``, the frames adopted."""
        try:
            names = sorted(os.listdir(self.spill_dir))
        except OSError:
            return
        parsed = []
        for name in names:
            parts = name.split("-")
            if (name.endswith(".npy") and len(parts) == 3
                    and parts[0] == "seg" and parts[1].isdigit()
                    and parts[2][:-4].isdigit()):
                parsed.append((int(parts[1]), int(parts[2][:-4]), name))
        parsed.sort()
        base = 0
        rejects = []
        for start, count, name in parsed:
            path = os.path.join(self.spill_dir, name)
            ok = start == base and count >= 1
            if ok:
                try:
                    # mmap checks the header and the payload's length
                    # without reading the frames
                    seg = np.load(path, mmap_mode="r", allow_pickle=False)
                    ok = seg.shape[0] == count
                    nbytes = seg.size * seg.dtype.itemsize
                    del seg
                except (OSError, ValueError, EOFError):
                    ok = False
            if not ok:
                rejects.append(name)
                continue
            self._segments.append((start, count, path, nbytes))
            self._seg_starts.append(start)
            self._disk_bytes += nbytes
            base = start + count
        self._base = self.trimmed = self.recovered_frames = base
        for name in rejects:
            self.dropped_segments += 1
            with contextlib.suppress(OSError):
                os.remove(os.path.join(self.spill_dir, name))

    def append(self, frames: np.ndarray) -> None:
        self._frames.extend(np.asarray(frames))

    def __len__(self) -> int:
        """Frames ever archived (the absolute id space, trimmed ones
        included)."""
        return self._base + len(self._frames)

    @property
    def base(self) -> int:
        """Smallest absolute id still on the host (with spill, ids below
        it are on disk)."""
        return self._base

    @property
    def retained(self) -> int:
        """Frames held on the host."""
        return len(self._frames)

    @property
    def spill_enabled(self) -> bool:
        return self.spill_dir is not None

    @property
    def spill_floor(self) -> int:
        """Smallest id ``get`` serves: 0 with spill, else ``base``."""
        return 0 if self.spill_enabled else self._base

    @property
    def disk_bytes(self) -> int:
        """Bytes in segment files now (0 after ``close``)."""
        return self._disk_bytes

    def reset_io_stats(self) -> None:
        for k in self.io_stats:
            self.io_stats[k] = 0

    def get(self, idx: Sequence[int]) -> np.ndarray:
        out = []
        for i in idx:
            i = int(i)
            if i >= self._base:
                out.append(self._frames[i - self._base])
            elif self.spill_enabled and i >= 0:
                out.append(self._fault(i))
            else:
                raise IndexError(
                    f"frame {i} was trimmed from the archive "
                    f"(retained ids start at {self._base})")
        return np.stack(out)

    def trim(self, keep_from: int) -> int:
        """Drop every host frame with id < ``keep_from`` (clamped to the
        end); with spill they are written to segments first. Returns the
        frames that left the host."""
        drop = max(0, min(int(keep_from), len(self)) - self._base)
        if drop:
            if self.spill_enabled:
                self._spill(self._frames[:drop])
            del self._frames[:drop]
            self._base += drop
            self.trimmed += drop
        return drop

    def _spill(self, frames: List[np.ndarray]) -> None:
        """The host prefix from ``base`` → segments of at most
        ``segment_frames`` frames after the existing ones."""
        for off in range(0, len(frames), self.segment_frames):
            chunk = np.stack(frames[off:off + self.segment_frames])
            start = self._base + off
            path = os.path.join(self.spill_dir,
                                f"seg-{start:012d}-{len(chunk):05d}.npy")
            np.save(path, chunk, allow_pickle=False)
            self._segments.append((start, len(chunk), path, chunk.nbytes))
            self._seg_starts.append(start)
            self._unsynced.append(path)
            self._disk_bytes += chunk.nbytes
            self.io_stats["spilled_frames"] += len(chunk)
            self.io_stats["spilled_bytes"] += chunk.nbytes

    def _fault(self, i: int) -> np.ndarray:
        """A spilled id from its segment, through the LRU cache (a miss
        loads, and counts, one segment)."""
        k = bisect.bisect_right(self._seg_starts, i) - 1
        start, count, path, _ = self._segments[k]
        assert start <= i < start + count, (i, start, count)
        seg = self._cache.get(start)
        if seg is not None:
            self._cache.move_to_end(start)
            self.io_stats["spill_cache_hits"] += 1
        else:
            seg = np.load(path, allow_pickle=False)
            self.io_stats["spill_faults"] += 1
            self._cache[start] = seg
            while len(self._cache) > self.cache_segments:
                self._cache.popitem(last=False)
        return seg[i - start]

    def sync(self) -> int:
        """fsync the segments written since the last sync, and the
        directory so that their names last too. Returns the files
        synced."""
        if not self._unsynced:
            return 0
        for path in self._unsynced:
            with open(path, "rb") as f:
                os.fsync(f.fileno())
        dfd = os.open(self.spill_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        n = len(self._unsynced)
        self._unsynced.clear()
        return n

    def close(self) -> None:
        """Release both tiers: host frames, the cache, every segment file
        and the spill directory (if empty). Idempotent; the counters stay,
        for the session manager to fold."""
        self._frames.clear()
        self._cache.clear()
        self._unsynced.clear()
        for _, _, path, _ in self._segments:
            with contextlib.suppress(OSError):
                os.remove(path)
        self._segments.clear()
        self._seg_starts.clear()
        self._disk_bytes = 0
        if self.spill_dir is not None:
            with contextlib.suppress(OSError):
                os.rmdir(self.spill_dir)


def quantise_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """rows (..., d) f32 → (int8 rows, (...,) f32 per-row scales),
    scale = max|row|/127 (all-zero rows get 1.0). The scan kernels
    L2-normalise rows, so the scale cancels out of every score."""
    rows = np.asarray(rows, np.float32)
    scale = np.max(np.abs(rows), axis=-1) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(rows / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


# Uniform member pick: pick = (u * cnt) >> U_BITS with an integer variate
# u ∈ [0, 2^U_BITS), exact on every path.
U_BITS = 20
_U_CARD = 1 << U_BITS


def expand_gather(members: torch.Tensor, counts: torch.Tensor,
                  draws: torch.Tensor, valid: torch.Tensor,
                  u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reservoir gather over stacked tables: members (S, cap, K), counts
    (S, cap), draws/valid (S, Q, n) index rows, u (n,) int variates → (frame
    ids (S, Q, n), ok (S, Q, n)). One member per draw slot."""
    cap = members.shape[1]
    sidx = torch.arange(members.shape[0], device=members.device)[:, None,
                                                                  None]
    safe = draws.clamp(0, cap - 1).long()
    cnt = counts[sidx, safe]
    pick = (u.to(torch.int32) * cnt) >> U_BITS            # exact floor
    fids = members[sidx, safe, pick.long()]
    ok = valid & (cnt > 0) & (draws >= 0)
    return fids, ok


def gather_rows(table: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """table (S, cap) per-row values (index frame ids); draws (S, Q, n)
    rows → (S, Q, n), on the table's device."""
    sidx = torch.arange(table.shape[0], device=table.device)[:, None, None]
    return table[sidx, draws.long().clamp(0, table.shape[1] - 1)]


# ---------------------------------------------------------------------------
# Eviction policies
# ---------------------------------------------------------------------------


class EvictionPolicy:
    """``none``: overflow raises (the historical contract)."""

    name = "none"

    def evict(self, mem: "VenusMemory", need: int) -> None:
        raise RuntimeError("memory capacity exhausted")


class SlidingWindowEviction(EvictionPolicy):
    """Keep the newest ``capacity`` rows: evicting advances the ring head."""

    name = "sliding_window"

    def evict(self, mem: "VenusMemory", need: int) -> None:
        mem._advance_head(need)


class ClusterMergeEviction(SlidingWindowEviction):
    """Sliding window that first folds each evictee's member reservoir
    into its most similar surviving index row (cosine ≥ ``threshold``),
    so an evicted cluster's raw frames stay reachable through it."""

    name = "cluster_merge"

    def __init__(self, threshold: float = 0.8):
        self.threshold = threshold

    def evict(self, mem: "VenusMemory", need: int) -> None:
        mem._merge_into_survivors(need, self.threshold)
        mem._advance_head(need)


class ConsolidationEviction(ClusterMergeEviction):
    """Hierarchical-tier eviction (paper §IV-C): each evictee folds into
    the session's coarse tier (a running count-weighted centroid, a merged
    reservoir, a frame window) before the head advances, so evicted
    history stays reachable through the two-stage scan. Needs
    ``coarse_capacity > 0``."""

    name = "consolidate"

    def evict(self, mem: "VenusMemory", need: int) -> None:
        mem._consolidate(need, self.threshold)
        mem._advance_head(need)


_EVICTION_POLICIES = {"none": EvictionPolicy,
                      "sliding_window": SlidingWindowEviction,
                      "cluster_merge": ClusterMergeEviction,
                      "consolidate": ConsolidationEviction}


def get_eviction_policy(policy,
                        threshold: Optional[float] = None) -> EvictionPolicy:
    """A policy by name (an ``EvictionPolicy`` instance passes through).
    ``threshold``, the merging policies' cosine cut, must lie in (0, 1]."""
    if threshold is not None and not (0.0 < float(threshold) <= 1.0):
        raise ValueError(
            f"merge threshold must be in (0, 1], got {threshold!r}")
    if isinstance(policy, EvictionPolicy):
        return policy
    try:
        cls = _EVICTION_POLICIES[policy]
    except KeyError:
        raise KeyError(f"unknown eviction policy {policy!r}; known: "
                       f"{sorted(_EVICTION_POLICIES)}") from None
    if threshold is not None and issubclass(cls, ClusterMergeEviction):
        return cls(float(threshold))
    return cls()


def coarse_rows_for(capacity: int, coarse_capacity: int,
                    coarse_block: int) -> Tuple[int, int]:
    """The coarse tier's ``(n_blocks, n_coarse)``: rows ``[0, n_blocks)``
    summarise ``coarse_block`` physical fine rows each, rows ``[n_blocks,
    n_coarse)`` hold consolidated history. ``coarse_capacity`` 0 turns
    the tier off."""
    if coarse_capacity <= 0:
        return 0, 0
    assert coarse_block > 0, coarse_block
    n_blocks = -(-capacity // coarse_block)
    return n_blocks, n_blocks + coarse_capacity


def _index_dtype(index_dtype: str) -> torch.dtype:
    if index_dtype not in ("float32", "int8"):
        raise ValueError(f"index_dtype must be 'float32' or 'int8', got "
                         f"{index_dtype!r}")
    return torch.int8 if index_dtype == "int8" else torch.float32


# ---------------------------------------------------------------------------
# Arena
# ---------------------------------------------------------------------------


class _Buffer:
    """A front super-buffer by name on an unsharded arena (K == 1), where
    it is one tensor: the buffer itself, so writes through it reach the
    arena. A K-slab arena has no such tensor and reading one raises: the
    slabs (``MemoryArena.slabs``, ``slot_view``) or an explicit copy
    (``MemoryArena.whole``) serve there."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, arena, owner=None):
        if arena is None:
            return self
        if arena.n_shards > 1:
            raise RuntimeError(
                f"a {arena.n_shards}-slab arena has no single {self.name!r} "
                f"tensor: read arena.slabs({self.name!r}) or copy it with "
                f"arena.whole({self.name!r})")
        return arena.whole(self.name)


_COARSE = ("coarse_emb", "coarse_members", "coarse_member_count",
           "coarse_index_frame")


class MemoryArena:
    """Shared device-resident super-buffers for S sessions' memories:
    ``emb`` (S, cap, d) f32 or int8 (+ ``emb_scale`` (S, cap) for int8),
    ``members`` (S, cap, K), ``member_count`` and ``index_frame`` (S, cap).
    ``emb`` is the head of a buffer with one more row, always zero
    (``slabs("rows")``, (S·cap + 1, d)), so one gather can take a zero
    row (``tiering``).

    Slots: ``add_session`` reuses the last released slot (its rows are
    zeroed in place, ``slot_reuses``) or grows every buffer by one slot
    (a copy, ``grows``). Each slot has a ``(head, size)`` window in the
    host mirrors ``heads``/``sizes``; free slots read ``(0, 0)`` and scan
    as masked-out padding.

    Coarse tier (``coarse_capacity > 0``): ``coarse_emb`` (S, n_coarse, d),
    always f32, ``coarse_members`` (S, n_coarse, K), ``coarse_member_count``
    and ``coarse_index_frame`` (S, n_coarse), and the host mask
    ``coarse_valid``; rows ``[0, n_blocks)`` summarise fine blocks, the
    rest hold consolidated history (``coarse_rows_for``).

    Appends: the reference's donated XLA scatters become in-place
    ``index_put_`` writes into the preallocated buffers — one per
    super-buffer (and slab) per tick inside ``deferred_appends``, coarse
    rows after fine ones.

    **Sharding** (``mesh=`` whose ``mesh_axis`` has K > 1 devices): every
    super-buffer is K slab tensors, slab k holding slots ``[k·S/K,
    (k+1)·S/K)`` on ``mesh`` device k (``launch.sharding``), each with its
    own zero row after ``emb``. The scans of ``kernels.ops`` launch once
    per slab and the executor's gathers read each slot from its slab
    (``map_slabs``). The arena grows by blocks of K slots — the first
    handed out, the rest parked in ``virgin_slots`` (zero already, so
    claiming one is free and no ``slot_reuse``) — and growth moves slab
    boundaries, a reshard copy counted in ``grows``. Allocation takes the
    free or virgin slot of the least-loaded slab, ties to the lowest
    slot. There ``arena.emb`` and its siblings raise (no one tensor holds
    the buffer); ``whole(name)`` is an explicit copy. K == 1 (or no mesh)
    is the unsharded arena: one tensor a buffer, single-slot growth, LIFO
    reuse.

    **Double buffering** (``double_buffer=True``): a back set of the fine
    buffers, one tick behind the front. A flush writes last tick's blocks
    (the carry) and then this tick's into the back set and swaps the two;
    writes keep the last one per (slot, pos), so the front after every
    flush is bitwise the single-buffer state. On CUDA the back set's
    writes run on an ingest stream of the arena's own (one a device), so
    they overlap query launches already queued on the front: the flush
    waits on an event recorded at the previous swap (and after any reset
    or growth the query stream made to the back set since), and at the
    swap the query stream waits on the flush's event. Slot resets and
    growth apply to both sets; a recycled slot is dropped from the
    carry. The coarse tier stays single-buffered."""

    emb = _Buffer()
    emb_scale = _Buffer()
    members = _Buffer()
    member_count = _Buffer()
    index_frame = _Buffer()
    coarse_emb = _Buffer()
    coarse_members = _Buffer()
    coarse_member_count = _Buffer()
    coarse_index_frame = _Buffer()

    def __init__(self, capacity: int, dim: int, member_cap: int = 128,
                 index_dtype: str = "float32", *, mesh=None,
                 mesh_axis: str = "model", double_buffer: bool = False,
                 coarse_capacity: int = 0, coarse_block: int = 64,
                 device=None):
        self.capacity = capacity
        self.dim = dim
        self.member_cap = member_cap
        self.index_dtype = index_dtype
        self._emb_dtype = _index_dtype(index_dtype)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.n_shards = mesh_axis_size(mesh, mesh_axis)
        self.devices = ([resolve_device(device)] if mesh is None
                        else slab_devices(mesh, mesh_axis))
        self.device = self.devices[0]
        self.n_sessions = 0
        self.sizes = np.zeros((0,), np.int32)
        self.heads = np.zeros((0,), np.int32)
        self.coarse_capacity = coarse_capacity
        self.coarse_block = coarse_block
        self.n_blocks, self.n_coarse = coarse_rows_for(
            capacity, coarse_capacity, coarse_block)
        # name → K slab tensors; "rows" holds each slab's emb with its
        # zero row. The coarse tier has one set; the fine buffers a front
        # and, double-buffered, a back set
        self._front: dict = {}
        self._back: Optional[dict] = {} if double_buffer else None
        self._coarse: dict = {}
        self._carry: list = []
        self._streams: dict = {}         # device → the ingest stream
        self._back_free: dict = {}       # device → event: back set idle
        self._ingest_done: dict = {}     # device → event: flush written
        self.coarse_valid = np.zeros((0, self.n_coarse), bool)
        self._coarse_valid_dev: Optional[torch.Tensor] = None
        self._coarse_valid_ver = -1
        self.free_slots: List[int] = []
        self.virgin_slots: List[int] = []
        self.version = 0
        self._windows_dev: Optional[torch.Tensor] = None
        self._valid_dev: Optional[torch.Tensor] = None
        self._valid_version = -1
        self._deferred: Optional[list] = None
        self._coarse_deferred: Optional[list] = None
        self.io_stats = {"grows": 0, "appends": 0, "appended_rows": 0,
                         "slot_releases": 0, "slot_reuses": 0,
                         "double_flushes": 0, "carry_rows": 0,
                         "coarse_appends": 0, "coarse_appended_rows": 0}

    @property
    def double_buffer(self) -> bool:
        return self._back is not None

    def reset_io_stats(self) -> None:
        for k in self.io_stats:
            self.io_stats[k] = 0

    # ---------------------------------------------------------------- slabs
    def slabs(self, name: str) -> List[torch.Tensor]:
        """The K slab tensors of a front buffer (``"rows"``: each slab's
        emb with its zero row after it)."""
        return (self._coarse if name in _COARSE else self._front)[name]

    def whole(self, name: str) -> Optional[torch.Tensor]:
        """A front buffer whole: at K == 1 the buffer itself; at K > 1 a
        copy, its slabs concatenated on the first device, which writes do
        not reach (for tests and tools: the ingest and query paths read
        the slabs). None for a buffer this arena does not keep."""
        slabs = (self._coarse if name in _COARSE else self._front).get(name)
        if slabs is None:
            return None
        if len(slabs) == 1:
            return slabs[0]
        return torch.cat([x.to(self.device) for x in slabs])

    def operand(self, name: str = "emb"):
        """A buffer as a scan operand: the tensor, or the K slabs."""
        slabs = self.slabs(name)
        return slabs[0] if self.n_shards == 1 else list(slabs)

    @property
    def per_slab(self) -> int:
        return self.n_sessions // self.n_shards

    def _shard_of(self, slot: int) -> int:
        """The slab (device) a slot lives on now."""
        slab = max(1, self.n_sessions // self.n_shards)
        return min(slot // slab, self.n_shards - 1)

    def slab_of(self, slot: int) -> Tuple[int, int]:
        """(slab, slot within the slab)."""
        k = self._shard_of(slot)
        return k, slot - k * self.per_slab

    def slot_view(self, name: str, slot: int) -> torch.Tensor:
        """One slot's rows of a front buffer, a view into its slab."""
        k, i = self.slab_of(slot)
        return self.slabs(name)[k][i]

    def load_slot(self, name: str, slot: int, rows: torch.Tensor) -> None:
        """Set one slot's rows of a buffer, in both sets when
        double-buffered: a memory carried in from elsewhere
        (``convert.arena_from_numpy``)."""
        k, i = self.slab_of(slot)
        for bufs in self._sets() + [self._coarse]:
            if name in bufs:
                bufs[name][k][i].copy_(rows)
        self._back_written()

    def map_slabs(self, fn, *xs: torch.Tensor):
        """``fn(k, *parts)`` for each slab k, ``parts`` the slab's rows of
        the (S, …) operands ``xs`` on its device; the outputs (a tensor or
        a tuple) come back to the first device concatenated along S. At
        K == 1 it is one call on ``xs``."""
        if self.n_shards == 1:
            return fn(0, *xs)
        per = self.per_slab
        outs = [fn(k, *(x[k * per:(k + 1) * per].to(dev) for x in xs))
                for k, dev in enumerate(self.devices)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[i].to(self.device) for o in outs])
                         for i in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])

    def _by_slab(self, slots: np.ndarray):
        """(slab, selection, slots within the slab) of each slab the slot
        ids touch."""
        if self.n_shards == 1:
            yield 0, slice(None), slots
            return
        per = self.per_slab
        shard = slots // per
        for k in np.unique(shard):
            sel = np.nonzero(shard == k)[0]
            yield int(k), sel, slots[sel] - int(k) * per

    # ------------------------------------------------------------- lifecycle
    def _slot_shapes(self, coarse: bool):
        cap, d, k, nc = self.capacity, self.dim, self.member_cap, \
            self.n_coarse
        if coarse:
            return {"coarse_emb": ((nc, d), torch.float32),
                    "coarse_members": ((nc, k), torch.int32),
                    "coarse_member_count": ((nc,), torch.int32),
                    "coarse_index_frame": ((nc,), torch.int32)}
        shapes = {"emb": ((cap, d), self._emb_dtype),
                  "members": ((cap, k), torch.int32),
                  "member_count": ((cap,), torch.int32),
                  "index_frame": ((cap,), torch.int32)}
        if self.index_dtype == "int8":
            shapes["emb_scale"] = ((cap,), torch.float32)
        return shapes

    def _reslab(self, bufs: dict, s: int, coarse: bool) -> None:
        """Re-lay one buffer set over S = ``s`` slots: new zero slabs of
        s/K slots, each filled with the old slots it now holds."""
        old_s, old_per = self.n_sessions, self.per_slab
        per = s // self.n_shards
        cap, d = self.capacity, self.dim
        for name, (shape, dtype) in self._slot_shapes(coarse).items():
            old, new, rows = bufs.get(name), [], []
            for k, dev in enumerate(self.devices):
                if name == "emb":
                    rows.append(torch.zeros((per * cap + 1, d), dtype=dtype,
                                            device=dev))
                    slab = rows[-1][:per * cap].view(per, cap, d)
                else:
                    slab = torch.zeros((per,) + shape, dtype=dtype,
                                       device=dev)
                g, hi = k * per, min((k + 1) * per, old_s)
                while g < hi:
                    i, lo = divmod(g, old_per)
                    n = min(hi - g, old_per - lo)
                    slab[g - k * per:g - k * per + n] = old[i][lo:lo + n]
                    g += n
                new.append(slab)
            bufs[name] = new
            if rows:
                bufs["rows"] = rows

    def _sets(self) -> List[dict]:
        return [self._front] + ([self._back] if self._back is not None
                                else [])

    def _grow_block(self) -> int:
        """Grow every buffer by one block of K slots; returns the first,
        parking the rest in ``virgin_slots``."""
        slot = self.n_sessions
        s = slot + self.n_shards
        for bufs in self._sets():
            self._reslab(bufs, s, coarse=False)
        if self.n_coarse:
            self._reslab(self._coarse, s, coarse=True)
        self.n_sessions = s
        self.sizes = np.append(self.sizes, np.zeros((self.n_shards,),
                                                    np.int32))
        self.heads = np.append(self.heads, np.zeros((self.n_shards,),
                                                    np.int32))
        self.coarse_valid = np.concatenate(
            [self.coarse_valid, np.zeros((self.n_shards, self.n_coarse),
                                         bool)])
        self.virgin_slots.extend(range(slot + 1, s))
        self._back_written()
        self.version += 1
        self.io_stats["grows"] += 1
        return slot

    def _recycle(self, slot: int) -> int:
        k, i = self.slab_of(slot)
        for bufs in self._sets() + [self._coarse]:
            for name, slabs in bufs.items():
                if name != "rows":
                    slabs[k][i].zero_()
        # last tick's rows must not come back into the recycled slot
        self._carry = [b for b in self._carry if b[0] != slot]
        self._back_written()
        self.coarse_valid[slot] = False
        self.sizes[slot] = 0
        self.heads[slot] = 0
        self.version += 1
        self.io_stats["slot_reuses"] += 1
        return slot

    def add_session(self) -> int:
        """Allocate a slot. Unsharded: the last released one (LIFO) or a
        new one. Sharded: the free or virgin slot on the least-loaded slab
        (ties to the lowest slot), else a new block."""
        if self.n_shards == 1:
            if self.free_slots:
                return self._recycle(self.free_slots.pop())
            return self._grow_block()
        dead = set(self.free_slots) | set(self.virgin_slots)
        if not dead:
            return self._grow_block()
        load = [0] * self.n_shards
        for s in range(self.n_sessions):
            if s not in dead:
                load[self._shard_of(s)] += 1
        slot = min(sorted(dead), key=lambda s: (load[self._shard_of(s)], s))
        if slot in self.virgin_slots:
            self.virgin_slots.remove(slot)
            return slot
        self.free_slots.remove(slot)
        return self._recycle(slot)

    def release_slot(self, slot: int) -> None:
        assert 0 <= slot < self.n_sessions, slot
        assert slot not in self.free_slots, f"slot {slot} already free"
        assert slot not in self.virgin_slots, f"slot {slot} never allocated"
        self.free_slots.append(slot)
        self.sizes[slot] = 0
        self.heads[slot] = 0
        self.coarse_valid[slot] = False
        self.version += 1
        self.io_stats["slot_releases"] += 1

    # ------------------------------------------------------ ingest streams
    def _cuda_devices(self) -> List[torch.device]:
        return [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]

    def _back_written(self) -> None:
        """The query stream just reset or grew the back set: the next
        flush's writes wait for that (an event after it)."""
        if self._back is None:
            return
        for d in self._cuda_devices():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            self._back_free[d] = ev

    @contextlib.contextmanager
    def _ingest(self):
        """Write the back set on each device's ingest stream, after the
        back set's last reader; record the writes' event for the swap."""
        devs = self._cuda_devices()
        with contextlib.ExitStack() as stack:
            for d in devs:
                st = self._streams.get(d)
                if st is None:
                    st = self._streams[d] = torch.cuda.Stream(d)
                if d in self._back_free:
                    st.wait_event(self._back_free[d])
                stack.enter_context(torch.cuda.stream(st))
            yield
        for d in devs:
            ev = torch.cuda.Event()
            ev.record(self._streams[d])
            self._ingest_done[d] = ev

    def _swap(self) -> None:
        """Front ↔ back. Every launch queued so far read the old front,
        the next flush's target: an event after them frees it. The query
        stream then waits for the new front's writes. The ingest stream's
        temporaries never reach the query stream, and every buffer it
        writes is freed (at a growth) only after the query stream has
        waited for it, so the caching allocator needs no
        ``record_stream``."""
        self._front, self._back = self._back, self._front
        self._back_written()
        for d in self._cuda_devices():
            torch.cuda.current_stream(d).wait_event(self._ingest_done[d])

    # ------------------------------------------------------------ ingestion
    @contextlib.contextmanager
    def deferred_appends(self):
        """Batch every ``append`` and ``append_coarse`` inside the context
        into ONE in-place write per super-buffer (and slab). Re-entrant:
        the outermost context flushes, fine rows first (block summaries
        are computed from the post-tick host mirrors)."""
        if self._deferred is not None:
            yield
            return
        self._deferred, self._coarse_deferred = [], []
        try:
            yield
        finally:
            pending, self._deferred = self._deferred, None
            coarse, self._coarse_deferred = self._coarse_deferred, None
            self._flush(pending)
            self._flush_coarse(coarse)

    def append(self, slot: int, pos: int, emb_rows: np.ndarray,
               member_rows: np.ndarray, member_cnts: np.ndarray,
               if_rows: np.ndarray, window: Tuple[int, int]) -> int:
        """Write one session's contiguous row run at ``[slot, pos:pos+n]``
        and record its new ``(head, size)`` window — queued inside a
        ``deferred_appends`` window, else written now. The rows are
        copied: the caller's arrays are views of host mirrors that a later
        ring write may overwrite before the flush (or, double-buffered,
        before the carry's replay)."""
        block = (slot, pos, np.array(emb_rows, np.float32),
                 np.array(member_rows, np.int32),
                 np.array(member_cnts, np.int32),
                 np.array(if_rows, np.int32),
                 (int(window[0]), int(window[1])))
        if self._deferred is not None:
            self._deferred.append(block)
            return len(emb_rows)
        return self._flush([block])

    def append_coarse(self, slot: int, pos: int, emb_rows: np.ndarray,
                      member_rows: np.ndarray, member_cnts: np.ndarray,
                      if_rows: np.ndarray, valid_rows: np.ndarray) -> int:
        """Write one session's coarse row run at ``[slot, pos:pos+n]`` —
        block summaries (``pos < n_blocks``) or consolidated rows — with
        each row's stage-1 visibility ``valid_rows``; queued inside a
        ``deferred_appends`` window, else written now. Copied, as in
        ``append``."""
        assert self.n_coarse, "arena has no coarse tier"
        block = (slot, pos, np.array(emb_rows, np.float32),
                 np.array(member_rows, np.int32),
                 np.array(member_cnts, np.int32),
                 np.array(if_rows, np.int32),
                 np.array(valid_rows, bool))
        if self._coarse_deferred is not None:
            self._coarse_deferred.append(block)
            return len(emb_rows)
        return self._flush_coarse([block])

    @staticmethod
    def _last_writes(blocks: list, width: int, ncols: int):
        """Concatenate queued blocks → (slots, poss, and the ``ncols``
        row columns after each block's (slot, pos)), keeping
        only the LAST write per (slot, pos): a session that wraps inside
        one tick can hit a position twice, the carry's replay precedes
        the tick's own blocks, and ``index_put_`` leaves the order of
        duplicate writes unspecified."""
        slots = np.concatenate([np.full(len(b[2]), b[0], np.int64)
                                for b in blocks])
        poss = np.concatenate([np.arange(b[1], b[1] + len(b[2]),
                                         dtype=np.int64) for b in blocks])
        cols = [np.concatenate([b[i] for b in blocks])
                for i in range(2, 2 + ncols)]
        lin = slots * width + poss
        if len(np.unique(lin)) != len(lin):
            last = {v: i for i, v in enumerate(lin)}
            keep = np.sort(np.fromiter(last.values(), np.int64))
            slots, poss = slots[keep], poss[keep]
            cols = [c[keep] for c in cols]
        return (slots, poss, *cols)

    def _put_rows(self, bufs: dict, slots: np.ndarray, poss: np.ndarray,
                  cols: dict) -> None:
        """One ``index_put_`` per buffer and slab the rows touch."""
        for k, sel, local in self._by_slab(slots):
            dev = self.devices[k]
            sl = torch.from_numpy(local).to(dev)
            po = torch.from_numpy(poss[sel]).to(dev)
            for name, rows in cols.items():
                bufs[name][k].index_put_(
                    (sl, po), torch.from_numpy(rows[sel]).to(dev))

    def _write(self, bufs: dict, blocks: list) -> int:
        slots, poss, emb_rows, mem_rows, cnt_rows, if_rows = \
            self._last_writes(blocks, self.capacity, 4)
        cols = {}
        if self.index_dtype == "int8":
            # quantise ONCE, at the append; scans stream the int8 rows
            emb_rows, cols["emb_scale"] = quantise_rows(emb_rows)
        cols.update(emb=emb_rows, members=mem_rows, member_count=cnt_rows,
                    index_frame=if_rows)
        self._put_rows(bufs, slots, poss, cols)
        return len(slots)

    def _flush(self, blocks: list) -> int:
        """Write the queued blocks: into the front set, or double-buffered
        the carry and then them into the back set, then swap."""
        if not blocks:
            return 0
        if self._back is None:
            n = self._write(self._front, blocks)
        else:
            carry = self._carry
            with self._ingest():
                n = self._write(self._back, carry + blocks)
            self._swap()
            # append copied every block, so the carry keeps them as they
            # are (the reference's _copy_block)
            self._carry = list(blocks)
            self.io_stats["double_flushes"] += 1
            self.io_stats["carry_rows"] += sum(len(b[2]) for b in carry)
        for slot, _pos, _e, _m, _c, _f, window in blocks:
            self.heads[slot], self.sizes[slot] = window
        self.version += 1
        self.io_stats["appends"] += 1
        self.io_stats["appended_rows"] += n
        return n

    def _flush_coarse(self, blocks: list) -> int:
        """One in-place write per coarse super-buffer (and slab) for the
        queued summary rows; bumps ``version`` so every cached view and
        mask refreshes."""
        if not blocks:
            return 0
        slots, poss, emb_rows, mem_rows, cnt_rows, if_rows, val_rows = \
            self._last_writes(blocks, self.n_coarse, 5)
        self.coarse_valid[slots, poss] = val_rows
        self._put_rows(self._coarse, slots, poss, {
            "coarse_emb": emb_rows, "coarse_members": mem_rows,
            "coarse_member_count": cnt_rows, "coarse_index_frame": if_rows})
        self.version += 1
        self.io_stats["coarse_appends"] += 1
        self.io_stats["coarse_appended_rows"] += len(slots)
        return len(slots)

    # ----------------------------------------------------------------- views
    def _refresh_valid(self) -> None:
        self._windows_dev = torch.from_numpy(
            np.stack([self.heads, self.sizes], axis=1).astype(np.int32)
        ).to(self.device)
        self._valid_dev = as_valid_mask(self._windows_dev, self.capacity)
        self._valid_version = self.version

    def device_windows(self) -> torch.Tensor:
        """(S, 2) int32 ``[head, size]`` ring windows on the device."""
        if self._windows_dev is None or self._valid_version != self.version:
            self._refresh_valid()
        return self._windows_dev

    def device_valid(self) -> torch.Tensor:
        """(S, capacity) bool valid mask, derived on the device."""
        if self._valid_dev is None or self._valid_version != self.version:
            self._refresh_valid()
        return self._valid_dev

    def device_coarse_valid(self) -> torch.Tensor:
        """(S, n_coarse) bool stage-1 mask of the coarse tier, cached per
        version: coarse validity is sparse and written on the host, so
        the explicit mask is its valid operand."""
        assert self.n_coarse, "arena has no coarse tier"
        if (self._coarse_valid_dev is None
                or self._coarse_valid_ver != self.version):
            self._coarse_valid_dev = torch.from_numpy(
                self.coarse_valid.copy()).to(self.device)
            self._coarse_valid_ver = self.version
        return self._coarse_valid_dev

    def has_consolidated(self) -> bool:
        """True iff a slot holds a consolidated row: until the first
        consolidation every query takes the flat scan unchanged."""
        return bool(self.n_coarse
                    and self.coarse_valid[:, self.n_blocks:].any())

    # ------------------------------------------------ per-slab query gathers
    def expand_members(self, draws: torch.Tensor, valid: torch.Tensor,
                       u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``expand_gather`` over the arena's reservoirs, each slot's
        from its slab."""
        mem, cnt = self.slabs("members"), self.slabs("member_count")
        return self.map_slabs(lambda k, d, v: expand_gather(
            mem[k], cnt[k], d, v, u.to(d.device)), draws, valid)

    def gather_index_frames(self, draws: torch.Tensor) -> torch.Tensor:
        """draws (S, Q, n) slots → index frame ids (S, Q, n), each slot's
        from its slab."""
        ifr = self.slabs("index_frame")
        return self.map_slabs(lambda k, d: gather_rows(ifr[k], d), draws)


# ---------------------------------------------------------------------------
# One session's memory
# ---------------------------------------------------------------------------

# each detached device buffer's counters, under the reference's names
_UPLOAD_COUNTERS = {"emb": "full_uploads", "members": "member_uploads",
                    "index_frame": "index_frame_uploads"}
_APPEND_COUNTERS = {"emb": "appended_rows", "members": "appended_member_rows",
                    "index_frame": "appended_index_frame_rows"}


class VenusMemory:
    """Index layer: packed vector store + cluster member reservoirs, and
    with ``coarse_capacity > 0`` the host state of the coarse tier."""

    def __init__(self, capacity: int, dim: int, member_cap: int = 128,
                 seed: int = 0, *, arena: Optional[MemoryArena] = None,
                 slot: Optional[int] = None, eviction="none",
                 index_dtype: str = "float32",
                 merge_threshold: Optional[float] = None,
                 coarse_capacity: int = 0, coarse_block: int = 64,
                 device=None):
        # the exact integer pick (u * cnt) >> U_BITS must fit in int32
        assert member_cap <= (1 << (31 - U_BITS)), member_cap
        self.capacity = capacity
        self.dim = dim
        self.member_cap = member_cap
        self.eviction = get_eviction_policy(eviction, merge_threshold)
        self.index_dtype = index_dtype
        _index_dtype(index_dtype)
        self.arena = arena
        self.slot = slot
        if arena is not None:
            assert slot is not None
            assert arena.index_dtype == index_dtype
            assert (arena.capacity, arena.dim, arena.member_cap) == \
                (capacity, dim, member_cap)
            assert (arena.coarse_capacity, arena.coarse_block) == \
                (coarse_capacity, coarse_block), \
                "memory and arena disagree on coarse-tier geometry"
            self.device = arena.device
        else:
            self.device = resolve_device(device)
        # coarse tier, host-authoritative: block summaries are computed
        # from the fine mirrors on demand; only consolidated rows keep
        # state of their own (centroid, reservoir, weight, frame window)
        self.coarse_capacity = coarse_capacity
        self.coarse_block = coarse_block
        self.n_blocks, self.n_coarse = coarse_rows_for(
            capacity, coarse_capacity, coarse_block)
        if self.n_coarse:
            cc = coarse_capacity
            self._coarse_emb = np.zeros((cc, dim), np.float32)
            self._coarse_members = np.zeros((cc, member_cap), np.int32)
            self._coarse_count = np.zeros((cc,), np.int32)
            self._coarse_ifr = np.zeros((cc,), np.int32)
            self._coarse_weight = np.zeros((cc,), np.int64)
            self._coarse_fid_lo = np.zeros((cc,), np.int64)
            self._coarse_fid_hi = np.zeros((cc,), np.int64)
        self._coarse_csize = 0              # consolidated rows in use
        self._dirty_blocks: set = set()     # fine blocks to re-summarise
        self._emb = np.zeros((capacity, dim), np.float32)
        self._members = np.zeros((capacity, member_cap), np.int32)
        self._member_count = np.zeros((capacity,), np.int32)
        self._index_frame = np.zeros((capacity,), np.int32)
        # each row's scene (partition) id, kept as the reference keeps it
        self._scene_id = np.zeros((capacity,), np.int32)
        self._size = 0
        self._head = 0
        self._rng = np.random.default_rng(seed)
        self._dev: dict = {}             # detached device copies, by name
        self._window_key = None          # (head, size) of the cached mask
        self._valid_dev: Optional[torch.Tensor] = None
        self.version = 0
        self.io_stats = {"full_uploads": 0, "appended_rows": 0,
                         "member_uploads": 0, "appended_member_rows": 0,
                         "index_frame_uploads": 0,
                         "appended_index_frame_rows": 0,
                         "scans": 0, "host_expand_gathers": 0,
                         "device_expand_gathers": 0,
                         "evicted_rows": 0, "reservoir_merges": 0,
                         "consolidated_rows": 0}

    def reset_io_stats(self) -> None:
        for k in self.io_stats:
            self.io_stats[k] = 0

    # ------------------------------------------------------------- ingestion
    def insert_cluster(self, embedding: np.ndarray, *, scene_id: int,
                       index_frame: int, member_frames: Sequence[int]
                       ) -> int:
        return int(self.insert_batch(
            np.asarray(embedding, np.float32)[None],
            scene_ids=[scene_id], index_frames=[index_frame],
            member_lists=[member_frames])[0])

    def insert_batch(self, embeddings: np.ndarray, *,
                     scene_ids: Sequence[int],
                     index_frames: Sequence[int],
                     member_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Insert a batch of indexed vectors; on overflow the eviction
        policy decides (``none`` raises, ``sliding_window`` advances the
        head). Returns the physical rows written (a ring write is at most
        two contiguous runs)."""
        embeddings = np.asarray(embeddings, np.float32)
        n = embeddings.shape[0]
        assert n == len(scene_ids) == len(index_frames) == len(member_lists)
        if n > self.capacity:
            if self.eviction.name == "none":
                raise RuntimeError("memory capacity exhausted")
            drop = n - self.capacity
            embeddings = embeddings[drop:]
            scene_ids = list(scene_ids)[drop:]
            index_frames = list(index_frames)[drop:]
            member_lists = list(member_lists)[drop:]
            self.io_stats["evicted_rows"] += drop
            n = self.capacity
        overflow = self._size + n - self.capacity
        if overflow > 0:
            self.eviction.evict(self, overflow)
        tail = (self._head + self._size) % self.capacity
        ids = np.asarray(index_frames, np.int32)
        scn = np.asarray(scene_ids, np.int32)
        run1 = min(n, self.capacity - tail)
        runs = [(tail, 0, run1)]
        if run1 < n:
            runs.append((0, run1, n - run1))
        for pos, off, cnt in runs:
            self._emb[pos:pos + cnt] = embeddings[off:off + cnt]
            self._index_frame[pos:pos + cnt] = ids[off:off + cnt]
            self._scene_id[pos:pos + cnt] = scn[off:off + cnt]
        for j, member_frames in enumerate(member_lists):
            members = np.asarray(member_frames, np.int32)
            m = len(members)
            if m > self.member_cap:            # uniform reservoir
                keep = self._rng.choice(m, self.member_cap, replace=False)
                members = members[np.sort(keep)]
                m = self.member_cap
            pj = (tail + j) % self.capacity
            self._members[pj, :m] = members
            self._members[pj, m:] = 0
            self._member_count[pj] = m
        self._size += n
        self.version += 1
        for pos, _off, cnt in runs:
            self._sync_device(pos, cnt)
        if self.n_coarse:
            for pos, _off, cnt in runs:
                self._mark_blocks_dirty(pos, cnt)
            self._refresh_block_summaries()
        return (tail + np.arange(n)) % self.capacity

    def _sync_device(self, pos: int, cnt: int) -> None:
        """Push the host rows [pos, pos+cnt) to the device copy: into the
        arena slot, or in place into each detached buffer already
        uploaded (one not uploaded yet takes the rows at its upload)."""
        if self.arena is not None:
            moved = self.arena.append(
                self.slot, pos, self._emb[pos:pos + cnt],
                self._members[pos:pos + cnt],
                self._member_count[pos:pos + cnt],
                self._index_frame[pos:pos + cnt], self.window)
            for k in _APPEND_COUNTERS.values():
                self.io_stats[k] += moved
            return
        for name, bufs in self._dev.items():
            for buf, rows in zip(bufs, self._host_rows(name, pos, cnt)):
                buf[pos:pos + cnt] = torch.from_numpy(rows).to(self.device)
            self.io_stats[_APPEND_COUNTERS[name]] += cnt

    def _advance_head(self, need: int) -> None:
        assert 0 <= need <= self._size, (need, self._size)
        if self.n_coarse and need:
            run1 = min(need, self.capacity - self._head)
            self._mark_blocks_dirty(self._head, run1)
            if run1 < need:
                self._mark_blocks_dirty(0, need - run1)
        self._head = (self._head + need) % self.capacity
        self._size -= need
        self.io_stats["evicted_rows"] += need

    # ------------------------------------------------- coarse consolidation
    # host numpy, in the reference's order and precision (float64 where it
    # takes float64), so the mirrors come out bit-equal to its own
    def _mark_blocks_dirty(self, pos: int, cnt: int) -> None:
        """Fine rows ``[pos, pos+cnt)`` changed validity or contents:
        their block summaries must be recomputed."""
        if cnt <= 0:
            return
        lo = pos // self.coarse_block
        hi = (pos + cnt - 1) // self.coarse_block
        self._dirty_blocks.update(range(lo, hi + 1))

    def _refresh_block_summaries(self) -> None:
        """Recompute each dirty block's summary (the mean of its live
        fine rows, no reservoir: a stage-1 win on a block expands into
        the block's own fine rows) and write it to the arena's coarse
        tier, riding the tick's deferred write."""
        if self.arena is None or not self._dirty_blocks:
            self._dirty_blocks.clear()
            return
        cap, blk = self.capacity, self.coarse_block
        idx = np.arange(cap)
        live = ((idx - self._head) % cap) < self._size
        k = self.member_cap
        for b in sorted(self._dirty_blocks):
            rows = slice(b * blk, min((b + 1) * blk, cap))
            v = live[rows]
            any_v = bool(v.any())
            if any_v:
                cen = self._emb[rows][v].mean(0, dtype=np.float64)
                ifr = int(self._index_frame[rows][v][0])
            else:
                cen = np.zeros((self.dim,), np.float64)
                ifr = 0
            self.arena.append_coarse(
                self.slot, b, cen.astype(np.float32)[None],
                np.zeros((1, k), np.int32), np.zeros((1,), np.int32),
                np.asarray([ifr], np.int32), np.asarray([any_v]))
        self._dirty_blocks.clear()

    def _consolidate(self, need: int, threshold: float) -> None:
        """Fold the ``need`` oldest rows into the consolidated region
        before they leave the fine window: running count-weighted
        centroid, merged reservoir (the evictee's index frame, then its
        members, up to ``member_cap``), widened frame window. Target: the
        most similar row when its cosine clears ``threshold``, a fresh row
        while the region has space, else the most similar row anyway (a
        full tier degrades to coarser summaries, never to data loss)."""
        if self.n_coarse == 0:
            raise RuntimeError(
                "eviction='consolidate' needs coarse_capacity > 0 "
                "(VenusConfig(coarse_capacity=...))")
        need = min(need, self._size)
        if need <= 0:
            return
        phys = (self._head + np.arange(need)) % self.capacity
        touched = set()
        for pe in phys:
            e = self._emb[pe].astype(np.float64)
            cs = self._coarse_csize
            best, best_sim = -1, -np.inf
            if cs:
                en = e / (np.linalg.norm(e) + 1e-12)
                c = self._coarse_emb[:cs].astype(np.float64)
                cn = c / (np.linalg.norm(c, axis=-1, keepdims=True)
                          + 1e-12)
                best = int(np.argmax(cn @ en))
                best_sim = float(cn[best] @ en)
            cnt_e = int(self._member_count[pe])
            fids = np.concatenate(
                [[int(self._index_frame[pe])],
                 self._members[pe, :cnt_e].astype(np.int64)])
            if best >= 0 and (best_sim >= threshold
                              or cs >= self.coarse_capacity):
                r, w = best, int(self._coarse_weight[best])
                self._coarse_emb[r] = (
                    (self._coarse_emb[r].astype(np.float64) * w + e)
                    / (w + 1)).astype(np.float32)
                self._coarse_weight[r] = w + 1
                ct = int(self._coarse_count[r])
                take = min(len(fids), self.member_cap - ct)
                if take > 0:
                    self._coarse_members[r, ct:ct + take] = fids[:take]
                    self._coarse_count[r] = ct + take
                self._coarse_fid_lo[r] = min(int(self._coarse_fid_lo[r]),
                                             int(fids.min()))
                self._coarse_fid_hi[r] = max(int(self._coarse_fid_hi[r]),
                                             int(fids.max()))
            else:
                r = cs
                self._coarse_csize = cs + 1
                self._coarse_emb[r] = e.astype(np.float32)
                self._coarse_weight[r] = 1
                m = min(len(fids), self.member_cap)
                self._coarse_members[r, :m] = fids[:m]
                self._coarse_members[r, m:] = 0
                self._coarse_count[r] = m
                self._coarse_ifr[r] = int(self._index_frame[pe])
                self._coarse_fid_lo[r] = int(fids.min())
                self._coarse_fid_hi[r] = int(fids.max())
            touched.add(r)
        self.io_stats["consolidated_rows"] += int(need)
        for r in sorted(touched):
            self._resync_coarse(r)

    def _resync_coarse(self, row: int) -> None:
        """Write one consolidated row to the arena's coarse tier (past
        the block summaries)."""
        if self.arena is None:
            return
        self.arena.append_coarse(
            self.slot, self.n_blocks + row,
            self._coarse_emb[row:row + 1],
            self._coarse_members[row:row + 1],
            self._coarse_count[row:row + 1],
            self._coarse_ifr[row:row + 1], np.asarray([True]))

    def _merge_into_survivors(self, need: int, threshold: float) -> None:
        """Before the ``need`` oldest rows leave the window, fold each
        one's reservoir into its most similar SURVIVING row (cosine ≥
        threshold) while that row has reservoir space; each modified
        survivor is written to the device once."""
        if need >= self._size:
            return
        cap = self.capacity
        phys = (self._head + np.arange(self._size)) % cap
        ev_phys, sv_phys = phys[:need], phys[need:]

        def _norm(rows):
            return rows / (np.linalg.norm(rows, axis=-1, keepdims=True)
                           + 1e-12)

        sims = _norm(self._emb[ev_phys]) @ _norm(self._emb[sv_phys]).T
        touched = set()
        for i, pe in enumerate(ev_phys):
            j = int(np.argmax(sims[i]))
            if sims[i, j] < threshold:
                continue
            pt = int(sv_phys[j])
            cnt_e = int(self._member_count[pe])
            take = min(cnt_e, self.member_cap
                       - int(self._member_count[pt]))
            if take <= 0:
                continue
            ct = int(self._member_count[pt])
            self._members[pt, ct:ct + take] = self._members[pe, :take]
            self._member_count[pt] = ct + take
            self.io_stats["reservoir_merges"] += 1
            touched.add(pt)
        for pt in sorted(touched):
            self._resync_row(pt)

    def _resync_row(self, pos: int) -> None:
        """Write one resident row whose reservoir grew to the device copy:
        through the arena's append, or in place into a detached members
        buffer already uploaded."""
        if self.arena is not None:
            self.arena.append(
                self.slot, pos, self._emb[pos:pos + 1],
                self._members[pos:pos + 1],
                self._member_count[pos:pos + 1],
                self._index_frame[pos:pos + 1], self.window)
            return
        bufs = self._dev.get("members")
        if bufs is not None:
            for buf, rows in zip(bufs, self._host_rows("members", pos, 1)):
                buf[pos:pos + 1] = torch.from_numpy(rows).to(self.device)
            self.io_stats["appended_member_rows"] += 1

    # ----------------------------------------------------------------- state
    @property
    def size(self) -> int:
        return self._size

    @property
    def head(self) -> int:
        return self._head

    @property
    def window(self) -> Tuple[int, int]:
        return self._head, self._size

    def min_live_frame(self) -> int:
        """Smallest absolute frame id any live row references (index
        frame or count-masked reservoir member, or a consolidated row's
        frame window); int64-max when empty."""
        lo = int(np.iinfo(np.int64).max)
        if self._size:
            phys = (self._head + np.arange(self._size)) % self.capacity
            lo = int(self._index_frame[phys].min())
            cnt = self._member_count[phys]
            live = np.arange(self.member_cap)[None, :] < cnt[:, None]
            if live.any():
                lo = min(lo, int(self._members[phys][live].min()))
        if self.n_coarse and self._coarse_csize:
            lo = min(lo, int(self._coarse_fid_lo[:self._coarse_csize].min()))
        return lo

    def detach_from_arena(self) -> None:
        """Sever this memory from its (about to be recycled) arena slot;
        its device views are uploaded from the host mirrors from now on."""
        self.arena = None
        self.slot = None
        self._dev = {}

    @staticmethod
    def expand_u(seed: int, size) -> np.ndarray:
        """The per-slot pick variates u ∈ [0, 2^U_BITS): a function of
        (seed, slot) only."""
        return np.random.default_rng(seed).integers(
            0, _U_CARD, size=size, dtype=np.int64)

    # ---------------------------------------------------------- device views
    def _host_rows(self, name: str, pos: int, cnt: int):
        """The host rows [pos, pos+cnt) of one detached device buffer,
        as the device holds them (int8 rows quantised per row)."""
        rows = slice(pos, pos + cnt)
        if name == "emb":
            emb = self._emb[rows]
            return ((quantise_rows(emb)[0] if self.index_dtype == "int8"
                     else np.ascontiguousarray(emb)),)
        if name == "members":
            return (np.ascontiguousarray(self._members[rows]),
                    np.ascontiguousarray(self._member_count[rows]))
        return (np.ascontiguousarray(self._index_frame[rows]),)

    def _detached(self, name: str) -> Tuple[torch.Tensor, ...]:
        """A detached buffer's device copy: uploaded whole at its first
        use (counted as the reference counts it), then kept current by
        in-place appends (``_sync_device``)."""
        bufs = self._dev.get(name)
        if bufs is None:
            bufs = self._dev[name] = tuple(
                torch.tensor(a, device=self.device)
                for a in self._host_rows(name, 0, self.capacity))
            self.io_stats[_UPLOAD_COUNTERS[name]] += 1
        return bufs

    def device_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embeddings (cap, d), valid (cap,)) on the device. The mask is
        cached against the ``(head, size)`` window it derives from, so a
        search makes no host-to-device copy while the window stands."""
        if self._window_key != self.window:
            w = torch.tensor([self.window], dtype=torch.int32,
                             device=self.device)
            self._valid_dev = as_valid_mask(w, self.capacity)[0]
            self._window_key = self.window
        if self.arena is not None:
            return self.arena.slot_view("emb", self.slot), self._valid_dev
        return self._detached("emb")[0], self._valid_dev

    def search(self, query_emb, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_emb (Q, d) → (sims (Q, cap), probs (Q, cap)), Eq. 4+5:
        one 2-D dense scan of this memory's rows (on its slab's device)."""
        emb, valid = self.device_index()
        self.io_stats["scans"] += 1
        q = torch.as_tensor(query_emb, dtype=torch.float32).to(emb.device)
        return kops.similarity(q, emb, tau=tau, valid=valid)

    def device_members(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.arena is not None:
            return (self.arena.slot_view("members", self.slot),
                    self.arena.slot_view("member_count", self.slot))
        return self._detached("members")

    def device_index_frames(self) -> torch.Tensor:
        if self.arena is not None:
            return self.arena.slot_view("index_frame", self.slot)
        return self._detached("index_frame")[0]

    # -------------------------------------------------- per-memory expansion
    def members_table(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The host reservoirs copied to the memory's device: (members
        (cap, K), counts (cap,))."""
        return (torch.from_numpy(self._members.copy()).to(self.device),
                torch.from_numpy(self._member_count.copy()).to(self.device))

    def expand_draws(self, draws: np.ndarray, valid: np.ndarray,
                     seed: int = 0) -> np.ndarray:
        """Index draws → frame ids: each draw of row i picks one member of
        its reservoir uniformly (paper §IV-D1), one variate per slot
        (valid or not). Deduplicated, time-ordered frame ids."""
        draws = np.atleast_1d(np.asarray(draws))
        valid = np.atleast_1d(np.asarray(valid, bool))
        u = self.expand_u(seed, draws.shape)
        return self._expand_u(draws, valid, u)

    def expand_draws_batch(self, draws: np.ndarray, valid: np.ndarray,
                           seed: int = 0) -> List[np.ndarray]:
        """draws/valid (Q, n): each row takes the same variates as one
        ``expand_draws`` call with the same seed."""
        draws = np.asarray(draws)
        valid = np.asarray(valid, bool)
        q, n = draws.shape
        u = np.broadcast_to(self.expand_u(seed, n), (q, n))
        fids, ok = self._expand_u(draws, valid, u, dedup=False)
        return [np.unique(fids[i][ok[i]]) for i in range(q)]

    def expand_draws_device(self, draws: np.ndarray, valid: np.ndarray,
                            seed: int = 0) -> np.ndarray:
        """``expand_draws`` with the reservoir gather on the memory's
        device (``expand_gather`` over ``device_members()``); only the
        frame ids come back."""
        draws = np.atleast_1d(np.asarray(draws, np.int32))
        valid = np.atleast_1d(np.asarray(valid, bool))
        members, counts = self.device_members()
        u = self.expand_u(seed, draws.shape)
        dev = members.device
        fids, ok = expand_gather(
            members[None], counts[None],
            torch.from_numpy(draws).to(dev)[None, None],
            torch.from_numpy(valid).to(dev)[None, None],
            torch.from_numpy(u).to(dev))
        self.io_stats["device_expand_gathers"] += 1
        fids, ok = fids[0, 0].cpu().numpy(), ok[0, 0].cpu().numpy()
        return np.unique(fids[ok].astype(np.int64))

    def _expand_u(self, draws, valid, u, dedup: bool = True):
        self.io_stats["host_expand_gathers"] += 1
        safe = np.clip(draws, 0, self.capacity - 1)
        cnt = self._member_count[safe].astype(np.int64)
        pick = (np.asarray(u, np.int64) * cnt) >> U_BITS
        fids = self._members[safe, pick].astype(np.int64)
        ok = valid & (cnt > 0) & (draws >= 0)
        if dedup:
            return np.unique(fids[ok])
        return fids, ok

    def _expand_draws_loop(self, draws: np.ndarray, valid: np.ndarray,
                           seed: int = 0) -> np.ndarray:
        """A per-draw loop over the same scheme: the reference for the
        vectorised paths."""
        rng = np.random.default_rng(seed)
        out = []
        for i, ok in zip(np.asarray(draws), np.asarray(valid)):
            u = int(rng.integers(0, _U_CARD, dtype=np.int64))
            if not ok or i < 0:
                continue
            cnt = int(self._member_count[int(i)])
            if cnt == 0:
                continue
            out.append(int(self._members[int(i), (u * cnt) >> U_BITS]))
        return np.unique(np.asarray(out, np.int64))

    def index_frames(self, idx: Sequence[int]) -> np.ndarray:
        return self._index_frame[np.asarray(idx, np.int64)]


# ---------------------------------------------------------------------------
# Cross-session stacked views
# ---------------------------------------------------------------------------


class MemoryStack:
    """Padded-stack view over S same-shape ``VenusMemory`` instances.
    When they cover one arena exactly (slots 0..S-1 in order) every view
    IS an arena super-buffer — zero rebuilds. Otherwise the per-memory
    device rows are stacked, cached against the memories' versions, and
    each rebuild is counted into ``rebuild_stats["stack_rebuilds"]``."""

    def __init__(self, memories: Sequence[VenusMemory], *,
                 rebuild_stats: Optional[dict] = None):
        memories = list(memories)
        assert memories, "empty stack"
        m0 = memories[0]
        for m in memories:
            assert (m.capacity, m.dim, m.member_cap, m.index_dtype) == \
                (m0.capacity, m0.dim, m0.member_cap, m0.index_dtype), \
                "stacked memories must share capacity/dim/member_cap/dtype"
        self.memories = memories
        self.capacity, self.dim, self.member_cap = (m0.capacity, m0.dim,
                                                    m0.member_cap)
        self.rebuild_stats = rebuild_stats
        arena = m0.arena
        self._arena = (arena if arena is not None
                       and all(m.arena is arena for m in memories)
                       and [m.slot for m in memories]
                       == list(range(len(memories))) else None)
        self._cache: dict = {}
        self.io_stats = {"stack_builds": 0, "member_stack_builds": 0,
                         "index_frame_stack_builds": 0}

    def __len__(self) -> int:
        return len(self.memories)

    def arena_view(self) -> Optional[MemoryArena]:
        a = self._arena
        if a is not None and len(self.memories) == a.n_sessions:
            return a
        return None

    def _stacked(self, what: str, build, counter: str):
        vers = tuple(m.version for m in self.memories)
        hit = self._cache.get(what)
        if hit is None or hit[0] != vers:
            hit = self._cache[what] = (vers, build())
            self.io_stats[counter] += 1
            if self.rebuild_stats is not None:
                self.rebuild_stats["stack_rebuilds"] = \
                    self.rebuild_stats.get("stack_rebuilds", 0) + 1
        return hit[1]

    def device_stack(self) -> Tuple[kops.IndexOperand, torch.Tensor]:
        """(the index operand, (S, cap) valid mask): over the arena its
        ``operand()`` — the K slabs when sharded — else a cached stack."""
        a = self.arena_view()
        if a is not None:
            return a.operand(), a.device_valid()
        return self._stacked("emb", lambda: (
            torch.stack([m.device_index()[0] for m in self.memories]),
            torch.stack([m.device_index()[1] for m in self.memories])),
            "stack_builds")

    def expand_members(self, draws: torch.Tensor, valid: torch.Tensor,
                       u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reservoir picks of (S, Q, n) draws (``expand_gather``)."""
        a = self.arena_view()
        if a is not None:
            return a.expand_members(draws, valid, u)
        members, counts = self._stacked("members", lambda: tuple(
            torch.stack(t) for t in zip(*[m.device_members()
                                          for m in self.memories])),
            "member_stack_builds")
        return expand_gather(members, counts, draws, valid, u)

    def gather_index_frames(self, draws: torch.Tensor) -> torch.Tensor:
        """Index frame ids of (S, Q, n) draws."""
        a = self.arena_view()
        if a is not None:
            return a.gather_index_frames(draws)
        return gather_rows(self._stacked("index_frame", lambda: torch.stack(
            [m.device_index_frames() for m in self.memories]),
            "index_frame_stack_builds"), draws)

    def search(self, query_emb: torch.Tensor, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_emb (S, Q, d) → (sims, probs) (S, Q, cap): every session
        in ONE dense scan launch. Over the arena the (S, 2) ring windows
        are the valid operand; the mask derives on the device."""
        a = self.arena_view()
        if a is not None:
            return arena_search(a, query_emb, tau)
        emb, valid = self.device_stack()
        return kops.similarity_stack(query_emb, emb, tau=tau, valid=valid)

    def fused_retrieve(self, query_emb: torch.Tensor, targets: torch.Tensor,
                       *, tau: float, n_topk: int) -> kops.FusedRetrieval:
        """ONE fused launch over the stack: draws and top-k resolve inside
        it, no (S, Q, cap) score tensor comes back."""
        a = self.arena_view()
        if a is not None:
            return arena_fused_retrieve(a, query_emb, targets, tau, n_topk)
        emb, valid = self.device_stack()
        return kops.fused_retrieve_stack(query_emb, emb, tau=tau,
                                         valid=valid, targets=targets,
                                         n_topk=n_topk)


def arena_search(a: MemoryArena, query_emb: torch.Tensor, tau: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense stack scan over the arena: its (S, 2) ring windows are
    the valid operand, and a sharded arena scans slab by slab."""
    return kops.similarity_stack(query_emb, a.operand(), tau=tau,
                                 valid=a.device_windows(), mesh=a.mesh,
                                 mesh_axis=a.mesh_axis)


def arena_fused_retrieve(a: MemoryArena, query_emb: torch.Tensor,
                         targets: torch.Tensor, tau: float, n_topk: int
                         ) -> kops.FusedRetrieval:
    """The fused launch over the arena (one a slab when sharded)."""
    return kops.fused_retrieve_stack(
        query_emb, a.operand(), tau=tau, valid=a.device_windows(),
        targets=targets, n_topk=n_topk, mesh=a.mesh, mesh_axis=a.mesh_axis)


class ArenaStackView:
    """The arena AS the stacked scan operand, lanes = arena slots (free
    and virgin slots are masked-out padding lanes). Nothing is built or
    copied."""

    def __init__(self, arena: MemoryArena):
        self.arena = arena
        self.capacity = arena.capacity
        self.dim = arena.dim
        self.member_cap = arena.member_cap
        self.io_stats = {"stack_builds": 0, "member_stack_builds": 0,
                         "index_frame_stack_builds": 0}

    def __len__(self) -> int:
        return self.arena.n_sessions

    def arena_view(self) -> MemoryArena:
        return self.arena

    def device_stack(self) -> Tuple[kops.IndexOperand, torch.Tensor]:
        return self.arena.operand(), self.arena.device_valid()

    def expand_members(self, draws, valid, u):
        return self.arena.expand_members(draws, valid, u)

    def gather_index_frames(self, draws: torch.Tensor) -> torch.Tensor:
        return self.arena.gather_index_frames(draws)

    def search(self, query_emb: torch.Tensor, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return arena_search(self.arena, query_emb, tau)

    def fused_retrieve(self, query_emb: torch.Tensor, targets: torch.Tensor,
                       *, tau: float, n_topk: int) -> kops.FusedRetrieval:
        return arena_fused_retrieve(self.arena, query_emb, targets, tau,
                                    n_topk)
