"""Hierarchical memory, fine tier (paper §IV-C): an index layer over a
raw data layer.

* ``FrameStore`` — the raw data layer: every captured frame, on the host,
  by absolute id (trimmable from the back).
* ``VenusMemory`` — one session's index rows (cluster centroid
  embeddings) with bounded member reservoirs. Host mirrors in numpy are
  authoritative; the device copy lives in a ``MemoryArena`` slot (or, for
  a detached memory, is uploaded from the mirrors when they change).
* ``MemoryArena`` — the device-resident ``(S, capacity, ·)`` super-buffers
  every session's rows live in. A tick's appends land with one in-place
  ``index_put_`` per super-buffer, so the buffers ARE the fused scan's
  operand and no ingest↔query interleaving ever restacks anything.
* ``MemoryStack`` / ``ArenaStackView`` — the stacked scan views: the
  fused retrieval launch and the dense ``search``.

Validity is a ``(head, size)`` ring window per session; the scans take
``(S, 2)`` windows and derive masks on the device. Eviction ``none``
raises on overflow; ``sliding_window`` advances the head (O(1)).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import as_valid_mask
from repro_torch.util import resolve_device


class FrameStore:
    """Raw data layer: host archive of frames by absolute index.
    ``trim(keep_from)`` drops every frame below an absolute id; ids stay
    stable (``base`` offsets the retained list) and reading a trimmed id
    raises ``IndexError``. The disk spill tier is a later slice."""

    def __init__(self):
        self._frames: List[np.ndarray] = []
        self._base = 0

    def append(self, frames: np.ndarray) -> None:
        self._frames.extend(np.asarray(frames))

    def __len__(self) -> int:
        return self._base + len(self._frames)

    @property
    def base(self) -> int:
        return self._base

    def get(self, idx: Sequence[int]) -> np.ndarray:
        out = []
        for i in idx:
            i = int(i)
            if i < self._base:
                raise IndexError(
                    f"frame {i} was trimmed from the archive "
                    f"(retained ids start at {self._base})")
            out.append(self._frames[i - self._base])
        return np.stack(out)

    def trim(self, keep_from: int) -> int:
        drop = max(0, min(int(keep_from), len(self)) - self._base)
        if drop:
            del self._frames[:drop]
            self._base += drop
        return drop

    def close(self) -> None:
        self._frames.clear()


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


_EVICTION_POLICIES = {"none": EvictionPolicy,
                      "sliding_window": SlidingWindowEviction}
_LATER_POLICIES = ("cluster_merge", "consolidate")


def get_eviction_policy(policy) -> EvictionPolicy:
    if isinstance(policy, EvictionPolicy):
        return policy
    if policy in _LATER_POLICIES:
        raise NotImplementedError(
            f"eviction={policy!r} belongs to a later slice of the port "
            f"(ROADMAP.md, Queue 1: memory eviction policies and the "
            f"hierarchical tier)")
    try:
        return _EVICTION_POLICIES[policy]()
    except KeyError:
        raise KeyError(f"unknown eviction policy {policy!r}; known: "
                       f"{sorted(_EVICTION_POLICIES)}") from None


def _index_dtype(index_dtype: str) -> torch.dtype:
    if index_dtype not in ("float32", "int8"):
        raise ValueError(f"index_dtype must be 'float32' or 'int8', got "
                         f"{index_dtype!r}")
    return torch.int8 if index_dtype == "int8" else torch.float32


# ---------------------------------------------------------------------------
# Arena
# ---------------------------------------------------------------------------


class MemoryArena:
    """Shared device-resident super-buffers for S sessions' memories:
    ``emb`` (S, cap, d) f32 or int8 (+ ``emb_scale`` (S, cap) for int8),
    ``members`` (S, cap, K), ``member_count`` and ``index_frame`` (S, cap).

    Slots: ``add_session`` reuses the last released slot (its rows are
    zeroed in place, ``slot_reuses``) or grows every buffer by one slot
    (a copy, ``grows``). Each slot has a ``(head, size)`` window in the
    host mirrors ``heads``/``sizes``; free slots read ``(0, 0)`` and scan
    as masked-out padding.

    Appends: the reference's donated XLA scatters become in-place
    ``index_put_`` writes into the preallocated buffers — one per
    super-buffer per tick inside ``deferred_appends``."""

    def __init__(self, capacity: int, dim: int, member_cap: int = 128,
                 index_dtype: str = "float32", *, device=None):
        self.capacity = capacity
        self.dim = dim
        self.member_cap = member_cap
        self.index_dtype = index_dtype
        self._emb_dtype = _index_dtype(index_dtype)
        self.device = resolve_device(device)
        self.n_sessions = 0
        self.emb: Optional[torch.Tensor] = None
        self.emb_scale: Optional[torch.Tensor] = None
        self.members: Optional[torch.Tensor] = None
        self.member_count: Optional[torch.Tensor] = None
        self.index_frame: Optional[torch.Tensor] = None
        self.sizes = np.zeros((0,), np.int32)
        self.heads = np.zeros((0,), np.int32)
        self.free_slots: List[int] = []
        self.version = 0
        self._windows_dev: Optional[torch.Tensor] = None
        self._valid_dev: Optional[torch.Tensor] = None
        self._valid_version = -1
        self._deferred: Optional[list] = None
        self.io_stats = {"grows": 0, "appends": 0, "appended_rows": 0,
                         "slot_releases": 0, "slot_reuses": 0}

    def reset_io_stats(self) -> None:
        for k in self.io_stats:
            self.io_stats[k] = 0

    def _buffers(self):
        return {"emb": self.emb, "emb_scale": self.emb_scale,
                "members": self.members, "member_count": self.member_count,
                "index_frame": self.index_frame}

    # ------------------------------------------------------------- lifecycle
    def _grow_block(self) -> int:
        slot = self.n_sessions
        s = slot + 1
        cap, d, k = self.capacity, self.dim, self.member_cap
        shapes = {"emb": ((s, cap, d), self._emb_dtype),
                  "members": ((s, cap, k), torch.int32),
                  "member_count": ((s, cap), torch.int32),
                  "index_frame": ((s, cap), torch.int32)}
        if self.index_dtype == "int8":
            shapes["emb_scale"] = ((s, cap), torch.float32)
        for name, (shape, dtype) in shapes.items():
            new = torch.zeros(shape, dtype=dtype, device=self.device)
            old = getattr(self, name)
            if old is not None:
                new[:slot] = old
            setattr(self, name, new)
        self.n_sessions = s
        self.sizes = np.append(self.sizes, np.int32(0))
        self.heads = np.append(self.heads, np.int32(0))
        self.version += 1
        self.io_stats["grows"] += 1
        return slot

    def _recycle(self, slot: int) -> int:
        for buf in self._buffers().values():
            if buf is not None:
                buf[slot].zero_()
        self.sizes[slot] = 0
        self.heads[slot] = 0
        self.version += 1
        self.io_stats["slot_reuses"] += 1
        return slot

    def add_session(self) -> int:
        """Allocate a slot: the last released one (LIFO) or a new one."""
        if self.free_slots:
            return self._recycle(self.free_slots.pop())
        return self._grow_block()

    def release_slot(self, slot: int) -> None:
        assert 0 <= slot < self.n_sessions, slot
        assert slot not in self.free_slots, f"slot {slot} already free"
        self.free_slots.append(slot)
        self.sizes[slot] = 0
        self.heads[slot] = 0
        self.version += 1
        self.io_stats["slot_releases"] += 1

    # ------------------------------------------------------------ ingestion
    @contextlib.contextmanager
    def deferred_appends(self):
        """Batch every ``append`` inside the context into ONE in-place
        write per super-buffer. Re-entrant: the outermost context
        flushes."""
        if self._deferred is not None:
            yield
            return
        self._deferred = []
        try:
            yield
        finally:
            pending, self._deferred = self._deferred, None
            self._flush(pending)

    def append(self, slot: int, pos: int, emb_rows: np.ndarray,
               member_rows: np.ndarray, member_cnts: np.ndarray,
               if_rows: np.ndarray, window: Tuple[int, int]) -> int:
        """Write one session's contiguous row run at ``[slot, pos:pos+n]``
        and record its new ``(head, size)`` window — queued inside a
        ``deferred_appends`` window, else written now. The rows are
        copied: the caller's arrays are views of host mirrors that a later
        ring write may overwrite before the flush."""
        block = (slot, pos, np.array(emb_rows, np.float32),
                 np.array(member_rows, np.int32),
                 np.array(member_cnts, np.int32),
                 np.array(if_rows, np.int32),
                 (int(window[0]), int(window[1])))
        if self._deferred is not None:
            self._deferred.append(block)
            return len(emb_rows)
        return self._flush([block])

    def _flush(self, blocks: list) -> int:
        """One in-place write per super-buffer for all queued blocks. A
        session that wraps inside one tick can hit a (slot, pos) twice;
        only the LAST write per position is kept (index_put_ leaves the
        order of duplicate writes unspecified)."""
        if not blocks:
            return 0
        slots = np.concatenate([np.full(len(b[2]), b[0], np.int64)
                                for b in blocks])
        poss = np.concatenate([np.arange(b[1], b[1] + len(b[2]),
                                         dtype=np.int64) for b in blocks])
        emb_rows = np.concatenate([b[2] for b in blocks])
        mem_rows = np.concatenate([b[3] for b in blocks])
        cnt_rows = np.concatenate([b[4] for b in blocks])
        if_rows = np.concatenate([b[5] for b in blocks])
        lin = slots * self.capacity + poss
        if len(np.unique(lin)) != len(lin):
            last = {v: i for i, v in enumerate(lin)}
            keep = np.sort(np.fromiter(last.values(), np.int64))
            slots, poss = slots[keep], poss[keep]
            emb_rows, mem_rows = emb_rows[keep], mem_rows[keep]
            cnt_rows, if_rows = cnt_rows[keep], if_rows[keep]
        dev = self.device
        sl = torch.from_numpy(slots).to(dev)
        po = torch.from_numpy(poss).to(dev)

        def put(buf, rows):
            buf.index_put_((sl, po), torch.from_numpy(rows).to(dev))

        if self.index_dtype == "int8":
            # quantise ONCE, at the append; scans stream the int8 rows
            emb_rows, scale_rows = quantise_rows(emb_rows)
            put(self.emb_scale, scale_rows)
        put(self.emb, emb_rows)
        put(self.members, mem_rows)
        put(self.member_count, cnt_rows)
        put(self.index_frame, if_rows)
        for slot, _pos, _e, _m, _c, _f, window in blocks:
            self.heads[slot], self.sizes[slot] = window
        self.version += 1
        self.io_stats["appends"] += 1
        self.io_stats["appended_rows"] += len(slots)
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


# ---------------------------------------------------------------------------
# One session's memory
# ---------------------------------------------------------------------------


class VenusMemory:
    """Index layer: packed vector store + cluster member reservoirs."""

    def __init__(self, capacity: int, dim: int, member_cap: int = 128,
                 seed: int = 0, *, arena: Optional[MemoryArena] = None,
                 slot: Optional[int] = None, eviction="none",
                 index_dtype: str = "float32", device=None):
        # the exact integer pick (u * cnt) >> U_BITS must fit in int32
        assert member_cap <= (1 << (31 - U_BITS)), member_cap
        self.capacity = capacity
        self.dim = dim
        self.member_cap = member_cap
        self.eviction = get_eviction_policy(eviction)
        self.index_dtype = index_dtype
        _index_dtype(index_dtype)
        self.arena = arena
        self.slot = slot
        if arena is not None:
            assert slot is not None
            assert arena.index_dtype == index_dtype
            assert (arena.capacity, arena.dim, arena.member_cap) == \
                (capacity, dim, member_cap)
            self.device = arena.device
        else:
            self.device = resolve_device(device)
        self._emb = np.zeros((capacity, dim), np.float32)
        self._members = np.zeros((capacity, member_cap), np.int32)
        self._member_count = np.zeros((capacity,), np.int32)
        self._index_frame = np.zeros((capacity,), np.int32)
        self._size = 0
        self._head = 0
        self._rng = np.random.default_rng(seed)
        self._dev: dict = {}             # detached device copies
        self._dev_version = -1
        self.version = 0
        self.io_stats = {"full_uploads": 0, "appended_rows": 0,
                         "scans": 0, "evicted_rows": 0}

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
        run1 = min(n, self.capacity - tail)
        runs = [(tail, 0, run1)]
        if run1 < n:
            runs.append((0, run1, n - run1))
        for pos, off, cnt in runs:
            self._emb[pos:pos + cnt] = embeddings[off:off + cnt]
            self._index_frame[pos:pos + cnt] = ids[off:off + cnt]
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
        if self.arena is not None:
            for pos, _off, cnt in runs:
                moved = self.arena.append(
                    self.slot, pos, self._emb[pos:pos + cnt],
                    self._members[pos:pos + cnt],
                    self._member_count[pos:pos + cnt],
                    self._index_frame[pos:pos + cnt], self.window)
                self.io_stats["appended_rows"] += moved
        return (tail + np.arange(n)) % self.capacity

    def _advance_head(self, need: int) -> None:
        assert 0 <= need <= self._size, (need, self._size)
        self._head = (self._head + need) % self.capacity
        self._size -= need
        self.io_stats["evicted_rows"] += need

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
        frame or count-masked reservoir member); int64-max when empty."""
        lo = int(np.iinfo(np.int64).max)
        if self._size:
            phys = (self._head + np.arange(self._size)) % self.capacity
            lo = int(self._index_frame[phys].min())
            cnt = self._member_count[phys]
            live = np.arange(self.member_cap)[None, :] < cnt[:, None]
            if live.any():
                lo = min(lo, int(self._members[phys][live].min()))
        return lo

    def detach_from_arena(self) -> None:
        """Sever this memory from its (about to be recycled) arena slot;
        its device views are uploaded from the host mirrors from now on."""
        self.arena = None
        self.slot = None
        self._dev = {}
        self._dev_version = -1

    @staticmethod
    def expand_u(seed: int, size) -> np.ndarray:
        """The per-slot pick variates u ∈ [0, 2^U_BITS): a function of
        (seed, slot) only."""
        return np.random.default_rng(seed).integers(
            0, _U_CARD, size=size, dtype=np.int64)

    # ---------------------------------------------------------- device views
    def _detached(self, name: str) -> torch.Tensor:
        if self._dev_version != self.version:
            emb = (quantise_rows(self._emb)[0]
                   if self.index_dtype == "int8" else self._emb)
            self._dev = {
                "emb": torch.from_numpy(emb).to(self.device),
                "members": torch.from_numpy(self._members).to(self.device),
                "counts": torch.from_numpy(
                    self._member_count).to(self.device),
                "index_frame": torch.from_numpy(
                    self._index_frame).to(self.device)}
            self._dev_version = self.version
            self.io_stats["full_uploads"] += 1
        return self._dev[name]

    def device_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embeddings (cap, d), valid (cap,)) on the device."""
        w = torch.tensor([[self._head, self._size]], dtype=torch.int32,
                         device=self.device)
        valid = as_valid_mask(w, self.capacity)[0]
        if self.arena is not None:
            return self.arena.emb[self.slot], valid
        return self._detached("emb"), valid

    def search(self, query_emb, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_emb (Q, d) → (sims (Q, cap), probs (Q, cap)), Eq. 4+5:
        one 2-D dense scan of this memory's rows."""
        emb, valid = self.device_index()
        self.io_stats["scans"] += 1
        q = torch.as_tensor(query_emb, dtype=torch.float32).to(self.device)
        return kops.similarity(q, emb, tau=tau, valid=valid)

    def device_members(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.arena is not None:
            return (self.arena.members[self.slot],
                    self.arena.member_count[self.slot])
        return self._detached("members"), self._detached("counts")

    def device_index_frames(self) -> torch.Tensor:
        if self.arena is not None:
            return self.arena.index_frame[self.slot]
        return self._detached("index_frame")


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

    def device_stack(self) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.arena_view()
        if a is not None:
            return a.emb, a.device_valid()
        return self._stacked("emb", lambda: (
            torch.stack([m.device_index()[0] for m in self.memories]),
            torch.stack([m.device_index()[1] for m in self.memories])),
            "stack_builds")

    def device_members(self) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.arena_view()
        if a is not None:
            return a.members, a.member_count
        return self._stacked("members", lambda: tuple(
            torch.stack(t) for t in zip(*[m.device_members()
                                          for m in self.memories])),
            "member_stack_builds")

    def device_index_frames(self) -> torch.Tensor:
        a = self.arena_view()
        if a is not None:
            return a.index_frame
        return self._stacked("index_frame", lambda: torch.stack(
            [m.device_index_frames() for m in self.memories]),
            "index_frame_stack_builds")

    def search(self, query_emb: torch.Tensor, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_emb (S, Q, d) → (sims, probs) (S, Q, cap): every session
        in ONE dense scan launch. Over the arena the (S, 2) ring windows
        are the valid operand; the mask derives on the device."""
        a = self.arena_view()
        if a is not None:
            return kops.similarity_stack(query_emb, a.emb, tau=tau,
                                         valid=a.device_windows())
        emb, valid = self.device_stack()
        return kops.similarity_stack(query_emb, emb, tau=tau, valid=valid)

    def fused_retrieve(self, query_emb: torch.Tensor, targets: torch.Tensor,
                       *, tau: float, n_topk: int) -> kops.FusedRetrieval:
        """ONE fused launch over the stack: draws and top-k resolve inside
        it, no (S, Q, cap) score tensor comes back."""
        a = self.arena_view()
        if a is not None:
            return kops.fused_retrieve_stack(
                query_emb, a.emb, tau=tau, valid=a.device_windows(),
                targets=targets, n_topk=n_topk)
        emb, valid = self.device_stack()
        return kops.fused_retrieve_stack(query_emb, emb, tau=tau,
                                         valid=valid, targets=targets,
                                         n_topk=n_topk)


class ArenaStackView:
    """The arena AS the stacked scan operand, lanes = arena slots (free
    slots are masked-out padding lanes). Nothing is built or copied."""

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

    def device_stack(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.arena.emb, self.arena.device_valid()

    def device_members(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.arena.members, self.arena.member_count

    def device_index_frames(self) -> torch.Tensor:
        return self.arena.index_frame

    def search(self, query_emb: torch.Tensor, *, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.arena
        return kops.similarity_stack(query_emb, a.emb, tau=tau,
                                     valid=a.device_windows())

    def fused_retrieve(self, query_emb: torch.Tensor, targets: torch.Tensor,
                       *, tau: float, n_topk: int) -> kops.FusedRetrieval:
        a = self.arena
        return kops.fused_retrieve_stack(
            query_emb, a.emb, tau=tau, valid=a.device_windows(),
            targets=targets, n_topk=n_topk)
