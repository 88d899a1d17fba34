"""Session layer: multi-stream, batch-first Venus (paper Fig. 6 at scale).

Per-stream stages over a ``SessionState``:

* ``segment_stage`` — chunk → closed scene partitions (①, scene-score
  kernel on the card);
* ``cluster_stage`` — one closed partition → an ``EmbedJob`` with its
  index frames and cluster membership (②–③);
* ``commit_jobs`` — every job closed in a tick, across all sessions, in
  ONE embed call, then inserted with one in-place write per arena
  super-buffer (④).

``SessionManager`` owns the streams, the embedder and the
``MemoryArena``; queries are planned (``plan``) and executed
(``execute``) with ONE scan launch per execution group over the arena
buffers — the fused retrieval scan, or the dense scan for the
baselines and ``fused=False`` — so ``io_stats["stack_rebuilds"]``
stays 0.

Entry points take ``device=``: CUDA by default, raising when there is no
card; ``device="cpu"`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.clustering import cluster_partition, frame_vectors
from repro_torch.core.memory import (ArenaStackView, FrameStore, MemoryArena,
                                     MemoryStack, VenusMemory)
from repro_torch.core.queryplan import (QueryPlan, QueryResult, QuerySpec,
                                        build_plan, execute_plan)
from repro_torch.core.scene import Partition, StreamSegmenter
from repro_torch.kernels import prng
from repro_torch.util import resolve_device

_LIVE_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()


def reset_all_io_stats() -> None:
    """Reset the io_stats of every live ``SessionManager`` (test
    isolation: launch-count assertions must not depend on test order)."""
    for mgr in list(_LIVE_MANAGERS):
        mgr.reset_io_stats()


@dataclass(frozen=True)
class VenusConfig:
    """The reference's fields and defaults. The spill tier, the coarse
    tier and the merging eviction policies are later slices: their fields
    are accepted and rejected when set."""
    # ingestion
    scene_threshold: float = 0.075
    max_partition_len: int = 256
    cluster_threshold: float = 0.35
    max_clusters_per_partition: int = 16
    cluster_pool: int = 8
    # memory
    memory_capacity: int = 8192
    member_cap: int = 128
    index_dtype: str = "float32"
    eviction: str = "none"
    merge_threshold: Optional[float] = None
    coarse_capacity: int = 0
    coarse_block: int = 64
    coarse_topb: int = 4
    spill_dir: Optional[str] = None
    spill_segment_frames: int = 64
    spill_cache_segments: int = 4
    host_retain: Optional[int] = None
    # querying (Eq. 5-7)
    tau: float = 0.1
    theta: float = 0.9
    beta: float = 1.0
    n_max: int = 32
    seed: int = 0

    def __post_init__(self):
        later = {"spill_dir": self.spill_dir is not None,
                 "host_retain": self.host_retain is not None,
                 "coarse_capacity": self.coarse_capacity != 0,
                 "merge_threshold": self.merge_threshold is not None,
                 "eviction": self.eviction not in ("none",
                                                   "sliding_window")}
        set_later = [k for k, v in later.items() if v]
        if set_later:
            raise NotImplementedError(
                f"VenusConfig fields {set_later} belong to later slices of "
                f"the port (ROADMAP.md, Queue 1: hierarchical tier, spill "
                f"tier, eviction policies)")
        if self.index_dtype not in ("float32", "int8"):
            raise ValueError(f"index_dtype must be 'float32' or 'int8', "
                             f"got {self.index_dtype!r}")


@dataclass
class EmbedJob:
    """One closed partition's index frames awaiting embedding."""
    sid: int
    scene_id: int
    frames: torch.Tensor                     # (n, H, W, 3) index frames
    frame_ids: np.ndarray                    # (n,) absolute frame ids
    member_lists: List[np.ndarray]           # per-cluster member frame ids


class SessionState:
    """Per-stream state: segmenter, pending frames, archive, memory and
    the PRNG chain (threefry key data, bit-equal to the reference's)."""

    def __init__(self, sid: int, cfg: VenusConfig, embed_dim: int,
                 arena: Optional[MemoryArena] = None,
                 slot: Optional[int] = None,
                 eviction: Optional[str] = None, device=None):
        self.sid = sid
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segmenter = StreamSegmenter(
            threshold=cfg.scene_threshold,
            max_partition_len=cfg.max_partition_len)
        self.memory = VenusMemory(cfg.memory_capacity, embed_dim,
                                  cfg.member_cap, seed=cfg.seed,
                                  arena=arena, slot=slot,
                                  eviction=(cfg.eviction if eviction
                                            is None else eviction),
                                  index_dtype=cfg.index_dtype,
                                  device=self.device)
        self.frames = FrameStore()
        # frames not yet clustered, on the device (views of the chunks)
        self.pending: List[torch.Tensor] = []
        self.pending_base = 0
        self.key = prng.key(cfg.seed)
        self.stats = {"frames_seen": 0, "frames_embedded": 0,
                      "partitions": 0, "clusters": 0,
                      "frames_trimmed": 0}

    def next_keys(self, n: int) -> np.ndarray:
        """Advance the PRNG chain n steps → (n, 2) subkeys: the same
        chain n single queries consume."""
        subs = []
        for _ in range(n):
            self.key, sub = prng.split(self.key)
            subs.append(sub)
        return np.stack(subs)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def segment_stage(state: SessionState, chunk: np.ndarray) -> List[Partition]:
    """① archive the chunk (host), score and segment it (device)."""
    chunk = np.asarray(chunk, np.float32)
    state.frames.append(chunk)
    state.stats["frames_seen"] += len(chunk)
    dev_chunk = torch.from_numpy(chunk).to(state.device)
    closed = state.segmenter.ingest(dev_chunk)
    state.pending.extend(dev_chunk.unbind(0))
    return closed


def cluster_stage(state: SessionState, part: Partition) -> EmbedJob:
    """②–③ incremental clustering of one closed partition → embed job."""
    cfg = state.cfg
    lo = part.start - state.pending_base
    hi = part.end - state.pending_base
    pframes = torch.stack(state.pending[lo:hi])
    vecs = frame_vectors(pframes, cfg.cluster_pool)
    res = cluster_partition(vecs, threshold=cfg.cluster_threshold,
                            max_clusters=cfg.max_clusters_per_partition)
    n = int(res.n_clusters)
    assign = res.assignments.cpu().numpy()
    index_local = res.index_frames[:n].cpu().numpy()
    scene_id = state.stats["partitions"]
    members = [part.start + np.nonzero(assign == c)[0] for c in range(n)]
    state.stats["partitions"] += 1
    state.stats["clusters"] += n
    return EmbedJob(sid=state.sid, scene_id=scene_id,
                    frames=pframes[torch.from_numpy(index_local).long()
                                   .to(pframes.device)],
                    frame_ids=part.start + index_local,
                    member_lists=members)


def release_pending(state: SessionState, closed: List[Partition]) -> None:
    if closed:
        consumed = closed[-1].end - state.pending_base
        state.pending = state.pending[consumed:]
        state.pending_base = closed[-1].end


def commit_jobs(sessions: Mapping[int, SessionState], embedder,
                jobs: Sequence[EmbedJob]) -> int:
    """④ ONE embed call over every index frame closed this tick, inserted
    into each owning session's memory; arena-backed sessions share one
    in-place write per super-buffer for the whole tick."""
    if not jobs:
        return 0
    incoming: Dict[int, int] = {}
    for j in jobs:
        incoming[j.sid] = incoming.get(j.sid, 0) + len(j.frame_ids)
    for sid, n_new in incoming.items():
        mem = sessions[sid].memory
        if mem.eviction.name == "none" and mem.size + n_new > mem.capacity:
            raise RuntimeError(
                f"session {sid}: memory full ({mem.size} rows + {n_new} "
                f"incoming > capacity {mem.capacity}) — enable eviction "
                f"(VenusConfig(eviction='sliding_window'))")
    frames = torch.cat([j.frames for j in jobs])
    ids = np.concatenate([j.frame_ids for j in jobs])
    embs = np.asarray(embedder.embed_frames(frames, None, frame_ids=ids),
                      np.float32)
    arenas = {id(a): a for a in
              (sessions[j.sid].memory.arena for j in jobs) if a is not None}
    with contextlib.ExitStack() as stack:
        for a in arenas.values():
            stack.enter_context(a.deferred_appends())
        off = 0
        for j in jobs:
            n = len(j.frame_ids)
            st = sessions[j.sid]
            st.memory.insert_batch(
                embs[off:off + n], scene_ids=[j.scene_id] * n,
                index_frames=j.frame_ids, member_lists=j.member_lists)
            st.stats["frames_embedded"] += n
            off += n
    return len(ids)


# ---------------------------------------------------------------------------
# Session manager
# ---------------------------------------------------------------------------


class SessionManager:
    """N concurrent streams sharing one embedder and one memory arena."""

    def __init__(self, cfg: VenusConfig, embedder, embed_dim: int, *,
                 use_arena: bool = True, device=None):
        self.cfg = cfg
        self.embedder = embedder
        self.embed_dim = embed_dim
        self.device = resolve_device(device)
        self.sessions: Dict[int, SessionState] = {}
        self._next_sid = 0
        self._stacks: Dict[Tuple[int, ...], MemoryStack] = {}
        self.use_arena = use_arena
        self.arena: Optional[MemoryArena] = None
        self._arena_stack: Optional[ArenaStackView] = None
        # the reference's keys; sharding, the coarse tier and standing
        # queries are not ported yet, so their counters stay 0
        self.io_stats = {"scans": 0, "fused_scans": 0,
                         "device_expands": 0, "group_scans": 0,
                         "stack_rebuilds": 0, "sessions_closed": 0,
                         "sharded_group_scans": 0,
                         "two_stage_groups": 0,
                         "archive_trimmed_frames": 0,
                         "alerts_fired": 0, "alerts_suppressed": 0}
        # closed sessions' memory counters, so service-wide sums stay
        # monotonic across stream churn
        self.closed_mem_stats: Dict[str, int] = {}
        _LIVE_MANAGERS.add(self)

    def reset_io_stats(self, *, include_memories: bool = True) -> None:
        for k in self.io_stats:
            self.io_stats[k] = 0
        if include_memories:
            self.closed_mem_stats.clear()
            for st in self.sessions.values():
                st.memory.reset_io_stats()
            if self.arena is not None:
                self.arena.reset_io_stats()

    # ------------------------------------------------------------- lifecycle
    def create_session(self, sid: Optional[int] = None, *,
                       eviction: Optional[str] = None) -> int:
        """Open a stream; arena mode allocates (or recycles) a slot.
        ``eviction`` overrides ``cfg.eviction`` for this session."""
        if sid is None:
            sid = self._next_sid
        assert sid not in self.sessions, sid
        self._next_sid = max(self._next_sid, sid) + 1
        arena = slot = None
        if self.use_arena:
            if self.arena is None:
                self.arena = MemoryArena(
                    self.cfg.memory_capacity, self.embed_dim,
                    self.cfg.member_cap, index_dtype=self.cfg.index_dtype,
                    device=self.device)
            arena, slot = self.arena, self.arena.add_session()
        self.sessions[sid] = SessionState(sid, self.cfg, self.embed_dim,
                                          arena=arena, slot=slot,
                                          eviction=eviction,
                                          device=self.device)
        return sid

    def close_session(self, sid: int) -> Dict[str, int]:
        """End a stream and free its arena slot for reuse (no device
        work now; the slot's rows are zeroed when it is recycled).
        Returns the session's final ingest stats."""
        st = self.sessions.pop(sid)
        for k, v in st.memory.io_stats.items():
            self.closed_mem_stats[k] = self.closed_mem_stats.get(k, 0) + v
        st.frames.close()
        self._stacks = {k: v for k, v in self._stacks.items()
                        if sid not in k}
        if self.arena is not None:
            slot = st.memory.slot
            st.memory.detach_from_arena()
            self.arena.release_slot(slot)
        self.io_stats["sessions_closed"] += 1
        return dict(st.stats)

    def __getitem__(self, sid: int) -> SessionState:
        return self.sessions[sid]

    def __len__(self) -> int:
        return len(self.sessions)

    # ------------------------------------------------------------- ingestion
    def ingest_tick(self, chunks: Mapping[int, np.ndarray]
                    ) -> Dict[str, float]:
        """Consume one chunk per stream; embed everything that closed
        across ALL streams in one batched call. Returns stage timings
        (host clock; each stage ends in a device→host read, so the device
        work of the stage is inside it)."""
        t0 = time.perf_counter()
        closed_by_sid = {sid: segment_stage(self.sessions[sid], chunk)
                         for sid, chunk in chunks.items()}
        t_seg = time.perf_counter()
        jobs: List[EmbedJob] = []
        for sid, closed in closed_by_sid.items():
            st = self.sessions[sid]
            for part in closed:
                jobs.append(cluster_stage(st, part))
            release_pending(st, closed)
        t_clu = time.perf_counter()
        n_emb = commit_jobs(self.sessions, self.embedder, jobs)
        n_trim = self._trim_archives(chunks.keys())
        t_emb = time.perf_counter()
        return {"segment": t_seg - t0, "cluster": t_clu - t_seg,
                "embed_insert": t_emb - t_clu, "embedded": float(n_emb),
                "trimmed": float(n_trim)}

    def flush(self, sids: Optional[Sequence[int]] = None) -> None:
        """Close every open partition and embed the remainder batched."""
        jobs: List[EmbedJob] = []
        sids = list(sids if sids is not None else self.sessions)
        for sid in sids:
            st = self.sessions[sid]
            for part in st.segmenter.flush():
                jobs.append(cluster_stage(st, part))
            st.pending = []
            st.pending_base = st.stats["frames_seen"]
        commit_jobs(self.sessions, self.embedder, jobs)
        self._trim_archives(sids)

    def _trim_archives(self, sids) -> int:
        """Drop host frames below every live reference of a window-
        evicting session (its ring window's index frames and reservoirs,
        and the frames awaiting clustering). ``eviction="none"`` sessions
        keep everything."""
        trimmed = 0
        for sid in sids:
            st = self.sessions[sid]
            if st.memory.eviction.name == "none":
                continue
            n = st.frames.trim(min(st.memory.min_live_frame(),
                                   st.pending_base))
            if n:
                st.stats["frames_trimmed"] += n
                trimmed += n
        self.io_stats["archive_trimmed_frames"] += trimmed
        return trimmed

    # -------------------------------------------------------------- querying
    def plan(self, specs: Sequence[QuerySpec]) -> QueryPlan:
        """Group specs; strategy ↔ session compatibility is checked
        here (``uniform`` against a window-evicting session raises)."""
        return build_plan(specs, self.cfg, self.sessions)

    def execute(self, plan: QueryPlan, *, fused: bool = True
                ) -> List[QueryResult]:
        """Run a plan: ONE scan launch per group (``fused=False`` sends
        sampling/AKR/top-k groups through the dense scan too)."""
        return execute_plan(self, plan, fused=fused)

    def query_specs(self, specs: Sequence[QuerySpec]) -> List[QueryResult]:
        return self.execute(self.plan(specs))

    @staticmethod
    def _legacy_strategy(budget: Optional[int], use_akr: bool) -> str:
        return "sampling" if (budget is not None and not use_akr) else "akr"

    def query(self, sid: int, text: str, *, budget: Optional[int] = None,
              use_akr: bool = True, query_emb: Optional[np.ndarray] = None
              ) -> QueryResult:
        """Single query (budget set ⇒ fixed-N sampling; else AKR)."""
        return self.query_specs([QuerySpec(
            sid=sid, text=text, embedding=query_emb,
            strategy=self._legacy_strategy(budget, use_akr),
            budget=budget)])[0]

    def query_batch(self, sid: int, texts: Optional[Sequence[str]] = None,
                    *, query_embs: Optional[np.ndarray] = None,
                    budget: Optional[int] = None, use_akr: bool = True
                    ) -> List[QueryResult]:
        """Q same-session queries → one group → ONE scan."""
        n = len(query_embs) if query_embs is not None else len(texts)
        return self.query_batch_cross(
            [sid] * n, texts, query_embs=query_embs, budget=budget,
            use_akr=use_akr)

    def query_batch_cross(self, sids: Sequence[int],
                          texts: Optional[Sequence[str]] = None, *,
                          query_embs: Optional[np.ndarray] = None,
                          budget: Optional[int] = None,
                          use_akr: bool = True,
                          strategy: Optional[str] = None
                          ) -> List[QueryResult]:
        """Queries against several sessions through ONE scan;
        ``sids[j]`` is query j's session. ``strategy`` overrides the
        budget/use_akr rule with any registered strategy (``"topk"``,
        ``"bolt"``, ``"mdf"``, ``"aks"``, ``"uniform"``, …)."""
        sids = [int(s) for s in sids]
        strategy = strategy or self._legacy_strategy(budget, use_akr)
        if query_embs is not None:
            qe = np.asarray(query_embs, np.float32)
            assert len(sids) == qe.shape[0]
            specs = [QuerySpec(sid=s, embedding=qe[j], strategy=strategy,
                               budget=budget)
                     for j, s in enumerate(sids)]
        else:
            assert len(sids) == len(texts)
            specs = [QuerySpec(sid=s, text=t, strategy=strategy,
                               budget=budget)
                     for s, t in zip(sids, texts)]
        return self.query_specs(specs)

    MAX_CACHED_STACKS = 8

    def scan_lanes(self, sids: Sequence[int]) -> Tuple[Optional[int], ...]:
        """The lanes one fused scan covers: every arena slot in slot
        order (``None`` for a free slot), or exactly ``sids`` detached."""
        if self.arena is not None:
            by_slot = {st.memory.slot: s
                       for s, st in self.sessions.items()}
            return tuple(by_slot.get(k)
                         for k in range(self.arena.n_sessions))
        return tuple(sids)

    def memory_stack(self, lanes: Tuple[Optional[int], ...]):
        """The scan view over ``lanes``: the arena itself when a lane is
        a free slot, else a cached ``MemoryStack`` (which aliases the
        arena buffers when it covers the arena)."""
        if any(s is None for s in lanes):
            assert self.arena is not None
            if (self._arena_stack is None
                    or self._arena_stack.arena is not self.arena):
                self._arena_stack = ArenaStackView(self.arena)
            return self._arena_stack
        stk = self._stacks.pop(lanes, None)
        if stk is None:
            stk = MemoryStack([self.sessions[s].memory for s in lanes],
                              rebuild_stats=self.io_stats)
            while len(self._stacks) >= self.MAX_CACHED_STACKS:
                self._stacks.pop(next(iter(self._stacks)))
        self._stacks[lanes] = stk
        return stk

    def query_topk(self, sid: int, text: str, k: int,
                   query_emb: Optional[np.ndarray] = None) -> np.ndarray:
        res = self.query_specs([QuerySpec(
            sid=sid, text=text, embedding=query_emb, strategy="topk",
            budget=k)])[0]
        return res.frame_ids
