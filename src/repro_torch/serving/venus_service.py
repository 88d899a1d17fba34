"""Multi-tenant edge box: Venus sessions feeding the serving engine, as the
reference's ``repro.serving.venus_service``.

  camera chunks ──ingest_tick──▶ SessionManager (per-stream memories)
  user queries  ──submit──────▶ ONE query plan → retrieved keyframes per
                                stream → patch-embedded into
                                ``Request.vision_embeds`` → engine slots

Queries of one service tick compile to one plan: the planner groups
compatible specs, one fused scan answers a group whatever the number of
streams it spans, and the VLM answers everything under continuous
batching. The scan operand is the manager's grow-in-place arena, so
``io_stats()["stack_rebuilds"]`` stays 0. Standing queries
(``register_standing``) ride the ingest ticks and deliver alerts through
``poll_alerts`` and ``on_alert``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.pipeline import patch_projection, patchify
from repro_torch.core.queryplan import QueryPlan, QuerySpec
from repro_torch.core.session import SessionManager
from repro_torch.core.standing import Alert
from repro_torch.kernels import ops as kops
from repro_torch.serving.engine import Request, ServingEngine


@dataclass
class StreamQuery:
    """A user query against one camera stream."""
    rid: int
    sid: int
    text: str
    prompt_tokens: np.ndarray
    query_emb: Optional[np.ndarray] = None
    budget: Optional[int] = None
    strategy: str = "akr"          # any registered retrieval strategy
    max_new_tokens: int = 12
    # filled by the service
    frame_ids: Optional[np.ndarray] = None

    def to_spec(self) -> QuerySpec:
        return QuerySpec(sid=self.sid, text=self.text,
                         embedding=self.query_emb,
                         strategy=self.strategy, budget=self.budget)


class VenusService:
    """Session manager + serving engine behind one submission API."""

    def __init__(self, manager: SessionManager, engine: ServingEngine, *,
                 max_frames: int = 4, patch: int = 8):
        self.manager = manager
        self.engine = engine
        self.max_frames = max_frames
        self.patch = patch
        self._proj: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- ingestion
    def create_stream(self, sid: Optional[int] = None, *,
                      eviction: Optional[str] = None) -> int:
        """Open a camera stream (recycles a freed arena slot when one
        exists); ``eviction`` picks this stream's memory policy."""
        return self.manager.create_session(sid, eviction=eviction)

    def close_stream(self, sid: int) -> Dict[str, int]:
        """End a camera stream and free its arena slot for the next
        ``create_stream``. Returns the stream's final ingest stats."""
        return self.manager.close_session(sid)

    def ingest_tick(self, chunks: Mapping[int, np.ndarray]
                    ) -> Dict[str, float]:
        return self.manager.ingest_tick(chunks)

    def flush(self) -> None:
        self.manager.flush()

    # --------------------------------------------------------------- serving
    def _vision_embeds(self, sid: int, frame_ids: np.ndarray
                       ) -> torch.Tensor:
        """Retrieved raw frames → the VLM's prefix vision tokens
        (vision_tokens, d_model) f32 on the engine's device: the first
        ``max_frames`` frames patchified with the reference's seeded
        projection, cut or zero-padded to ``vision_tokens`` rows."""
        cfg = self.engine.cfg
        dev = self.engine.device
        out = torch.zeros((cfg.vision_tokens, cfg.d_model),
                          dtype=torch.float32, device=dev)
        if len(frame_ids) == 0:
            return out
        if self._proj is None:
            self._proj = torch.from_numpy(patch_projection(
                self.patch, cfg.d_model)).to(dev)
        frames = self.manager[sid].frames.get(frame_ids[: self.max_frames])
        pe = patchify(torch.from_numpy(frames).to(dev), self.patch,
                      self._proj).reshape(-1, cfg.d_model)
        pe = pe[: cfg.vision_tokens]
        out[: pe.shape[0]] = pe
        return out

    def plan(self, queries: Sequence[StreamQuery]) -> QueryPlan:
        """The retrieval plan one service tick compiles to (``plan.n_scans``
        == number of fused scans)."""
        return self.manager.plan([q.to_spec() for q in queries])

    def submit(self, queries: Sequence[StreamQuery]) -> List[Request]:
        """Compile the tick's queries into ONE plan, retrieve, build the
        VLM requests and enqueue them on the engine in arrival order.
        Every request's ``submitted_at`` is the moment this call began, so
        its TTFT covers retrieval and the vision tokens too. The call is
        the span ``service.submit`` (its requests' ``rids``, the number
        of ``questions``)."""
        with obs.span("service.submit", rids=tuple(q.rid for q in queries),
                      questions=len(queries)) as sp:
            results = self.manager.execute(self.plan(queries))
            reqs: List[Request] = []
            for q, res in zip(queries, results):
                q.frame_ids = res.frame_ids
                req = Request(
                    rid=q.rid, tokens=np.asarray(q.prompt_tokens, np.int32),
                    max_new_tokens=q.max_new_tokens,
                    vision_embeds=self._vision_embeds(q.sid, res.frame_ids),
                    submitted_at=sp.t0)
                reqs.append(req)
                self.engine.submit(req)
        return reqs

    def answer(self, queries: Sequence[StreamQuery]) -> List[Request]:
        """Submit and drain: run engine steps until every slot is free."""
        self.submit(queries)
        return self.engine.drain()

    # ------------------------------------------------------ standing queries
    def register_standing(self, sid: int, query, *, threshold: float,
                          hysteresis: float = 0.0, cooldown_ticks: int = 0,
                          priority: float = 0.0) -> int:
        """Register a persistent trigger on a stream, evaluated in every
        ``ingest_tick`` against that tick's new memory rows (one slab
        launch, ``kops_standing_scan_bytes``). ``query`` is a
        ``QuerySpec`` or a ``StreamQuery``; returns the spec id."""
        spec = query.to_spec() if isinstance(query, StreamQuery) else query
        return self.manager.register_standing(
            sid, spec, threshold=threshold, hysteresis=hysteresis,
            cooldown_ticks=cooldown_ticks, priority=priority)

    def poll_alerts(self, max_alerts: Optional[int] = None) -> List[Alert]:
        """Drain pending alerts: priority desc, score desc, tick, firing
        order."""
        return self.manager.poll_alerts(max_alerts)

    def on_alert(self, callback) -> None:
        """``callback(alert)`` runs once per fired alert, in priority order
        within an ingest tick; alerts stay pollable."""
        self.manager.standing.on_alert(callback)

    # ------------------------------------------------------------ monitoring
    def io_stats(self) -> Dict[str, int]:
        """One monitoring surface over the service, with the reference's
        key set: the manager's counters, ``standing_specs``, ``kops_*``
        (the dispatch layer's scan counts, process-global), ``arena_*``,
        ``mem_*`` (per-memory counters summed over live and closed
        sessions), the spill counters (``spilled_frames``,
        ``spilled_bytes``, ``spill_faults``, ``spill_cache_hits``, summed
        over live and closed sessions) and the gauge ``spill_disk_bytes``
        (bytes in live sessions' segments). The invariants to alert on:
        ``stack_rebuilds == 0``, and ``kops_standing_scan_bytes`` growing
        O(new rows · d) a tick. A sharded arena
        (``SessionManager(mesh=...)``) adds ``arena_shards`` (the mesh
        ``model`` axis size its slots are slabbed over),
        ``sharded_group_scans`` (query groups whose scan ran once a
        slab), ``kops_sharded_stack_launches`` (the same at the kernel
        layer) and ``kops_shard_gather_bytes`` (the bytes of the
        per-slab outputs brought to the first device: O(S·Q·(T+K))
        fused, no O(S·Q·capacity) term); double buffering adds
        ``arena_double_flushes`` and ``arena_carry_rows``."""
        out: Dict[str, int] = dict(self.manager.io_stats)
        out["standing_specs"] = self.manager.standing.n_specs
        for k, v in kops.scan_counts().items():
            out[f"kops_{k}"] = v
        if self.manager.arena is not None:
            for k, v in self.manager.arena.io_stats.items():
                out[f"arena_{k}"] = v
            out["arena_shards"] = self.manager.arena.n_shards
        mem_sums = dict(self.manager.closed_mem_stats)
        for st in self.manager.sessions.values():
            for k, v in st.memory.io_stats.items():
                mem_sums[k] = mem_sums.get(k, 0) + v
        for k, v in mem_sums.items():
            out[f"mem_{k}"] = v
        frame_sums = dict(self.manager.closed_frame_stats)
        disk_bytes = 0
        for st in self.manager.sessions.values():
            for k, v in st.frames.io_stats.items():
                frame_sums[k] = frame_sums.get(k, 0) + v
            disk_bytes += st.frames.disk_bytes
        out.update(frame_sums)
        out["spill_disk_bytes"] = disk_bytes
        return out
