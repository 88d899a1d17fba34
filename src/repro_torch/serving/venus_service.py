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
``io_stats()["stack_rebuilds"]`` stays 0. Standing queries belong to a
later slice of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.pipeline import patch_projection, patchify
from repro_torch.core.queryplan import QueryPlan, QuerySpec
from repro_torch.core.session import SessionManager
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


# the reference's spill-tier counters (frame stores and disk): the spill
# tier is a later slice, so they read 0, as the reference's do with no
# spill_dir
_SPILL_KEYS = ("spilled_frames", "spilled_bytes", "spill_faults",
               "spill_cache_hits", "spill_disk_bytes")


def _standing_later() -> NotImplementedError:
    return NotImplementedError(
        "standing queries belong to a later slice of the port "
        "(ROADMAP.md, Queue 1 item 9)")


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
        its TTFT covers retrieval and the vision tokens too."""
        arrived = time.perf_counter()
        results = self.manager.execute(self.plan(queries))
        reqs: List[Request] = []
        for q, res in zip(queries, results):
            q.frame_ids = res.frame_ids
            req = Request(
                rid=q.rid, tokens=np.asarray(q.prompt_tokens, np.int32),
                max_new_tokens=q.max_new_tokens,
                vision_embeds=self._vision_embeds(q.sid, res.frame_ids),
                submitted_at=arrived)
            reqs.append(req)
            self.engine.submit(req)
        return reqs

    def answer(self, queries: Sequence[StreamQuery]) -> List[Request]:
        """Submit and drain: run engine steps until every slot is free."""
        self.submit(queries)
        return self.engine.drain()

    # ------------------------------------------------------ standing queries
    def register_standing(self, *args, **kwargs) -> int:
        raise _standing_later()

    def poll_alerts(self, *args, **kwargs):
        raise _standing_later()

    def on_alert(self, callback) -> None:
        raise _standing_later()

    # ------------------------------------------------------------ monitoring
    def io_stats(self) -> Dict[str, int]:
        """One monitoring surface over the service, with the reference's
        key set: the manager's counters, ``standing_specs``, ``kops_*``
        (the dispatch layer's scan counts, process-global), ``arena_*``,
        ``mem_*`` (per-memory counters summed over live and closed
        sessions) and the spill counters. The invariant to alert on:
        ``stack_rebuilds == 0``. Standing queries, sharding and the spill
        tier are later slices: their keys read 0, as the reference's do
        with the feature off."""
        out: Dict[str, int] = dict(self.manager.io_stats)
        out["standing_specs"] = 0
        for k, v in kops.scan_counts().items():
            out[f"kops_{k}"] = v
        if self.manager.arena is not None:
            for k, v in self.manager.arena.io_stats.items():
                out[f"arena_{k}"] = v
            out["arena_shards"] = 1
        mem_sums = dict(self.manager.closed_mem_stats)
        for st in self.manager.sessions.values():
            for k, v in st.memory.io_stats.items():
                mem_sums[k] = mem_sums.get(k, 0) + v
        for k, v in mem_sums.items():
            out[f"mem_{k}"] = v
        out.update(dict.fromkeys(_SPILL_KEYS, 0))
        return out
