"""The Venus system: online ingestion + querying (paper Fig. 6), the
single-stream façade over one ``SessionManager`` session.

Ingestion (①–④): chunks → scene segmentation → incremental clustering
→ index frames → embedding → memory insert. Querying (⑤–⑦): the fused
retrieval scan (Eq. 4–5), sampling or AKR (Eq. 5–7) or top-k, and the
expansion of draws into raw frames from the cluster reservoirs.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.queryplan import QueryPlan, QuerySpec
from repro_torch.core.session import (QueryResult, SessionManager,
                                      SessionState, VenusConfig)

__all__ = ["VenusConfig", "QueryResult", "QuerySpec", "QueryPlan",
           "VenusSystem", "SessionManager", "SessionState"]


class VenusSystem:
    def __init__(self, cfg: VenusConfig, embedder, embed_dim: int, *,
                 device=None):
        self.cfg = cfg
        self.embedder = embedder
        self.manager = SessionManager(cfg, embedder, embed_dim,
                                      device=device)
        self.sid = self.manager.create_session()

    @property
    def _session(self) -> SessionState:
        return self.manager[self.sid]

    @property
    def memory(self):
        return self._session.memory

    @property
    def frames(self):
        return self._session.frames

    @property
    def stats(self) -> Dict[str, int]:
        return self._session.stats

    @property
    def segmenter(self):
        return self._session.segmenter

    def ingest(self, chunk: np.ndarray) -> Dict[str, float]:
        """Consume a chunk of frames (T,H,W,3); returns stage timings."""
        t = self.manager.ingest_tick({self.sid: chunk})
        return {"segment": t["segment"],
                "cluster_embed": t["cluster"] + t["embed_insert"]}

    def flush(self) -> None:
        self.manager.flush([self.sid])

    def plan(self, specs: Sequence[QuerySpec]) -> QueryPlan:
        """Group specs (pinned to this system's session)."""
        return self.manager.plan([replace(s, sid=self.sid) for s in specs])

    def execute(self, plan: QueryPlan) -> List[QueryResult]:
        return self.manager.execute(plan)

    def query_specs(self, specs: Sequence[QuerySpec]) -> List[QueryResult]:
        return self.execute(self.plan(specs))

    def query(self, text: str, *, budget: Optional[int] = None,
              use_akr: bool = True, query_emb: Optional[np.ndarray] = None
              ) -> QueryResult:
        """budget set ⇒ fixed-N sampling (§IV-D1); otherwise AKR."""
        return self.manager.query(self.sid, text, budget=budget,
                                  use_akr=use_akr, query_emb=query_emb)

    def query_batch(self, texts: Optional[Sequence[str]] = None, *,
                    query_embs: Optional[np.ndarray] = None,
                    budget: Optional[int] = None, use_akr: bool = True
                    ) -> List[QueryResult]:
        return self.manager.query_batch(self.sid, texts,
                                        query_embs=query_embs,
                                        budget=budget, use_akr=use_akr)

    def query_topk(self, text: str, k: int,
                   query_emb: Optional[np.ndarray] = None) -> np.ndarray:
        return self.manager.query_topk(self.sid, text, k,
                                       query_emb=query_emb)
