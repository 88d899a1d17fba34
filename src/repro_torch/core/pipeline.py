"""The Venus system: online ingestion + querying (paper Fig. 6), the
single-stream façade over one ``SessionManager`` session, and the MEM
embedder.

Ingestion (①–④): chunks → scene segmentation → incremental clustering
→ index frames → MEM embedding → memory insert. Querying (⑤–⑦): embed
the query, the retrieval scan (Eq. 4–5), sampling, AKR (Eq. 5–7) or a
baseline, and the expansion of draws into raw frames.

The embedder is pluggable: ``MEMEmbedder`` (the dual-tower MEM behind a
stub patchifier), or ``data.video``'s ``OracleEmbedder`` and
``PixelEmbedder``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aux_models import AuxModel
from repro_torch.core.queryplan import QueryPlan, QuerySpec
from repro_torch.core.session import (QueryResult, SessionManager,
                                      SessionState, VenusConfig)
from repro_torch.data.text import tokenize_batch
from repro_torch.models.mem import MEM

__all__ = ["patch_projection", "patchify", "MEMEmbedder", "VenusConfig",
           "QueryResult", "QuerySpec", "QueryPlan", "VenusSystem",
           "SessionManager", "SessionState"]


# ---------------------------------------------------------------------------
# MEM embedder
# ---------------------------------------------------------------------------


def patch_projection(patch: int, d_vision: int, seed: int = 11
                     ) -> np.ndarray:
    """The frontend stub's fixed projection (patch²·3, d_vision): numpy
    ``default_rng(seed)`` normals of scale 1/sqrt(patch²·3), the
    reference's own numbers."""
    k = patch * patch * 3
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0 / np.sqrt(k), (k, d_vision)).astype(np.float32)


def patchify(frames: torch.Tensor, patch: int, proj: torch.Tensor
             ) -> torch.Tensor:
    """Frontend stub: frames (B,H,W,3) → patch embeddings (B,P,d_vision),
    each raw patch (row-major patches, (y, x, c) inside one) times
    ``proj`` in f32."""
    b, h, w, c = frames.shape
    ph, pw = h // patch, w // patch
    x = frames[:, : ph * patch, : pw * patch].reshape(
        b, ph, patch, pw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, ph * pw, patch * patch * c)
    return x.to(torch.float32) @ proj


# Frames per vision-tower call: the f32 attention logits are heads × P² ×
# 4 bytes per frame and layer (39 MB at venus-mem-large and 224²), so 32
# frames keep a call's working set to a few GB.
MICRO_BATCH = 32


class MEMEmbedder:
    """Adapter: Venus pipeline ↔ the dual-tower MEM. Frames are embedded
    in micro-batches of ``MICRO_BATCH``; the projection of the patchifier
    is built once, on the model's device."""

    def __init__(self, mem: MEM, *, patch: int = 8, text_max_len: int = 32):
        self.mem = mem
        self.patch = patch
        self.text_max_len = text_max_len
        self.device = mem.device
        self._proj = torch.from_numpy(patch_projection(
            patch, mem.cfg.vision.d_model)).to(self.device)

    def _encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        toks, mask = tokenize_batch(list(texts), self.mem.cfg.text.vocab_size,
                                    self.text_max_len)
        return self.mem.encode_text(torch.from_numpy(toks).to(self.device),
                                    torch.from_numpy(mask).to(self.device))

    @torch.no_grad()
    def embed_frames(self, frames, aux_texts: Optional[Sequence[str]] = None,
                     frame_ids=None) -> np.ndarray:
        """frames (B,H,W,3) in [0,1] (array or tensor) → (B, embed_dim)
        f32 unit rows. With ``aux_texts`` each row becomes
        unit(img + 0.3·txt)."""
        frames = torch.as_tensor(frames).to(self.device, torch.float32)
        img = torch.cat([
            self.mem.encode_image(patchify(frames[i:i + MICRO_BATCH],
                                           self.patch, self._proj))
            for i in range(0, frames.shape[0], MICRO_BATCH)])
        if aux_texts and any(aux_texts):
            mix = img + 0.3 * self._encode_texts(aux_texts)
            m32 = mix.to(torch.float32)
            img = m32 / torch.linalg.vector_norm(m32, dim=-1, keepdim=True)
        return img.to(torch.float32).cpu().numpy()

    @torch.no_grad()
    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        """Q query texts in one text-tower call → (Q, embed_dim) f32."""
        return self._encode_texts(texts).to(torch.float32).cpu().numpy()

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_queries([text])[0]


# ---------------------------------------------------------------------------
# Venus system — single-stream façade over one managed session
# ---------------------------------------------------------------------------


class VenusSystem:
    def __init__(self, cfg: VenusConfig, embedder, embed_dim: int,
                 aux_models: Sequence[AuxModel] = (), annotation_fn=None,
                 *, device=None):
        self.cfg = cfg
        self.embedder = embedder
        self.manager = SessionManager(cfg, embedder, embed_dim,
                                      aux_models=aux_models,
                                      annotation_fn=annotation_fn,
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

    def execute(self, plan: QueryPlan, *, fused: bool = True
                ) -> List[QueryResult]:
        return self.manager.execute(plan, fused=fused)

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
