"""Serving engine: prefill/decode with continuous batching, as the
reference's (``repro.serving.engine``):

* a fixed ``batch_slots`` decode batch; each slot holds one in-flight
  request's region of the KV cache, and ``pos`` is (B,), so slots advance
  independently — a finished request frees its slot and a pending one is
  admitted without stalling the others;
* prefill runs at batch 1 over power-of-two right-padded prompt buckets
  (``pow2_bucket(s, lo=16)``; pad keys are masked through
  ``prompt_lengths``), then ``Transformer.insert_slot`` copies its cache
  into the slot in place;
* decoding is greedy, or, with ``temperature > 0``, a Gumbel-max draw
  whose noise comes from the reference's key chain (``kernels.prng``);
* ``timings`` keeps the host-clock seconds of every prefill and decode
  step; each ends where the step reads its tokens back, so the device
  work is in it and no synchronisation is added.

Decode attention runs through ``kernels.ops``: the hand-written decode
kernels on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.kernels import prng
from repro_torch.models.transformer import Transformer
from repro_torch.util import pow2_bucket

PAD = 0
EOS = 2


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                       # (S,) prompt
    max_new_tokens: int = 16
    vision_embeds: Any = None                # (vision_tokens, d) array/tensor
    # arrival time: set by the caller (``VenusService`` stamps it before
    # retrieval) or else by ``ServingEngine.submit``; TTFT counts from it
    submitted_at: Optional[float] = None
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1].to(torch.float32), dim=-1)


class ServingEngine:
    """Continuous batching over a ``Transformer`` (the reference takes
    the config and a parameter tree; the port's parameters live in the
    model)."""

    def __init__(self, model: Transformer, *, batch_slots: int = 4,
                 max_len: int = 1024, temperature: float = 0.0,
                 cache_dtype=torch.bfloat16, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.cache_dtype = cache_dtype
        self._key = prng.key(seed)
        self.cache = model.init_cache(batch_slots, max_len, cache_dtype)
        self.timings = {"prefill": [], "decode": []}
        self._slot_req: List[Optional[Request]] = [None] * batch_slots
        self._pending: List[Request] = []
        self._done: List[Request] = []

    # ----------------------------------------------------------------- steps
    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, self.cache, _ = self.model.apply(tokens, cache=self.cache,
                                                 mode="decode")
        self._key, sub = prng.split(self._key, 2)
        if self.temperature > 0:
            lg = logits[:, -1].to(torch.float32)
            noise = prng.gumbel(sub, lg.numel()).reshape(lg.shape)
            return torch.argmax(lg / self.temperature
                                + torch.from_numpy(noise).to(lg.device), -1)
        return _argmax(logits)

    def _prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor]):
        cache = self.model.init_cache(tokens.shape[0], self.max_len,
                                      self.cache_dtype)
        logits, cache, _ = self.model.apply(
            tokens, vision_embeds=vision_embeds, cache=cache, mode="prefill",
            prompt_lengths=lengths)
        return _argmax(logits), cache

    # ------------------------------------------------------------------ api
    def submit(self, req: Request) -> None:
        if req.submitted_at is None:
            req.submitted_at = time.perf_counter()
        self._pending.append(req)

    def _admit(self) -> None:
        dev = self.device
        for slot in range(self.batch_slots):
            if self._slot_req[slot] is not None or not self._pending:
                continue
            req = self._pending.pop(0)
            toks = np.asarray(req.tokens[-self.max_len:], np.int32)
            s = len(toks)
            buf = np.full((pow2_bucket(s, lo=16),), PAD, np.int32)
            buf[:s] = toks              # right-pad
            ve = None
            if req.vision_embeds is not None:
                ve = torch.as_tensor(req.vision_embeds).to(
                    dev, torch.float32)[None]
            nv = 0 if ve is None else ve.shape[1]
            t0 = time.perf_counter()
            nxt, one_cache = self._prefill(
                torch.from_numpy(buf)[None].to(dev),
                torch.tensor([s + nv], dtype=torch.int32, device=dev), ve)
            self.model.insert_slot(self.cache, one_cache, slot)
            req.generated.append(int(nxt[0]))
            req.first_token_at = time.perf_counter()
            self.timings["prefill"].append(req.first_token_at - t0)
            self._slot_req[slot] = req

    def step(self) -> int:
        """Admit pending requests, run one decode step. Returns the number
        of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.full((self.batch_slots, 1), PAD, np.int32)
        for i in active:
            tokens[i, 0] = self._slot_req[i].generated[-1]
        t0 = time.perf_counter()
        nxt = self._decode(torch.from_numpy(tokens).to(self.device))
        nxt = nxt.cpu().numpy()
        self.timings["decode"].append(time.perf_counter() - t0)
        for i in active:
            r = self._slot_req[i]
            r.generated.append(int(nxt[i]))
            if len(r.generated) >= r.max_new_tokens or int(nxt[i]) == EOS:
                r.finished_at = time.perf_counter()
                self._done.append(r)
                self._slot_req[i] = None
        return len(active)

    def drain(self) -> List[Request]:
        """Step until every pending and in-flight request finishes."""
        while self._pending or any(r is not None for r in self._slot_req):
            self.step()
        done, self._done = self._done, []
        return sorted(done, key=lambda r: r.rid)

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        return self.drain()


# ---------------------------------------------------------------------------
# serve_step / prefill_step: one decode token for the whole slot batch, and
# one batched prefill — the reference's dry-run entry points.
# ---------------------------------------------------------------------------


def make_serve_step(model: Transformer):
    """Returns serve_step(tokens (B,1), cache) -> (next (B,), cache)."""
    def serve_step(tokens, cache):
        logits, new_cache, _ = model.apply(tokens, cache=cache,
                                           mode="decode")
        return _argmax(logits).to(torch.int32), new_cache
    return serve_step


def make_prefill_step(model: Transformer, max_len: int):
    """Returns prefill_step(tokens, vision_embeds=None) -> (last-token
    logits, bf16 cache)."""
    def prefill_step(tokens, vision_embeds=None):
        cache = model.init_cache(tokens.shape[0], max_len, torch.bfloat16)
        logits, cache, _ = model.apply(
            tokens, vision_embeds=(vision_embeds if model.cfg.family == "vlm"
                                   else None),
            cache=cache, mode="prefill")
        return logits, cache
    return prefill_step
