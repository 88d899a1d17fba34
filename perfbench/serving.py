"""What the serving drivers share: the service built and warmed, the
harness's spans around ``VenusService.submit`` and
``ServingEngine.step``, the bookkeeping of every request's tokens (from
which each decode step's contexts follow), and the end of a run: the
comparison's sample copied out, the program freed, the comparison run.

A step admits pending requests (a prefill each) and decodes every slot;
a request whose ``generated`` grew by k in a step decoded k - 1 tokens in
it if it was admitted there, else k, and its decoded token read
``vision + prompt + generated - 1`` keys."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import mix
from perfbench.checks import served as served_check
from perfbench.harness import Record
from perfbench.systems import venus_ingest, vlm_service
from perfbench.trace import Spans
from perfbench.world import derive_seed


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class ServeRun:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.t_build = time.perf_counter()
        self.svc, self.world, self.emb, self.mem_cfg = vlm_service.build(
            cfg, traffic, seed, device)
        _sync(device)
        self.t_built = time.perf_counter()
        self.engine = self.svc.engine
        self.m = cfg
        self.nv = self.m["vision_tokens"]
        self.vocab = self.m["vocab_size"]
        self.seen_upto = (traffic["memory_ticks"]
                          * traffic["cameras"]["chunk_frames"])
        self.spans = Spans()
        self.live: Dict[int, dict] = {}
        self.all: List[dict] = []
        self.steps: List[dict] = []
        self.asked: List[int] = []      # every question's camera, in order
        self._rid = 0

    # ------------------------------------------------------------- calls
    def submit(self, questions) -> List[dict]:
        from repro_torch.serving.venus_service import StreamQuery
        sqs = []
        for q in questions:
            sqs.append(StreamQuery(rid=self._rid, sid=q.sid, text=q.text,
                                   prompt_tokens=q.prompt,
                                   max_new_tokens=q.max_new_tokens))
            self._rid += 1
        a = time.perf_counter()
        reqs = self.svc.submit(sqs)
        b = time.perf_counter()
        self.spans.add("submit", a, b)
        out = []
        for q, sq, r in zip(questions, sqs, reqs):
            e = {"q": q, "sq": sq, "req": r, "submitted": a, "n": 0,
                 "k": len(self.asked)}
            self.asked.append(q.sid)
            self.live[sq.rid] = e
            self.all.append(e)
            out.append(e)
        return out

    def busy(self) -> bool:
        return bool(self.live)

    def step(self) -> None:
        tm = self.engine.timings
        n_dec = len(tm["decode"])
        a = time.perf_counter()
        self.engine.step()
        b = time.perf_counter()
        self.spans.add("engine.step", a, b)
        contexts, prefills, tokens = [], [], 0
        for rid, e in list(self.live.items()):
            r = e["req"]
            n = len(r.generated)
            if n > e["n"]:
                s = len(e["q"].prompt)
                if e["n"] == 0:
                    prefills.append(self.nv + s)
                contexts += [self.nv + s + k for k in range(e["n"] + (
                    1 if e["n"] == 0 else 0), n)]
                tokens += n - e["n"]
                e["n"] = n
            if r.finished_at is not None:
                del self.live[rid]
        self.steps.append({"t0": a, "t1": b, "contexts": contexts,
                           "prefills": prefills, "tokens": tokens,
                           "decode_s": list(tm["decode"][n_dec:])})

    def warm_up(self) -> None:
        """Every prompt bucket the traffic uses, then decode with every
        slot busy; the warm requests are dropped from the books."""
        w = self.traffic["warmup"]
        rng = np.random.default_rng(0)
        qs = [mix.question(self.traffic, self.world, cam % self.world.streams,
                           w["prompt_lengths"][cam % len(w["prompt_lengths"])],
                           w["answer_tokens"], rng, self.vocab,
                           self.seen_upto)
              for cam in range(self.cfg["engine"]["batch_slots"])]
        self.submit(qs)
        while self.busy():
            self.step()
        _sync(self.device)
        print(f"setup: build (MEM, memory ticks, decoder, engine) "
              f"{self.t_built - self.t_build:.3f} s, warm-up "
              f"{time.perf_counter() - self.t_built:.3f} s", file=sys.stderr)
        self.all, self.steps = [], []
        self.spans = Spans()

    # -------------------------------------------------------------- end
    def finish(self, *, setup_s: float, t0: float, t1: float,
               trace, attempted: int, failed: int, obs: dict,
               control: bool = False) -> Record:
        """Read the peak, copy out what the comparison needs, free the
        program, compare."""
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(self.device).type == "cuda" else 0)
        done = [e for e in self.all if e["req"].finished_at is not None
                and e["req"].finished_at <= t1]
        pick = served_check.sample_requests(
            [len(e["req"].generated) for e in done],
            self.traffic["check"]["sample_tokens"], self.seed)
        sample = [{"sid": done[i]["q"].sid,
                   "frame_ids": np.asarray(done[i]["sq"].frame_ids),
                   "vision": done[i]["req"].vision_embeds.float().cpu(),
                   "prompt": np.asarray(done[i]["q"].prompt),
                   "generated": list(done[i]["req"].generated)}
                  for i in pick]
        window = [e for e in self.all if t0 <= e["submitted"] <= t1]
        queries = [self.emb.queries[e["k"]] for e in window]
        rng = np.random.default_rng(derive_seed("retrieval-sample", self.seed))
        n = min(self.traffic["check"]["sample_retrievals"], len(window))
        asked = [{"k": window[i]["k"], "sid": window[i]["q"].sid,
                  "query": queries[i][1],
                  "frame_ids": np.asarray(window[i]["sq"].frame_ids)}
                 for i in sorted(rng.choice(len(window), n, replace=False))]
        mgr = self.svc.manager
        rows = {s: venus_ingest.stored_rows(mgr, s) for s in mgr.sessions}
        retrieval = {"asked": asked, "order": list(self.asked), "rows": rows,
                     "memory": self.mem_cfg["memory"]}
        obs.update(steps=self.steps, nv=self.nv,
                   queries_embedded=len(queries))
        world, spans = self.world, self.spans
        for e in self.all:
            e["req"].vision_embeds = None
        self.svc = self.engine = self.emb = None
        self.live, self.all = {}, []
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        checks = served_check.checks(self.cfg, self.mem_cfg, world, sample,
                                     queries, retrieval, self.seed,
                                     self.device, self.traffic, control)
        return Record(cfg=self.cfg, traffic=self.traffic, setup_s=setup_s,
                      t0=t0, t1=t1, attempted=attempted, failed=failed,
                      obs=obs, spans=spans, trace=trace,
                      memory_peak_bytes=peak, checks=checks)
