"""Standing queries: persistent triggers evaluated on the ingest path.

A query registered once (``SessionManager.register_standing``) is
evaluated inside every ingest tick against only the rows that tick
committed, and fires an ``Alert`` when the best new row reaches its
threshold:

* ``StandingRegistry`` — the manager's registry of standing
  ``QuerySpec``s, each with a firing ``threshold``, a re-arm
  ``hysteresis`` band, a ``cooldown_ticks`` debounce and a delivery
  ``priority``;
* ``evaluate`` — called by ``commit_jobs`` with the physical arena rows
  each session's inserts landed in. It gathers only those rows from the
  host mirrors into a ``(G, pow2(n), d)`` slab (int8 indexes re-quantise
  it with ``quantise_rows``, the arena's own rows bit for bit), uploads
  it to the manager's device and makes ONE fused retrieval launch over it
  (``kops.fused_retrieve_stack(tier="standing")``, kernel #1 on the
  card), so ``standing_scan_bytes`` grows O(new rows · d) a tick, never
  O(capacity · d);
* ``Alert`` — delivered priority-ordered (priority desc, score desc,
  tick, firing order) through ``poll_alerts`` and ``on_alert`` callbacks.

Determinism contract: a standing score and its frame ids are bit for bit
what an ad-hoc ``topk`` plan over the same rows gives. Top-k scores are
masked cosines, and every route scores a row by arithmetic that depends
only on the row and the query (not on N, Q, the slot or the grid; see
``csrc/scan_tile.cuh``), and a top-k prefix is stable under a larger k.
Standing evaluation never draws, so it consumes no session PRNG chain.

Trigger state, per spec, stepped only on ticks that committed rows for its
session (``_trigger_step``, over every evaluated spec at once):

    cooldown = max(cooldown - 1, 0)
    crossed  = score >= threshold
    fire     = crossed and armed and cooldown == 0
               → emit Alert, armed = False, cooldown = cooldown_ticks
    crossed and not fire → alerts_suppressed += 1
    score <= threshold - hysteresis → armed = True
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.memory import quantise_rows
from repro_torch.core.queryplan import QuerySpec, build_plan
from repro_torch.kernels import ops as kops
from repro_torch.util import pow2_bucket, resolve_device

# masked top-k slots carry -1e30; anything above this is a scored row
_VALID_SCORE = -1e29
# the stages of ``evaluate``, each the span ``standing.<stage>``, whose
# seconds ``StandingRegistry.seconds`` adds up
STAGES = ("slab", "upload", "launch", "readback", "trigger")


@dataclass
class Alert:
    """One firing. ``frame_ids`` are the new rows' index-frame ids at or
    above the threshold, in rank order, at most the spec's budget;
    ``score`` is the best new row's cosine; ``tick`` the registry's count
    of committing ticks."""
    sid: int
    spec_id: int
    frame_ids: np.ndarray
    score: float
    tick: int
    priority: float = 0.0


@dataclass
class StandingEntry:
    """A registered standing query and its trigger state."""
    spec_id: int
    sid: int
    spec: QuerySpec                 # validated
    embedding: np.ndarray           # (d,) f32 query embedding
    budget: int                     # frame_ids cap (the resolved k)
    threshold: float
    hysteresis: float
    cooldown_ticks: int
    priority: float
    armed: bool = True
    cooldown: int = 0


def _trigger_step(score, armed, cooldown, threshold, hysteresis,
                  cooldown_ticks):
    """Threshold crossing, hysteresis and cooldown of every evaluated spec
    at once: (L,) tensors in → (fire, suppressed, armed', cooldown')."""
    cd = torch.clamp(cooldown - 1, min=0)
    crossed = score >= threshold
    fire = crossed & armed & (cd == 0)
    suppressed = crossed & ~fire
    rearm = score <= threshold - hysteresis
    armed_out = torch.where(fire, torch.zeros_like(armed), armed | rearm)
    cd_out = torch.where(fire, cooldown_ticks, cd)
    return fire, suppressed, armed_out, cd_out


def _pow2(n: int) -> int:
    """Next power of two ≥ max(n, 1): slab shapes come in O(log) sizes,
    each within 2× of the rows it holds."""
    return pow2_bucket(int(n))


class StandingRegistry:
    """A manager's standing queries and their alert queue. All state is on
    the host; a committing tick costs one slab launch and the trigger
    step, on ``device``. ``seconds`` adds up the durations of
    ``evaluate``'s stage spans (``standing.<stage>`` for each of
    ``STAGES``)."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.entries: Dict[int, StandingEntry] = {}
        self.by_sid: Dict[int, List[int]] = {}
        self._next_id = 0
        self._seq = 0               # tie-break of the heap
        self.tick = 0               # committing ticks seen (Alert.tick)
        self._heap: List = []       # (-prio, -score, tick, seq, Alert)
        self._callbacks: List[Callable[[Alert], None]] = []
        self.seconds = dict.fromkeys(STAGES, 0.0)

    # ---------------------------------------------------------- registration
    @property
    def n_specs(self) -> int:
        return len(self.entries)

    def register(self, sid: int, spec: QuerySpec, embedding: np.ndarray,
                 *, threshold: float, hysteresis: float = 0.0,
                 cooldown_ticks: int = 0, priority: float = 0.0,
                 sessions: Optional[Mapping[int, object]] = None) -> int:
        """Validate and register one spec (``build_plan(standing=True)``,
        which resolves its budget as an ad-hoc plan would); returns its
        id."""
        if not np.isfinite(threshold):
            raise ValueError(f"threshold must be finite, got {threshold}")
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        if cooldown_ticks < 0:
            raise ValueError(
                f"cooldown_ticks must be >= 0, got {cooldown_ticks}")
        spec = replace(spec, sid=int(sid))
        key = build_plan([spec], self.cfg, sessions=sessions,
                         standing=True).groups[0].key
        spec_id = self._next_id
        self._next_id += 1
        self.entries[spec_id] = StandingEntry(
            spec_id=spec_id, sid=int(sid), spec=spec,
            embedding=np.asarray(embedding, np.float32).reshape(-1),
            budget=int(key.budget), threshold=float(threshold),
            hysteresis=float(hysteresis), cooldown_ticks=int(cooldown_ticks),
            priority=float(priority))
        self.by_sid.setdefault(int(sid), []).append(spec_id)
        return spec_id

    def unregister(self, spec_id: int) -> None:
        e = self.entries.pop(spec_id)
        self.by_sid[e.sid].remove(spec_id)
        if not self.by_sid[e.sid]:
            del self.by_sid[e.sid]

    def drop_session(self, sid: int) -> int:
        """Remove every spec on ``sid`` (a recycled slot's next tenant
        inherits no trigger); alerts already fired stay pollable."""
        ids = list(self.by_sid.get(int(sid), ()))
        for spec_id in ids:
            self.unregister(spec_id)
        return len(ids)

    # --------------------------------------------------------------- alerts
    def on_alert(self, callback: Callable[[Alert], None]) -> None:
        """``callback(alert)`` runs once per fired alert, in priority order
        within a tick, right after the tick's evaluation; alerts stay
        pollable."""
        self._callbacks.append(callback)

    def poll_alerts(self, max_alerts: Optional[int] = None) -> List[Alert]:
        """Drain up to ``max_alerts`` pending alerts: priority desc, score
        desc, tick, firing order."""
        out: List[Alert] = []
        while self._heap and (max_alerts is None or len(out) < max_alerts):
            out.append(heapq.heappop(self._heap)[-1])
        return out

    @property
    def pending_alerts(self) -> int:
        return len(self._heap)

    # ------------------------------------------------------------ evaluation
    def evaluate(self, sessions: Mapping[int, object],
                 new_by_sid: Mapping[int, Sequence[np.ndarray]],
                 io_stats: Optional[Dict[str, int]] = None) -> List[Alert]:
        """Evaluate every spec against only the tick's new rows:
        ``new_by_sid`` maps sid → the physical-row arrays ``insert_batch``
        returned this tick, in commit order (the slab keeps that order, so
        top-k ties break as in an ad-hoc scan of the same rows). Returns
        the alerts fired (already queued and delivered)."""
        self.tick += 1
        live = [(sid, new_by_sid[sid]) for sid in sorted(new_by_sid)
                if self.by_sid.get(sid)
                and sum(len(p) for p in new_by_sid[sid])]
        if not live:
            return []
        stage = [obs.span(f"standing.{name}") for name in STAGES]
        with stage[0]:
            # --- the (G, pow2(n), d) slab of new rows, from the host mirrors
            d = len(next(iter(self.entries.values())).embedding)
            ents = [[self.entries[i] for i in self.by_sid[sid]]
                    for sid, _ in live]
            phys = [np.concatenate([np.asarray(p, np.int64) for p in plist])
                    for _, plist in live]
            g = len(live)
            n_pad = _pow2(max(len(p) for p in phys))
            q_pad = _pow2(max(len(e) for e in ents))
            k = min(n_pad, max(e.budget for es in ents for e in es))
            slab = np.zeros((g, n_pad, d), np.float32)
            q_stack = np.zeros((g, q_pad, d), np.float32)
            sizes = np.zeros((g,), np.int32)
            ifr = np.zeros((g, n_pad), np.int64)
            for gi, ((sid, _), p) in enumerate(zip(live, phys)):
                mem = sessions[sid].memory
                slab[gi, :len(p)] = mem._emb[p]
                ifr[gi, :len(p)] = mem._index_frame[p]
                sizes[gi] = len(p)
                for qi, e in enumerate(ents[gi]):
                    q_stack[gi, qi] = e.embedding
            index = slab
            if getattr(self.cfg, "index_dtype", "float32") == "int8":
                # the arena's own int8 rows, bit for bit (scales cancel under
                # the kernel's row normalisation)
                index, _ = quantise_rows(slab)
        with stage[1]:
            dev = self.device
            index_d = torch.from_numpy(index).to(dev)
            q_d = torch.from_numpy(q_stack).to(dev)
            sizes_d = torch.from_numpy(sizes).to(dev)
            targets = torch.zeros((g, q_pad, 1), dtype=torch.float32,
                                  device=dev)
        with stage[2]:
            # --- ONE fused launch over the slab, never the arena
            fr = kops.fused_retrieve_stack(
                q_d, index_d, tau=float(getattr(self.cfg, "tau", 0.1)),
                valid=sizes_d, targets=targets, n_topk=k, tier="standing")
        with stage[3]:
            tv = fr.topk_v.cpu().numpy()          # (G, Q, K) masked cosines
            ti = fr.topk_i.cpu().numpy()          # (G, Q, K) slab rows
        with stage[4]:
            # --- the trigger step over every evaluated spec
            flat = [(gi, qi, e) for gi, es in enumerate(ents)
                    for qi, e in enumerate(es)]
            l_pad = _pow2(len(flat))
            score = np.full((l_pad,), -np.inf, np.float32)
            armed = np.zeros((l_pad,), bool)
            cooldown = np.zeros((l_pad,), np.int32)
            thr = np.full((l_pad,), np.inf, np.float32)
            hys = np.zeros((l_pad,), np.float32)
            cdt = np.zeros((l_pad,), np.int32)
            for li, (gi, qi, e) in enumerate(flat):
                score[li] = tv[gi, qi, 0]
                armed[li] = e.armed
                cooldown[li] = e.cooldown
                thr[li] = e.threshold
                hys[li] = e.hysteresis
                cdt[li] = e.cooldown_ticks
            fire, supp, armed_out, cd_out = (
                x.cpu().numpy() for x in _trigger_step(
                    *(torch.from_numpy(a).to(dev)
                      for a in (score, armed, cooldown, thr, hys, cdt))))
            fired: List[Alert] = []
            n_supp = 0
            for li, (gi, qi, e) in enumerate(flat):
                e.armed = bool(armed_out[li])
                e.cooldown = int(cd_out[li])
                n_supp += int(supp[li])
                if not fire[li]:
                    continue
                kk = min(e.budget, k)
                vals = tv[gi, qi, :kk]
                sel = (vals >= e.threshold) & (vals > _VALID_SCORE)
                fired.append(Alert(
                    sid=e.sid, spec_id=e.spec_id,
                    frame_ids=ifr[gi, ti[gi, qi, :kk][sel]],
                    score=float(tv[gi, qi, 0]), tick=self.tick,
                    priority=e.priority))
        for name, sp in zip(STAGES, stage):
            self.seconds[name] += sp.seconds
        if io_stats is not None:
            io_stats["alerts_fired"] = (io_stats.get("alerts_fired", 0)
                                        + len(fired))
            io_stats["alerts_suppressed"] = (
                io_stats.get("alerts_suppressed", 0) + n_supp)
        for a in sorted(fired, key=lambda a: (-a.priority, -a.score)):
            heapq.heappush(self._heap,
                           (-a.priority, -a.score, a.tick, self._seq, a))
            self._seq += 1
            for cb in self._callbacks:
                cb(a)
        return fired
