"""Declarative query plans: ``QuerySpec`` → ``build_plan`` → executor.

* **QuerySpec** — one query against one session: text or embedding,
  strategy, budget, per-query ``tau``/``theta``/``beta``, and a seed
  policy (``seed=None`` consumes the session's PRNG chain; an int
  derives a detached key).
* **build_plan** — groups compatible specs into ``ExecutionGroup``s
  (same strategy + resolved budget + parameters).
* **execute_plan** — ONE fused retrieval launch per group
  (``kops.fused_retrieve_stack``): draws, drawn probabilities and top-k
  resolve inside the launch, then AKR's stop rule, the reservoir
  expansion or the index-frame gather run on the device.

The registry holds the three strategies the fused launch answers:
``sampling`` and ``akr`` (expand through the member reservoirs) and
``topk`` (expand through the index_frame table). The dense strategies
(BOLT, MDF, AKS, uniform) and ``fused=False`` belong to the next slice.

PRNG discipline: within a group, lanes are visited in scan-lane order and
each session's chain advances by exactly its own chain-policy query
count; padding lanes get ``split(key(0), qmax - len)`` keys — the same
keys, hence the same targets, as the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import retrieval as rt
from repro_torch.core.memory import VenusMemory, expand_gather
from repro_torch.kernels import prng

_LATER = ("uniform", "bolt", "mdf", "aks")


@dataclass(frozen=True)
class QuerySpec:
    """One query against one session. ``budget`` is the draw count for
    sampling, k for top-k and n_max for AKR; ``None`` → ``cfg.n_max``."""
    sid: int
    text: Optional[str] = None
    embedding: Optional[np.ndarray] = None
    strategy: str = "akr"
    budget: Optional[int] = None
    tau: Optional[float] = None
    theta: Optional[float] = None
    beta: Optional[float] = None
    seed: Optional[int] = None


class GroupKey(NamedTuple):
    strategy: str
    budget: int
    tau: float
    theta: float
    beta: float


@dataclass(frozen=True)
class RetrievalStrategy:
    """A retrieval rule the fused launch answers. ``expand`` says how its
    draws become frame ids: ``members`` (reservoir picks) or ``index``
    (the slot's index frame)."""
    name: str
    stochastic: bool              # consumes the session PRNG chain
    expand: str                   # "members" | "index"


_REGISTRY: Dict[str, RetrievalStrategy] = {}


def register_strategy(strategy: RetrievalStrategy) -> RetrievalStrategy:
    assert strategy.name not in _REGISTRY, strategy.name
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> RetrievalStrategy:
    if name in _LATER:
        raise NotImplementedError(
            f"strategy {name!r} needs the dense similarity scan, which is "
            f"the next slice of the port (ROADMAP.md, Queue 2 items 3-4)")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown retrieval strategy {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


register_strategy(RetrievalStrategy("sampling", stochastic=True,
                                    expand="members"))
register_strategy(RetrievalStrategy("akr", stochastic=True,
                                    expand="members"))
register_strategy(RetrievalStrategy("topk", stochastic=False,
                                    expand="index"))


@dataclass
class ExecutionGroup:
    """One padded execution block: ONE fused scan answers every spec."""
    strategy: RetrievalStrategy
    key: GroupKey
    indices: List[int] = field(default_factory=list)   # spec positions
    order: Dict[int, List[int]] = field(default_factory=dict)

    @property
    def sids(self) -> Tuple[int, ...]:
        return tuple(sorted(self.order))

    @property
    def qmax(self) -> int:
        return max(len(v) for v in self.order.values())

    def describe(self) -> str:
        k = self.key
        return (f"{k.strategy}(budget={k.budget}, tau={k.tau:g}, "
                f"theta={k.theta:g}, beta={k.beta:g}) "
                f"sessions={list(self.sids)} queries={len(self.indices)}")


@dataclass
class QueryPlan:
    specs: List[QuerySpec]
    groups: List[ExecutionGroup]

    @property
    def n_scans(self) -> int:
        """Fused scan launches this plan costs — one per group."""
        return len(self.groups)

    def describe(self) -> str:
        lines = [f"QueryPlan: {len(self.specs)} specs -> "
                 f"{len(self.groups)} groups ({self.n_scans} scans)"]
        lines += [f"  group {i}: {g.describe()}"
                  for i, g in enumerate(self.groups)]
        return "\n".join(lines)


def build_plan(specs: Sequence[QuerySpec], cfg) -> QueryPlan:
    """Group compatible specs; groups come in first-appearance order,
    each session's queries keep arrival order. ``cfg`` supplies the
    ``tau``/``theta``/``beta``/``n_max`` defaults."""
    specs = list(specs)
    groups: Dict[GroupKey, ExecutionGroup] = {}
    for j, spec in enumerate(specs):
        if spec.text is None and spec.embedding is None:
            raise ValueError(f"spec {j}: needs text or embedding")
        strat = get_strategy(spec.strategy)
        key = GroupKey(
            strategy=strat.name,
            budget=int(spec.budget if spec.budget is not None
                       else cfg.n_max),
            tau=float(spec.tau if spec.tau is not None else cfg.tau),
            theta=float(spec.theta if spec.theta is not None
                        else cfg.theta),
            beta=float(spec.beta if spec.beta is not None else cfg.beta))
        g = groups.get(key)
        if g is None:
            g = groups[key] = ExecutionGroup(strategy=strat, key=key)
        g.indices.append(j)
        g.order.setdefault(int(spec.sid), []).append(j)
    return QueryPlan(specs=specs, groups=list(groups.values()))


@dataclass
class QueryResult:
    frame_ids: np.ndarray          # selected raw-frame ids (deduplicated
    #                                for reservoir strategies, rank order
    #                                for top-k)
    draws: np.ndarray              # index draws
    n_drawn: int
    mass: float
    timings: Dict[str, float]


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def execute_plan(manager, plan: QueryPlan, *, fused: bool = True
                 ) -> List[QueryResult]:
    """Run every group: ONE fused scan launch each. Results come back in
    the plan's spec order."""
    if not fused:
        raise NotImplementedError(
            "fused=False runs the dense similarity scan, which is the next "
            "slice of the port (ROADMAP.md, Queue 2 items 3-4)")
    specs = plan.specs
    results: List[Optional[QueryResult]] = [None] * len(specs)
    t0 = time.perf_counter()
    missing = [j for j, s in enumerate(specs) if s.embedding is None]
    embedded: Dict[int, np.ndarray] = {}
    if missing:
        embs = manager.embedder.embed_queries(
            [specs[j].text for j in missing])
        embedded = {j: np.asarray(embs[i], np.float32)
                    for i, j in enumerate(missing)}
    t_embed = time.perf_counter() - t0
    for group in plan.groups:
        _execute_group(manager, group, specs, embedded, results, t_embed)
    return results


def _group_keys(manager, group: ExecutionGroup, specs, qmax, lanes
                ) -> np.ndarray:
    """Key rows (L, qmax, 2) over the scan's lanes: chain-policy queries
    consume their session's chain in arrival order, explicit seeds derive
    detached keys, padding gets ``split(key(0), qmax - len)``."""
    rows = []
    for sid in lanes:
        idxs = group.order.get(sid, ())
        n_chain = sum(1 for j in idxs if specs[j].seed is None)
        chain = (manager.sessions[sid].next_keys(n_chain)
                 if n_chain else None)
        ks, ci = [], 0
        for j in idxs:
            if specs[j].seed is None:
                ks.append(chain[ci])
                ci += 1
            else:
                ks.append(prng.key(int(specs[j].seed)))
        if len(ks) < qmax:
            ks.extend(prng.split(prng.key(0), qmax - len(ks)))
        rows.append(np.stack(ks))
    return np.stack(rows)


def _execute_group(manager, group: ExecutionGroup, specs, embedded,
                   results, t_embed: float) -> None:
    cfg = manager.cfg
    dev = manager.device
    strat = group.strategy
    k = group.key
    sids = group.sids
    lanes = manager.scan_lanes(sids)
    lane_of = {sid: si for si, sid in enumerate(lanes) if sid is not None}
    ln, qmax = len(lanes), group.qmax
    timings: Dict[str, float] = {"embed_query": t_embed}

    q_stack = np.zeros((ln, qmax, manager.embed_dim), np.float32)
    for sid in sids:
        for qi, j in enumerate(group.order[sid]):
            spec = specs[j]
            q_stack[lane_of[sid], qi] = (
                np.asarray(spec.embedding, np.float32)
                if spec.embedding is not None else embedded[j])

    # --- the ONE fused launch of this group ------------------------------
    t0 = time.perf_counter()
    if strat.stochastic:
        keys = _group_keys(manager, group, specs, qmax, lanes)
        targets = rt.targets_from_keys(keys, k.budget, dev)
    else:           # top-k ignores the draw epilogue: one dummy target
        targets = torch.zeros((ln, qmax, 1), dtype=torch.float32,
                              device=dev)
    n_topk = k.budget if strat.name == "topk" else 1
    stack = manager.memory_stack(lanes)
    fr = stack.fused_retrieve(torch.from_numpy(q_stack).to(dev), targets,
                              tau=k.tau, n_topk=n_topk)
    if len(sids) == 1:   # single-session group: per-session accounting
        manager.io_stats["scans"] += 1
        manager.sessions[sids[0]].memory.io_stats["scans"] += 1
    else:
        manager.io_stats["fused_scans"] += 1
    manager.io_stats["group_scans"] += 1
    timings["similarity"] = time.perf_counter() - t0

    # --- strategy post-processing + expansion ----------------------------
    t0 = time.perf_counter()
    sq = (ln, qmax)
    if strat.name == "topk":
        draws = fr.topk_i
        table = stack.device_index_frames()
        sidx = torch.arange(ln, device=dev)[:, None, None]
        fids = table[sidx, draws.long().clamp(0, table.shape[1] - 1)]
        ok = torch.ones(draws.shape, dtype=torch.bool, device=dev)
        n_drawn, mass = np.full(sq, draws.shape[-1]), np.full(sq, np.nan)
    else:
        u = torch.from_numpy(VenusMemory.expand_u(cfg.seed, k.budget)
                             ).to(dev)
        members, counts = stack.device_members()
        if strat.name == "sampling":
            draws = fr.draws
            valid = torch.ones(draws.shape, dtype=torch.bool, device=dev)
            n_drawn, mass = np.full(sq, k.budget), np.full(sq, np.nan)
        else:                                               # akr
            akr = rt.akr_from_draws(fr.draws, fr.drawn_p, fr.p_max[..., 0],
                                    theta=k.theta, beta=k.beta,
                                    n_max=k.budget)
            draws, valid = akr.draws, akr.valid
            n_drawn = akr.n_drawn.cpu().numpy()
            mass = akr.mass.cpu().numpy()
        fids, ok = expand_gather(members, counts, draws, valid, u)
        manager.io_stats["device_expands"] += 1
    fids_np, ok_np = fids.cpu().numpy(), ok.cpu().numpy()
    draws_np = draws.cpu().numpy()
    timings["sample_expand"] = time.perf_counter() - t0

    for sid in sids:
        si = lane_of[sid]
        for qi, j in enumerate(group.order[sid]):
            lane = fids_np[si, qi][ok_np[si, qi]].astype(np.int64)
            if strat.expand == "members":       # reservoir picks: dedup
                lane = np.unique(lane)
            results[j] = QueryResult(
                frame_ids=lane, draws=draws_np[si, qi],
                n_drawn=int(n_drawn[si, qi]), mass=float(mass[si, qi]),
                timings=dict(timings))
