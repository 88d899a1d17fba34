"""Declarative query plans: ``QuerySpec`` → ``build_plan`` → executor.

* **QuerySpec** — one query against one session: text or embedding,
  strategy, budget, per-query ``tau``/``theta``/``beta``, and a seed
  policy (``seed=None`` consumes the session's PRNG chain; an int
  derives a detached key).
* **build_plan** — groups compatible specs into ``ExecutionGroup``s
  (same strategy + resolved budget + parameters) and, given the
  sessions, rejects ``uniform`` against a window-evicting session
  without a spill tier; ``standing=True`` validates a standing query.
* **execute_plan** — ONE scan launch per group. Sampling, AKR and top-k
  groups take the fused retrieval launch (``kops.fused_retrieve_stack``):
  draws, drawn probabilities and top-k resolve inside it. BOLT, MDF, AKS
  and uniform consume dense scores or embeddings, so their groups take
  the dense ``stack.search`` launch (``kops.similarity_stack``);
  ``fused=False`` sends every group there. Both give the same frame
  ids: the dense path draws with the same canonical CDF over the same
  probabilities. Once the arena's coarse tier holds a consolidated row, a
  fused group runs the two-stage retrieval instead (``tiering``: a coarse
  scan, then a scan of the winners' gathered candidates); ``coarse=False``
  keeps the flat scan. Over a sharded arena a group's scan runs once a
  slab (``sharded_group_scans``), and the reservoir and index-frame
  gathers read each slot from its slab.

Strategies live in a registry (``register_strategy`` / ``get_strategy``)
behind one batched interface over ``(S, Q, cap)`` scan outputs. Each
declares how its draws become frame ids: ``members`` (reservoir picks:
sampling, AKR), ``index`` (the slot's index frame: top-k, BOLT, MDF,
AKS) or ``raw`` (draws are frame ids: uniform).

PRNG discipline: within a group, lanes are visited in scan-lane order and
each session's chain advances by exactly its own chain-policy query
count; padding lanes get ``split(key(0), qmax - len)`` keys — the same
keys, hence the same targets, as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import retrieval as rt
from repro_torch.core import tiering
from repro_torch.core.memory import VenusMemory
from repro_torch.kernels import prng


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


def build_plan(specs: Sequence[QuerySpec], cfg,
               sessions: Optional[Mapping[int, object]] = None, *,
               standing: bool = False) -> QueryPlan:
    """Group compatible specs; groups come in first-appearance order,
    each session's queries keep arrival order. ``cfg`` supplies the
    ``tau``/``theta``/``beta``/``n_max`` defaults. Given ``sessions``
    (sid → session state, the ``SessionManager.plan`` path), ``uniform``
    against a window-evicting session without a spill tier is rejected
    here: it draws arbitrary archive frame ids, and such a session's
    trimmed frames are gone (with spill they fault back from disk).

    ``standing=True`` validates a standing query at registration
    (``core.standing``): the key resolves exactly as an ad-hoc plan's,
    but only deterministic strategies resolved inside the fused launch
    (``topk``) are taken, and no explicit ``seed`` (standing evaluation
    never draws)."""
    specs = list(specs)
    groups: Dict[GroupKey, ExecutionGroup] = {}
    for j, spec in enumerate(specs):
        if spec.text is None and spec.embedding is None:
            raise ValueError(f"spec {j}: needs text or embedding")
        strat = get_strategy(spec.strategy)
        if standing:
            if strat.stochastic or strat.name not in _FUSED_STRATEGIES:
                raise ValueError(
                    f"spec {j}: strategy {strat.name!r} cannot run as a "
                    f"standing query — the ingest-path evaluation is "
                    f"deterministic and resolves inside the fused "
                    f"launch, so only non-stochastic fused strategies "
                    f"('topk') are accepted (stochastic strategies "
                    f"would consume the session PRNG chain per ingest "
                    f"tick)")
            if spec.seed is not None:
                raise ValueError(
                    f"spec {j}: standing queries never draw, so an "
                    f"explicit seed has no effect — pass seed=None")
        if strat.name == "uniform" and sessions is not None:
            st = sessions.get(int(spec.sid))
            policy = st.memory.eviction.name if st is not None else "none"
            if policy != "none" and not st.frames.spill_enabled:
                raise ValueError(
                    f"spec {j}: strategy 'uniform' draws arbitrary "
                    f"archive frame ids, but session {spec.sid} evicts "
                    f"with policy '{policy}' and has no spill tier — "
                    f"its trimmed frames are deleted, so uniform reads "
                    f"would IndexError in FrameStore.get. Use a "
                    f"members-expanding strategy, keep the session on "
                    f"eviction='none', or set VenusConfig(spill_dir=..."
                    f") so trimmed frames demote to disk and fault "
                    f"back in.")
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


# ---------------------------------------------------------------------------
# Strategy registry: every retrieval.py selection rule, batched
# ---------------------------------------------------------------------------


class StrategyContext(NamedTuple):
    """Everything a strategy may post-process after the ONE dense scan."""
    sims: torch.Tensor            # (S, Q, cap) cosine similarities
    probs: torch.Tensor           # (S, Q, cap) temperature softmax
    valid: torch.Tensor           # (S, cap) per-session slot validity
    emb: Union[torch.Tensor, List[torch.Tensor]]  # (S, cap, d) index
    #                               embedding stack, or a sharded arena's
    #                               K slabs of it
    keys: Optional[np.ndarray]    # (S, Q, 2) key data (stochastic only)
    total_frames: np.ndarray      # (S,) raw frames seen per session
    key: GroupKey                 # resolved strategy/budget/params
    qcount: np.ndarray            # (S,) real (non-padding) queries


class StrategyOutput(NamedTuple):
    draws: torch.Tensor           # (S, Q, n) int32 — see strategy.expand
    valid: torch.Tensor           # (S, Q, n) bool — slot actually drawn
    n_drawn: np.ndarray           # (S, Q) int
    mass: np.ndarray              # (S, Q) float (nan if undefined)


@dataclass(frozen=True)
class RetrievalStrategy:
    """A retrieval rule behind the common batched interface: ``run``
    post-processes the dense scan outputs into draws, which the executor
    expands as ``expand`` says. (The reference's ``run_expand`` fused the
    selection and the reservoir gather into one jit program; run eagerly,
    the two steps are the same launches either way.)"""
    name: str
    stochastic: bool              # consumes the session PRNG chain
    expand: str                   # "members" | "index" | "raw"
    run: Callable[[StrategyContext], StrategyOutput]

    def __post_init__(self):
        if self.expand not in ("members", "index", "raw"):
            raise ValueError(f"unknown expand kind {self.expand!r}")


_REGISTRY: Dict[str, RetrievalStrategy] = {}


def register_strategy(strategy: RetrievalStrategy) -> RetrievalStrategy:
    if strategy.name in _REGISTRY:
        raise ValueError(f"strategy {strategy.name!r} already registered")
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> RetrievalStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown retrieval strategy {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def _fill(sq, n_drawn) -> Tuple[np.ndarray, np.ndarray]:
    return np.full(sq, n_drawn), np.full(sq, np.nan)


# --- Venus sampling / AKR (expand through member reservoirs) ---------------


def _run_sampling(ctx: StrategyContext) -> StrategyOutput:
    n = ctx.key.budget
    draws = rt.sampling_retrieve(ctx.probs, ctx.keys, n)
    return StrategyOutput(draws, torch.ones_like(draws, dtype=torch.bool),
                          *_fill(draws.shape[:2], n))


def _run_akr(ctx: StrategyContext) -> StrategyOutput:
    k = ctx.key
    akr = rt.akr_progressive(ctx.probs, ctx.keys, theta=k.theta,
                             beta=k.beta, n_max=k.budget)
    return StrategyOutput(akr.draws, akr.valid, akr.n_drawn.cpu().numpy(),
                          akr.mass.cpu().numpy())


# --- baselines (expand via the index_frame table, or raw frame ids) --------


def _run_topk(ctx: StrategyContext) -> StrategyOutput:
    k = ctx.key.budget
    draws = rt.topk_retrieve_batch(ctx.sims, ctx.valid, k)
    return StrategyOutput(draws, torch.ones_like(draws, dtype=torch.bool),
                          *_fill(draws.shape[:2], k))


def _per_session(per_s: torch.Tensor, ctx: StrategyContext, n: int
                 ) -> StrategyOutput:
    """A query-agnostic rule's (S, n) draws, broadcast to every query."""
    s, q = ctx.sims.shape[:2]
    draws = per_s[:, None, :].expand(s, q, n)
    return StrategyOutput(draws, torch.ones_like(draws, dtype=torch.bool),
                          *_fill((s, q), n))


def _run_uniform(ctx: StrategyContext) -> StrategyOutput:
    n = ctx.key.budget
    return _per_session(rt.uniform_retrieve_batch(
        ctx.total_frames, n, device=ctx.sims.device), ctx, n)


def _run_bolt(ctx: StrategyContext) -> StrategyOutput:
    n = ctx.key.budget
    draws = rt.bolt_inverse_transform_batch(ctx.sims, ctx.valid, n,
                                            tau=ctx.key.tau)
    return StrategyOutput(draws, torch.ones_like(draws, dtype=torch.bool),
                          *_fill(draws.shape[:2], n))


def _run_mdf(ctx: StrategyContext) -> StrategyOutput:
    n = ctx.key.budget
    if isinstance(ctx.emb, list):       # a sharded arena: slab by slab
        per = ctx.emb[0].shape[0]
        draws = torch.cat([rt.mdf_retrieve_batch(
            x, ctx.valid[k * per:(k + 1) * per].to(x.device), n
        ).to(ctx.valid.device) for k, x in enumerate(ctx.emb)])
    else:
        draws = rt.mdf_retrieve_batch(ctx.emb, ctx.valid, n)
    return _per_session(draws, ctx, n)


def _run_aks(ctx: StrategyContext) -> StrategyOutput:
    """AKS's recursive budget split reads per-region masses back to the
    host, so it runs lane by lane — over real queries only; padding lanes
    stay 0. The group still costs one scan."""
    n = ctx.key.budget
    s, q = ctx.sims.shape[:2]
    draws = torch.zeros((s, q, n), dtype=torch.int32, device=ctx.sims.device)
    for si in range(s):
        for qi in range(int(ctx.qcount[si])):
            draws[si, qi] = rt.aks_retrieve(ctx.sims[si, qi], ctx.valid[si],
                                            n)
    return StrategyOutput(draws, torch.ones_like(draws, dtype=torch.bool),
                          *_fill((s, q), n))


register_strategy(RetrievalStrategy(
    "sampling", stochastic=True, expand="members", run=_run_sampling))
register_strategy(RetrievalStrategy(
    "akr", stochastic=True, expand="members", run=_run_akr))
register_strategy(RetrievalStrategy(
    "topk", stochastic=False, expand="index", run=_run_topk))
register_strategy(RetrievalStrategy(
    "uniform", stochastic=False, expand="raw", run=_run_uniform))
register_strategy(RetrievalStrategy(
    "bolt", stochastic=False, expand="index", run=_run_bolt))
register_strategy(RetrievalStrategy(
    "mdf", stochastic=False, expand="index", run=_run_mdf))
register_strategy(RetrievalStrategy(
    "aks", stochastic=False, expand="index", run=_run_aks))


@dataclass
class QueryResult:
    frame_ids: np.ndarray          # selected raw-frame ids (deduplicated
    #                                for reservoir strategies; rank or
    #                                time order kept for the baselines)
    draws: np.ndarray              # index draws (frame ids for "raw")
    n_drawn: int
    mass: float
    timings: Dict[str, float]


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def execute_plan(manager, plan: QueryPlan, *, fused: bool = True,
                 coarse: bool = True) -> List[QueryResult]:
    """Run every group: ONE scan launch each — the fused retrieval scan
    for sampling/AKR/top-k groups when ``fused``, the dense scan
    otherwise. With ``coarse`` (the default), a fused group over an arena
    whose coarse tier holds a consolidated row takes the two-stage
    retrieval (two launches); ``coarse=False`` keeps the flat scan.
    Results come back in the plan's spec order."""
    specs = plan.specs
    results: List[Optional[QueryResult]] = [None] * len(specs)
    missing = [j for j, s in enumerate(specs) if s.embedding is None]
    embedded: Dict[int, np.ndarray] = {}
    with obs.span("query.embed", queries=len(missing)) as sp:
        if missing:
            embs = manager.embedder.embed_queries(
                [specs[j].text for j in missing])
            embedded = {j: np.asarray(embs[i], np.float32)
                        for i, j in enumerate(missing)}
    for group in plan.groups:
        _execute_group(manager, group, specs, embedded, results, sp.seconds,
                       fused=fused, coarse=coarse)
    return results


def _group_keys(manager, group: ExecutionGroup, specs, qmax, lanes
                ) -> Optional[np.ndarray]:
    """Key rows (L, qmax, 2) over the scan's lanes (None for a
    deterministic strategy): chain-policy queries consume their session's
    chain in arrival order, explicit seeds derive detached keys, padding
    gets ``split(key(0), qmax - len)``."""
    if not group.strategy.stochastic:
        return None
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


# Strategies the fused launch answers in-kernel: sampling and AKR consume
# its draws (+ drawn probabilities for AKR's stop rule), top-k its
# running top-k. The others consume dense scores or embeddings.
_FUSED_STRATEGIES = ("sampling", "akr", "topk")


def _fused_output(strat, k, fr, sq, two_stage: bool) -> StrategyOutput:
    """The fused launch's draws as a strategy's output: top-k lanes,
    sampling draws, or AKR's stop rule over the in-launch draw state.
    Over two-stage candidates a lane can hold fewer valid candidates than
    k (a consolidated winner is one candidate): top-k drops the masked
    slots, which carry the running top-k's -1e30."""
    if strat.name == "topk":
        draws = fr.topk_i
        if two_stage:
            ok = fr.topk_v > -1e29
            return StrategyOutput(draws, ok, ok.sum(-1).cpu().numpy(),
                                  np.full(sq, np.nan))
        return StrategyOutput(draws, torch.ones_like(draws, dtype=torch.bool),
                              *_fill(sq, draws.shape[-1]))
    if strat.name == "sampling":
        return StrategyOutput(fr.draws,
                              torch.ones_like(fr.draws, dtype=torch.bool),
                              *_fill(sq, k.budget))
    akr = rt.akr_from_draws(fr.draws, fr.drawn_p, fr.p_max[..., 0],
                            theta=k.theta, beta=k.beta, n_max=k.budget)
    return StrategyOutput(akr.draws, akr.valid, akr.n_drawn.cpu().numpy(),
                          akr.mass.cpu().numpy())


def _execute_group(manager, group: ExecutionGroup, specs, embedded,
                   results, t_embed: float, *, fused: bool = True,
                   coarse: bool = True) -> None:
    cfg = manager.cfg
    dev = manager.device
    strat = group.strategy
    k = group.key
    use_fused = fused and strat.name in _FUSED_STRATEGIES
    sids = group.sids
    lanes = manager.scan_lanes(sids)
    lane_of = {sid: si for si, sid in enumerate(lanes) if sid is not None}
    ln, qmax = len(lanes), group.qmax
    timings: Dict[str, float] = {"embed_query": t_embed}

    q_stack = np.zeros((ln, qmax, manager.embed_dim), np.float32)
    qcount = np.zeros((ln,), np.int32)
    for sid in sids:
        qcount[lane_of[sid]] = len(group.order[sid])
        for qi, j in enumerate(group.order[sid]):
            spec = specs[j]
            q_stack[lane_of[sid], qi] = (
                np.asarray(spec.embedding, np.float32)
                if spec.embedding is not None else embedded[j])
    keys = _group_keys(manager, group, specs, qmax, lanes)

    # --- the group's scan: ONE launch, or the two of a two-stage group ---
    with obs.span("query.scan", queries=len(group.indices)) as sp:
        stack = manager.memory_stack(lanes)
        arena = stack.arena_view()
        ts = None
        q_dev = torch.from_numpy(q_stack).to(dev)
        if use_fused:
            if keys is not None:
                targets = rt.targets_from_keys(keys, k.budget, dev)
            else:       # top-k ignores the draw epilogue: one dummy target
                targets = torch.zeros((ln, qmax, 1), dtype=torch.float32,
                                      device=dev)
            n_topk = k.budget if strat.name == "topk" else 1
            # two-stage once the tier holds history: the same targets as the
            # flat path, so the session chains advance alike
            if coarse and arena is not None and arena.has_consolidated():
                ts = tiering.two_stage_retrieve(arena, q_dev, targets,
                                                tau=k.tau, n_topk=n_topk,
                                                topb=cfg.coarse_topb)
                fr = ts.fr
                manager.io_stats["two_stage_groups"] += 1
            else:
                fr = stack.fused_retrieve(q_dev, targets, tau=k.tau,
                                          n_topk=n_topk)
        else:
            sims, probs = stack.search(q_dev, tau=k.tau)
        if len(sids) == 1:   # single-session group: per-session accounting
            manager.io_stats["scans"] += 1
            manager.sessions[sids[0]].memory.io_stats["scans"] += 1
        else:
            manager.io_stats["fused_scans"] += 1
        manager.io_stats["group_scans"] += 1
        if arena is not None and arena.n_shards > 1:    # one launch a slab
            manager.io_stats["sharded_group_scans"] += 1
    timings["similarity"] = sp.seconds

    # --- strategy post-processing + expansion ----------------------------
    with obs.span("query.expand", queries=len(group.indices)) as sp:
        if use_fused:
            out = _fused_output(strat, k, fr, (ln, qmax), ts is not None)
        else:
            emb_stack, valid = stack.device_stack()
            out = strat.run(StrategyContext(
                sims=sims, probs=probs, valid=valid, emb=emb_stack, keys=keys,
                total_frames=np.asarray(
                    [manager.sessions[s].stats["frames_seen"]
                     if s is not None else 0 for s in lanes], np.int64),
                key=k, qcount=qcount))
        ok = out.valid
        if strat.expand == "members":
            u = torch.from_numpy(VenusMemory.expand_u(cfg.seed, k.budget)
                                 ).to(dev)
            if ts is not None:      # draws index the candidate tables
                fids, ok = tiering.expand_candidates(
                    ts.cand_members, ts.cand_counts, out.draws, out.valid, u)
            else:
                fids, ok = stack.expand_members(out.draws, out.valid, u)
            manager.io_stats["device_expands"] += 1
        elif ts is not None:                    # top-k over the candidates
            fids = tiering.gather_candidate_ifr(ts.cand_ifr, out.draws)
        elif strat.expand == "index":
            fids = stack.gather_index_frames(out.draws)
        else:                                   # raw: draws ARE frame ids
            fids = out.draws
        fids_np, ok_np = fids.cpu().numpy(), ok.cpu().numpy()
        draws_np = out.draws.cpu().numpy()
    timings["sample_expand"] = sp.seconds

    for sid in sids:
        si = lane_of[sid]
        for qi, j in enumerate(group.order[sid]):
            lane = fids_np[si, qi][ok_np[si, qi]].astype(np.int64)
            if strat.expand == "members":       # reservoir picks: dedup
                lane = np.unique(lane)
            results[j] = QueryResult(
                frame_ids=lane, draws=draws_np[si, qi],
                n_drawn=int(out.n_drawn[si, qi]),
                mass=float(out.mass[si, qi]), timings=dict(timings))
