"""The port's hierarchical tier held against the JAX reference on the CPU:
the coarse tier's geometry and block summaries, consolidation on
eviction, and the two-stage (coarse → fine) retrieval, at d = 32 and the
reference's ``TIER_CFG`` geometry (capacity 128, coarse_block 16,
coarse_capacity 32, top-B 4).

Both packages take the same numpy rows through ``insert_batch`` inside
the arena's deferred write, as an ingest tick does. Host mirrors and
counters must be equal (the consolidation arithmetic is the same numpy,
float64 where the reference takes float64), the device buffers equal,
and the queries' winners, candidate tables, draws, ``n_drawn`` and frame
ids equal; the AKR mass is a float sum, allclose at rtol 1e-5. The
inputs keep a margin between each query's B-th and (B+1)-th coarse
score (checked), so both packages pick the same stage-1 winners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiering as jtiering
from repro.core.memory import MemoryArena as JArena
from repro.core.memory import VenusMemory as JMemory
from repro.core.memory import coarse_rows_for as jcoarse_rows_for
from repro.core.queryplan import QuerySpec as JSpec
from repro.core.queryplan import _targets_from_keys
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.kernels import ops as jops
from repro_torch.core import retrieval as trt
from repro_torch.core import tiering
from repro_torch.core.convert import COARSE_KEYS, arena_from_numpy
from repro_torch.core.memory import (ConsolidationEviction, MemoryArena,
                                     VenusMemory, coarse_rows_for)
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.kernels import ops as tops

DIM = 32
TIER = dict(memory_capacity=128, member_cap=8, eviction="consolidate",
            coarse_capacity=32, coarse_block=16, coarse_topb=4)
# the arena counters the port counts as rows written where the reference
# counts the pow2 bucket of each padded scatter (ROADMAP Queue 3)
ROWS_WRITTEN = ("appended_rows", "coarse_appended_rows")


class ArrayEmbedder:
    """Managers fed by direct ``insert_batch`` calls embed nothing."""

    def embed_queries(self, texts):
        raise AssertionError("tests pass explicit embeddings")

    def embed_frames(self, frames, aux=None, frame_ids=None):
        raise AssertionError("tests insert rows directly")


@pytest.fixture(autouse=True)
def _reset_counters():
    tops.reset_scan_counts()
    jops.reset_scan_counts()
    yield


def _unit(rows):
    rows = np.asarray(rows, np.float32)
    return rows / (np.linalg.norm(rows, axis=-1, keepdims=True) + 1e-12)


def _rows(seed, n, n_clusters=8, noise=0.05):
    rng = np.random.default_rng(seed)
    cen = _unit(rng.normal(size=(n_clusters, DIM)))
    labels = rng.integers(0, n_clusters, size=n)
    rows = _unit(cen[labels] + noise * rng.normal(size=(n, DIM)))
    return cen, labels, rows


def _twins(n_sessions=1, **over):
    kw = dict(TIER, **over)
    j = JManager(JConfig(**kw), ArrayEmbedder(), embed_dim=DIM)
    t = SessionManager(VenusConfig(**kw), ArrayEmbedder(), embed_dim=DIM,
                       device="cpu")
    for m in (j, t):
        for _ in range(n_sessions):
            m.create_session()
    return j, t


def _feed(mgr, sid, rows, fid0, chunk=16):
    """Insert rows into one session in ticks of ``chunk``, each riding the
    arena's deferred write; each row's reservoir is itself and fid+1000."""
    mem = mgr.sessions[sid].memory
    for lo in range(0, len(rows), chunk):
        batch = rows[lo:lo + chunk]
        fids = np.arange(fid0 + lo, fid0 + lo + len(batch))
        with mgr.arena.deferred_appends():
            mem.insert_batch(batch, scene_ids=[0] * len(batch),
                             index_frames=fids,
                             member_lists=[[int(f), int(f) + 1000]
                                           for f in fids])


def _feed_both(j, t, sid, rows, fid0=0):
    _feed(j, sid, rows, fid0)
    _feed(t, sid, rows, fid0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


COARSE_MIRRORS = ("_coarse_emb", "_coarse_members", "_coarse_count",
                  "_coarse_ifr", "_coarse_weight", "_coarse_fid_lo",
                  "_coarse_fid_hi", "_coarse_csize")
COARSE_BUFFERS = ("coarse_emb", "coarse_members", "coarse_member_count",
                  "coarse_index_frame", "coarse_valid")


def _assert_tier_equal(j, t):
    """Host mirrors, memory counters and device buffers equal, bit for
    bit; arena counters equal apart from ``ROWS_WRITTEN``."""
    for sid in j.sessions:
        jm, tm = j.sessions[sid].memory, t.sessions[sid].memory
        for f in COARSE_MIRRORS + ("_emb", "_members", "_member_count",
                                   "_index_frame", "_head", "_size"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                          err_msg=f)
        assert tm.io_stats == jm.io_stats
    for f in COARSE_BUFFERS + ("emb", "members", "member_count",
                               "index_frame"):
        np.testing.assert_array_equal(_np(getattr(t.arena, f)),
                                      _np(getattr(j.arena, f)), err_msg=f)
    ta, ja = t.arena.io_stats, j.arena.io_stats
    assert {k: v for k, v in ta.items() if k not in ROWS_WRITTEN} == \
        {k: v for k, v in ja.items() if k not in ROWS_WRITTEN}


# ---------------------------------------------------------------------------
# geometry and population
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", [(128, 32, 16), (100, 4, 16),
                                      (128, 0, 16), (8192, 256, 64)])
def test_coarse_rows_for_matches_reference(geometry):
    assert coarse_rows_for(*geometry) == jcoarse_rows_for(*geometry)
    cap, cc, blk = geometry
    t = MemoryArena(cap, 4, 8, coarse_capacity=cc, coarse_block=blk,
                    device="cpu")
    j = JArena(cap, 4, 8, coarse_capacity=cc, coarse_block=blk)
    for a in (t, j):
        a.add_session()
    assert (t.n_blocks, t.n_coarse) == (j.n_blocks, j.n_coarse)
    if cc:
        for f in COARSE_BUFFERS:
            assert _np(getattr(t, f)).shape == _np(getattr(j, f)).shape
    else:
        assert t.coarse_emb is None and j.coarse_emb is None
    assert not t.has_consolidated() and not j.has_consolidated()


@pytest.mark.parametrize("n_rows", [24, 128, 168, 4 * 128 + 8])
def test_block_summaries_and_consolidation_match_reference(n_rows):
    """Block summaries after inserts that fill, then wrap the ring, and
    the consolidated rows the evictions fold: host mirrors bit-equal,
    device coarse buffers equal."""
    _, _, rows = _rows(0, n_rows)
    j, t = _twins(2)
    _feed_both(j, t, 0, rows)
    _feed_both(j, t, 1, rows[::-1][:n_rows // 2], fid0=5000)
    _assert_tier_equal(j, t)
    evicted = n_rows > TIER["memory_capacity"]
    assert t.arena.has_consolidated() == evicted == \
        j.arena.has_consolidated()
    # the port counts the coarse rows written (24 rows: block 0 then 1
    # of session 0, block 0 of session 1, in three flushes), the
    # reference the pow2 bucket (at least 8) of each flush
    if n_rows == 24:
        assert t.arena.io_stats["coarse_appended_rows"] == 3
        assert j.arena.io_stats["coarse_appended_rows"] == 24


def _fold_rules(mem_cls, policy_cls):
    """The reference's fold-rules case: a threshold fold, a fresh row,
    and a full region folding into its nearest row anyway."""
    e = np.eye(DIM, dtype=np.float32)
    kw = dict(eviction=policy_cls(threshold=0.9), coarse_capacity=2,
              coarse_block=4)
    mem = (mem_cls(4, DIM, member_cap=8, device="cpu", **kw)
           if mem_cls is VenusMemory else mem_cls(4, DIM, member_cap=8, **kw))
    mem.insert_batch(np.stack([e[0], e[0], e[1], e[2]]), scene_ids=[0] * 4,
                     index_frames=[10, 11, 12, 13],
                     member_lists=[[10, 100], [11], [12], [13]])
    mem.insert_batch(np.stack([e[3], e[4]]), scene_ids=[1] * 2,
                     index_frames=[14, 15], member_lists=[[14], [15]])
    mid = mem._coarse_csize, int(mem._coarse_weight[0])
    mem.insert_batch(np.stack([e[5], e[6]]), scene_ids=[2] * 2,
                     index_frames=[16, 17], member_lists=[[16], [17]])
    return mem, mid


def test_consolidation_fold_rules_match_reference():
    from repro.core.memory import ConsolidationEviction as JConsolidation
    tm, tmid = _fold_rules(VenusMemory, ConsolidationEviction)
    jm, jmid = _fold_rules(JMemory, JConsolidation)
    assert tmid == jmid == (1, 2)          # the second e0 folded
    for f in COARSE_MIRRORS:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    assert tm.io_stats == jm.io_stats
    assert tm._coarse_csize == 2                       # the region is full
    assert tm.io_stats["consolidated_rows"] == 4
    assert set(tm._coarse_members[0, :tm._coarse_count[0]]) >= {10, 100, 11}
    assert tm.min_live_frame() == jm.min_live_frame() <= 10


def test_consolidate_requires_coarse_capacity():
    mem = VenusMemory(4, DIM, member_cap=4, eviction="consolidate",
                      device="cpu")
    rows = _unit(np.random.default_rng(1).normal(size=(4, DIM)))
    mem.insert_batch(rows, scene_ids=[0] * 4, index_frames=[0, 1, 2, 3],
                     member_lists=[[0], [1], [2], [3]])
    with pytest.raises(RuntimeError, match="coarse_capacity"):
        mem.insert_batch(rows[:1], scene_ids=[1], index_frames=[4],
                         member_lists=[[4]])


# ---------------------------------------------------------------------------
# queries: the flat path, then the two-stage path
# ---------------------------------------------------------------------------


def _specs(cls, sids, qe, strategy, budget, seed=None):
    return [cls(sid=s, embedding=qe[k], strategy=strategy, budget=budget,
                seed=seed) for k, s in enumerate(sids)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        np.testing.assert_array_equal(a.draws, b.draws)
        assert a.n_drawn == b.n_drawn
        np.testing.assert_allclose(a.mass, b.mass, rtol=1e-5)


STRATEGIES = [("akr", None), ("sampling", 12), ("topk", 6)]
# every query test: 3 sessions, 9 queries (3 a session), so the
# reference's compiled programs are shared between the tests
SIDS = [0, 1, 2, 2, 1, 0, 0, 1, 2]


def _queries(cen):
    return cen[np.arange(len(SIDS)) % len(cen)]


@pytest.mark.parametrize("consolidated", [False, True])
def test_flat_path_matches_reference(consolidated):
    """Before the first consolidation every query takes the flat scan;
    with consolidated rows, ``coarse=False`` keeps it. Both packages
    answer alike, and neither runs a two-stage scan."""
    n = 4 * 128 if consolidated else 96
    cen, _, rows = _rows(3, n)
    j, t = _twins(3)
    for sid in range(3):
        _feed_both(j, t, sid, rows[sid * 8:], fid0=7000 * sid)
    assert t.arena.has_consolidated() == consolidated
    qe = _queries(cen)
    for strategy, budget in STRATEGIES:
        want = j.execute(j.plan(_specs(JSpec, SIDS, qe, strategy, budget)),
                         coarse=False)
        got = t.execute(t.plan(_specs(QuerySpec, SIDS, qe, strategy,
                                      budget)), coarse=False)
        _assert_same(got, want)
        if not consolidated:        # the default path is the flat one too
            _assert_same(
                t.execute(t.plan(_specs(QuerySpec, SIDS, qe, strategy,
                                        budget, seed=3))),
                j.execute(j.plan(_specs(JSpec, SIDS, qe, strategy,
                                        budget, seed=3))))
    for c in (tops.scan_counts(), jops.scan_counts()):
        assert c["two_stage_scans"] == c["coarse_scan_bytes"] == 0
    assert t.io_stats["two_stage_groups"] == 0 == \
        j.io_stats["two_stage_groups"]


@pytest.fixture(scope="module")
def tiered_twins():
    """Three sessions, each fed 4× capacity of clustered rows (so every
    one consolidates), in both packages; queries near the centroids."""
    j, t = _twins(3)
    qes = []
    for sid in range(3):
        cen, _, rows = _rows(10 + sid, 4 * 128)
        _feed_both(j, t, sid, rows, fid0=10000 * sid)
        qes.append(cen[:3])
    return j, t, np.concatenate(qes)


def _stage1_margin(t, q_stack, topb):
    """The smallest gap between each live query's B-th and (B+1)-th
    coarse cosine over the valid coarse rows."""
    a = t.arena
    x = a.coarse_emb.numpy().astype(np.float64)
    x /= np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12
    q = q_stack / np.linalg.norm(q_stack, axis=-1, keepdims=True)
    sims = np.einsum("sqd,snd->sqn", q, x)
    sims = np.where(a.coarse_valid[:, None, :], sims, -np.inf)
    top = -np.sort(-sims, axis=-1)[..., :topb + 1]
    return float(np.min(top[..., topb - 1] - top[..., topb]))


@pytest.mark.parametrize("strategy,budget", STRATEGIES)
def test_two_stage_matches_reference(tiered_twins, strategy, budget):
    """Once consolidated, each fused group runs coarse scan → candidate
    gather → candidate scan: the same frame ids, draws, n_drawn and AKR
    mass as the reference, and the same counters."""
    j, t, qes = tiered_twins
    sids = SIDS
    tops.reset_scan_counts()
    jops.reset_scan_counts()
    g0, j0 = t.io_stats["two_stage_groups"], j.io_stats["two_stage_groups"]
    want = j.execute(j.plan(_specs(JSpec, sids, qes, strategy, budget)))
    got = t.execute(t.plan(_specs(QuerySpec, sids, qes, strategy, budget)))
    _assert_same(got, want)
    tc, jc = tops.scan_counts(), jops.scan_counts()
    for key in ("coarse_scan_bytes", "fine_gather_rows", "two_stage_scans",
                "scan_bytes", "fused_draw_launches"):
        assert tc[key] == jc[key], key
    assert tc["two_stage_scans"] == 1 and tc["fused_draw_launches"] == 2
    assert tc["fine_gather_rows"] == 3 * 3 * TIER["coarse_topb"] * \
        TIER["coarse_block"]
    assert t.io_stats["two_stage_groups"] - g0 == 1 == \
        j.io_stats["two_stage_groups"] - j0
    assert t.io_stats["stack_rebuilds"] == 0
    # the session chains advanced in step
    for sid in range(3):
        np.testing.assert_array_equal(
            t.sessions[sid].key,
            np.asarray(jax.random.key_data(j.sessions[sid].key)))


def test_two_stage_tables_match_reference(tiered_twins):
    """``two_stage_retrieve`` itself: stage-1 winners (kept a margin
    apart), candidate embeddings, reservoirs, counts, frame ids and
    validity, and the stage-2 draws and top-k, equal."""
    j, t, qes = tiered_twins
    q_stack = np.stack([qes[3 * s:3 * s + 3] for s in range(3)])
    topb = TIER["coarse_topb"]
    assert _stage1_margin(t, q_stack, topb) > 1e-4
    keys = jax.random.split(jax.random.key(4), 9).reshape(3, 3)
    jt = _targets_from_keys(keys, n=16)
    targets = trt.targets_from_keys(
        np.asarray(jax.random.key_data(keys)), 16, "cpu")
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jt))
    want = jtiering.two_stage_retrieve(j.arena, jnp.asarray(q_stack), jt,
                                       tau=0.1, n_topk=5, topb=topb)
    got = tiering.two_stage_retrieve(t.arena, torch.from_numpy(q_stack),
                                     targets, tau=0.1, n_topk=5, topb=topb)
    np.testing.assert_array_equal(got.winners.numpy(),
                                  np.asarray(want.winners))
    for f in ("cand_members", "cand_counts", "cand_ifr", "cand_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    jemb = jtiering._gather_candidates(
        want.winners, j.arena.emb, j.arena.members, j.arena.member_count,
        j.arena.index_frame, j.arena.device_valid(), j.arena.coarse_emb,
        j.arena.coarse_members, j.arena.coarse_member_count,
        j.arena.coarse_index_frame, j.arena.device_coarse_valid(),
        block=j.arena.coarse_block, n_blocks=j.arena.n_blocks)[0]
    temb = tiering._gather_candidates(t.arena, got.winners)[0]
    np.testing.assert_array_equal(temb.numpy(), np.asarray(jemb))
    for f in ("draws", "topk_i"):
        np.testing.assert_array_equal(getattr(got.fr, f).numpy(),
                                      np.asarray(getattr(want.fr, f)))
    for f in ("drawn_p", "topk_v", "m", "l", "p_max"):
        np.testing.assert_allclose(getattr(got.fr, f).numpy(),
                                   np.asarray(getattr(want.fr, f)),
                                   rtol=1e-5, atol=1e-6)
    # every lane reaches consolidated history (a winner past the blocks)
    assert bool((got.winners >= t.arena.n_blocks).any())


@pytest.mark.parametrize("index_dtype", ["float32", "int8"])
def test_arena_from_numpy_round_trip_consolidated(index_dtype):
    """The reference's consolidated arena and memories → a port twin
    answers the same two-stage queries, and both continue the same
    memory: more rows consolidate alike and the queries agree again."""
    kw = dict(TIER, index_dtype=index_dtype)
    j = JManager(JConfig(**kw), ArrayEmbedder(), embed_dim=DIM)
    for _ in range(3):
        j.create_session()
    cen, _, rows = _rows(21, 4 * 128)
    _feed(j, 0, rows, 0)
    _feed(j, 1, rows[::-1][:300], 9000)
    _feed(j, 2, rows[100:200], 19000)
    a = j.arena
    mems = [j.sessions[s].memory for s in range(3)]
    coarse = {k: np.asarray(getattr(a, "coarse_" + k))
              for k in COARSE_KEYS[:5]}
    coarse.update(
        weight=np.stack([m._coarse_weight for m in mems]),
        fid_lo=np.stack([m._coarse_fid_lo for m in mems]),
        fid_hi=np.stack([m._coarse_fid_hi for m in mems]),
        csize=np.asarray([m._coarse_csize for m in mems]))
    t = arena_from_numpy(
        VenusConfig(**kw), ArrayEmbedder(), emb=np.asarray(a.emb),
        members=np.asarray(a.members),
        member_count=np.asarray(a.member_count),
        index_frame=np.asarray(a.index_frame), sizes=a.sizes.copy(),
        heads=a.heads.copy(),
        keys=np.stack([np.asarray(jax.random.key_data(j.sessions[s].key))
                       for s in range(3)]),
        emb_scale=None if a.emb_scale is None else np.asarray(a.emb_scale),
        coarse=coarse, device="cpu")
    qe = _queries(cen)
    for step in range(2):
        for strategy, budget in STRATEGIES:
            _assert_same(
                t.execute(t.plan(_specs(QuerySpec, SIDS, qe, strategy,
                                        budget))),
                j.execute(j.plan(_specs(JSpec, SIDS, qe, strategy,
                                        budget))))
        more = _rows(22 + step, 40)[2]
        _feed_both(j, t, 0, more, fid0=20000 + 100 * step)
        if index_dtype == "float32":   # int8: dequantised mirrors fold
            _assert_tier_equal_mirrors(j, t)
    assert t.io_stats["two_stage_groups"] == 6


def _assert_tier_equal_mirrors(j, t):
    for sid in j.sessions:
        jm, tm = j.sessions[sid].memory, t.sessions[sid].memory
        for f in COARSE_MIRRORS:
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                          err_msg=f)
    for f in COARSE_BUFFERS:
        np.testing.assert_array_equal(_np(getattr(t.arena, f)),
                                      _np(getattr(j.arena, f)), err_msg=f)


# ---------------------------------------------------------------------------
# lifecycle: a recycled slot resets the tier
# ---------------------------------------------------------------------------


def test_recycled_slot_resets_coarse_tier():
    """close → create on the same slot: the new tenant sees none of the
    old tenant's coarse rows, consolidates from scratch like the
    reference, and answers alike."""
    cen, _, rows = _rows(17, 2 * 128)
    j, t = _twins(3)
    for sid in (0, 1, 2):
        _feed_both(j, t, sid, rows[sid:], fid0=3000 * sid)
    slot = t.sessions[1].memory.slot
    assert t.arena.coarse_valid[slot].any()
    for m in (j, t):
        m.close_session(1)
    assert not t.arena.coarse_valid[slot].any()
    assert j.create_session() == t.create_session() == 3
    assert t.sessions[3].memory.slot == slot
    assert not t.arena.coarse_emb[slot].any()
    assert t.sessions[3].memory._coarse_csize == 0
    _feed_both(j, t, 3, rows[::-1], fid0=9000)
    _assert_tier_equal(j, t)
    sids = [3 if s == 1 else s for s in SIDS]
    qe = _queries(cen)
    _assert_same(
        t.execute(t.plan(_specs(QuerySpec, sids, qe, "topk", 6))),
        j.execute(j.plan(_specs(JSpec, sids, qe, "topk", 6))))
    assert t.io_stats["two_stage_groups"] == 1


def test_carried_int8_mirrors_requantise_to_arena_rows():
    """``arena_from_numpy`` rebuilds an int8 twin's host mirrors as
    q × scale. Re-quantising them (what a standing query's slab does with
    the mirrors) gives back the arena's int8 rows bit for bit; the scales
    come back within an ulp (they cancel under the scans' row
    normalisation). A standing spec over rows inserted after the carry-over
    fires as the reference's does."""
    from repro.core.memory import quantise_rows as jquantise_rows
    from repro_torch.core.memory import quantise_rows
    kw = dict(memory_capacity=128, member_cap=8, index_dtype="int8")
    j = JManager(JConfig(**kw), ArrayEmbedder(), embed_dim=DIM)
    for _ in range(2):
        j.create_session()
    cen, _, rows = _rows(31, 200)
    _feed(j, 0, rows[:100], 0)
    _feed(j, 1, rows[100:], 5000)
    a = j.arena
    t = arena_from_numpy(
        VenusConfig(**kw), ArrayEmbedder(), emb=np.asarray(a.emb),
        members=np.asarray(a.members),
        member_count=np.asarray(a.member_count),
        index_frame=np.asarray(a.index_frame), sizes=a.sizes.copy(),
        heads=a.heads.copy(),
        keys=np.stack([np.asarray(jax.random.key_data(j.sessions[s].key))
                       for s in range(2)]),
        emb_scale=np.asarray(a.emb_scale), device="cpu")
    for sid in range(2):
        mem = t.sessions[sid].memory
        p = np.arange(mem.size)
        q, scale = quantise_rows(mem._emb[p])
        np.testing.assert_array_equal(q, t.arena.emb[mem.slot].numpy()[p])
        np.testing.assert_array_equal(q, np.asarray(a.emb)[sid][p])
        want = np.asarray(a.emb_scale)[sid][p]
        np.testing.assert_array_max_ulp(scale, want, maxulp=1)
        # the reference's quantiser agrees on the dequantised mirrors
        np.testing.assert_array_equal(q, jquantise_rows(mem._emb[p])[0])
    # a standing spec rides on after the carry-over (every new row's
    # cosine clear of the threshold)
    emb = cen[0]
    cos = rows[:16] @ emb / np.linalg.norm(rows[:16], axis=-1)
    assert np.abs(cos - 0.5).min() >= 1e-4 and cos.max() > 0.5
    fired = []
    for m, spec in ((t, QuerySpec), (j, JSpec)):
        m.register_standing(0, spec(sid=0, embedding=emb, strategy="topk",
                                    budget=3), threshold=0.5)
        mem = m.sessions[0].memory
        fids = np.arange(9000, 9016)
        with m.arena.deferred_appends():
            phys = mem.insert_batch(rows[:16], scene_ids=[0] * 16,
                                    index_frames=fids,
                                    member_lists=[[int(f)] for f in fids])
        fired.append(m.standing.evaluate(m.sessions, {0: [phys]},
                                         m.io_stats))
    (got,), (want,) = fired
    assert (got.sid, got.spec_id, got.tick) == (want.sid, want.spec_id,
                                                 want.tick)
    np.testing.assert_array_equal(got.frame_ids, want.frame_ids)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5)


# ---------------------------------------------------------------------------
# the reference's acceptance cases (tests/test_tiering.py), on the port
# ---------------------------------------------------------------------------


def _port_manager(**cfg):
    return SessionManager(VenusConfig(**cfg), ArrayEmbedder(), embed_dim=DIM,
                          device="cpu")


def _feed_own(mgr, sid, rows, chunk=16):
    """As the reference's acceptance cases feed: each row's reservoir is
    its own frame id."""
    mem = mgr.sessions[sid].memory
    for lo in range(0, len(rows), chunk):
        fids = np.arange(lo, lo + len(rows[lo:lo + chunk]))
        with mgr.arena.deferred_appends():
            mem.insert_batch(rows[lo:lo + chunk], scene_ids=[0] * len(fids),
                             index_frames=fids,
                             member_lists=[[int(f)] for f in fids])


def test_two_stage_scans_fewer_bytes_than_flat():
    """Twin of the reference's case: with the tier populated, one query's
    coarse scan and gathered fine candidates stream fewer bytes than one
    flat 1×-capacity scan, and both stages are counted."""
    rng = np.random.default_rng(5)
    cen = _unit(rng.normal(size=(8, DIM)))
    labels = rng.integers(0, 8, size=4 * TIER["memory_capacity"])
    rows = _unit(cen[labels] + 0.05 * rng.normal(size=(len(labels), DIM)))
    mgr = _port_manager(**TIER)
    sid = mgr.create_session()
    _feed_own(mgr, sid, rows)
    a = mgr.arena
    assert a.has_consolidated()
    spec = QuerySpec(sid=sid, embedding=cen[0], strategy="topk", budget=8)
    tops.reset_scan_counts()
    mgr.execute(mgr.plan([spec]), coarse=False)
    flat_bytes = tops.scan_counts()["scan_bytes"]
    assert tops.scan_counts()["two_stage_scans"] == 0
    tops.reset_scan_counts()
    mgr.execute(mgr.plan([spec]))
    sc = tops.scan_counts()
    assert sc["two_stage_scans"] == 1
    assert mgr.io_stats["two_stage_groups"] == 1
    assert sc["coarse_scan_bytes"] > 0
    assert sc["fine_gather_rows"] == TIER["coarse_topb"] * \
        TIER["coarse_block"]
    gathered_bytes = sc["fine_gather_rows"] * DIM * 4     # f32 tiers
    assert sc["coarse_scan_bytes"] + gathered_bytes < flat_bytes
    assert a.n_coarse + sc["fine_gather_rows"] < TIER["memory_capacity"]
    assert mgr.io_stats["stack_rebuilds"] == 0


def test_recall_vs_unbounded_oracle():
    """Twin of the reference's acceptance case: 4× capacity ingested,
    top-k recall ≥ 0.8 against an unbounded-capacity oracle (on cluster
    identity: the oracle scores 1.0 by construction)."""
    rng = np.random.default_rng(11)
    n_clusters = 8
    cen = _unit(rng.normal(size=(n_clusters, DIM)))
    total = 4 * TIER["memory_capacity"]
    labels = rng.integers(0, n_clusters, size=total)
    rows = _unit(cen[labels] + 0.05 * rng.normal(size=(total, DIM)))
    mgr = _port_manager(**TIER)
    sid = mgr.create_session()
    _feed_own(mgr, sid, rows)
    assert mgr.arena.has_consolidated()
    om = _port_manager(memory_capacity=total, member_cap=8)
    osid = om.create_session()
    _feed_own(om, osid, rows)
    recalls, oracle_recalls = [], []
    for q in range(n_clusters):
        got = mgr.execute(mgr.plan([QuerySpec(
            sid=sid, embedding=cen[q], strategy="topk", budget=8)]))[0]
        want = om.execute(om.plan([QuerySpec(
            sid=osid, embedding=cen[q], strategy="topk", budget=8)]))[0]
        assert len(got.frame_ids) > 0
        recalls.append(np.mean(labels[got.frame_ids] == q))
        oracle_recalls.append(np.mean(labels[want.frame_ids] == q))
    assert np.mean(oracle_recalls) == 1.0
    assert np.mean(recalls) >= 0.8, recalls
    assert mgr.io_stats["two_stage_groups"] == n_clusters
