"""The PyTorch port's main path held against the JAX reference on the
CPU: ingest → plan → one fused scan per group → sampling, AKR or top-k →
reservoir expansion → frame ids.

Both packages get the same numpy inputs (the same procedural world, and
two ``OracleEmbedder`` instances of the same seed, which embed
identically when called in the same order). Integers must be equal:
partitions, clusters, embedded-frame counts, draws, n_drawn and frame
ids. The AKR mass is a float sum: allclose at rtol 1e-5.
"""

import os

import jax
import numpy as np
import pytest

from repro.core.pipeline import VenusConfig as JConfig
from repro.core.pipeline import VenusSystem as JSystem
from repro.core.queryplan import QuerySpec as JSpec
from repro.core.session import SessionManager as JManager
from repro.data.video import OracleEmbedder as JOracle
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro_torch.core.convert import arena_from_numpy
from repro_torch.core.pipeline import VenusConfig, VenusSystem
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager
from repro_torch.data.video import OracleEmbedder, VideoWorld, WorldConfig
from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_scan_counts()
    tops.reset_kernel_launches()
    yield


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        np.testing.assert_array_equal(a.draws, b.draws)
        assert a.n_drawn == b.n_drawn
        np.testing.assert_allclose(a.mass, b.mass, rtol=1e-5)


def test_end_to_end_oracle_world_coverage():
    """The first milestone: the port's version of the reference's
    ``test_end_to_end_oracle_world_coverage`` gives the same partitions,
    the same frames_embedded and identical frame ids per query."""
    wcfg = dict(n_scenes=8, seed=3)
    jw, tw = JWorld(JWorldConfig(**wcfg)), VideoWorld(WorldConfig(**wcfg))
    jo, to = JOracle(jw, dim=64), OracleEmbedder(tw, dim=64)
    jsys = JSystem(JConfig(), jo, embed_dim=64)
    tsys = VenusSystem(VenusConfig(), to, embed_dim=64, device="cpu")
    for i in range(0, tw.total_frames, 64):
        jsys.ingest(jw.frames[i:i + 64])
        tsys.ingest(tw.frames[i:i + 64])
    jsys.flush()
    tsys.flush()
    assert tsys.stats == jsys.stats
    assert tsys.stats["partitions"] == len(tw.scenes)
    assert tsys.stats["frames_embedded"] < 0.25 * tw.total_frames
    covs = []
    for jq, tq in zip(jw.make_queries(6, seed=9), tw.make_queries(6, seed=9)):
        want = jsys.query(jq.text, query_emb=jo.embed_query(jq))
        got = tsys.query(tq.text, query_emb=to.embed_query(tq))
        _assert_same([got], [want])
        hit = {int(tw.scene_of_frame[f]) for f in got.frame_ids}
        covs.append(len(set(tq.relevant_scenes) & hit)
                    / len(tq.relevant_scenes))
    assert np.mean(covs) >= 0.6
    assert tsys.manager.io_stats["stack_rebuilds"] == 0


# ---------------------------------------------------------------------------
# three sessions, three strategies, one fused launch per group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin_managers():
    """Three sessions streaming one world, the later ones joining a tick
    late (the oracle embeds by frame id with fresh noise per call, so
    every session indexes the world differently), ingested by both
    packages."""
    wcfg = dict(n_scenes=3, seed=21)
    jw, tw = JWorld(JWorldConfig(**wcfg)), VideoWorld(WorldConfig(**wcfg))
    jmgr = JManager(JConfig(memory_capacity=256), JOracle(jw, dim=32),
                    embed_dim=32)
    tmgr = SessionManager(VenusConfig(memory_capacity=256),
                          OracleEmbedder(tw, dim=32), embed_dim=32,
                          device="cpu")
    for m in (jmgr, tmgr):
        for sid in range(3):
            m.create_session(sid)
    n = tw.total_frames
    for tick in range(0, n // 64 + 3):
        feed = {sid: tw.frames[64 * (tick - sid):64 * (tick - sid + 1)]
                for sid in range(3) if 0 <= 64 * (tick - sid) < n}
        jmgr.ingest_tick(feed)
        tmgr.ingest_tick(feed)
    jmgr.flush()
    tmgr.flush()
    queries = tw.make_queries(6, seed=4)
    return jmgr, tmgr, jw, tw, queries


def test_twin_ingest_matches(twin_managers):
    jmgr, tmgr, *_ = twin_managers
    for sid in (0, 1, 2):
        assert tmgr[sid].stats == jmgr[sid].stats
    a, b = tmgr.arena, jmgr.arena
    for f in ("members", "member_count", "index_frame"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)))
    np.testing.assert_allclose(a.emb.numpy(), np.asarray(b.emb),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(a.sizes, b.sizes)


@pytest.mark.parametrize("strategy,budget", [("akr", None),
                                             ("sampling", 12),
                                             ("topk", 5)])
def test_query_batch_cross_parity(twin_managers, strategy, budget):
    jmgr, tmgr, jw, tw, queries = twin_managers
    sids = [2, 0, 1, 0, 2, 1]
    qe = JOracle(jw, dim=32, seed=99).embed_queries(queries)
    if strategy == "topk":
        mk = lambda cls: [cls(sid=s, embedding=qe[j], strategy="topk",
                              budget=budget) for j, s in enumerate(sids)]
        want = jmgr.query_specs(mk(JSpec))
        got = tmgr.query_batch_cross(sids, query_embs=qe, budget=budget,
                                     strategy="topk")
    else:
        kw = dict(query_embs=qe, budget=budget,
                  use_akr=strategy == "akr")
        want = jmgr.query_batch_cross(sids, **kw)
        got = tmgr.query_batch_cross(sids, **kw)
    _assert_same(got, want)
    c = tops.scan_counts()
    assert c["fused_draw_launches"] == 1 and c["similarity_stack"] == 1
    assert tmgr.io_stats["stack_rebuilds"] == 0
    # the session chains advanced in step: the next query agrees too
    if strategy == "akr":
        _assert_same(tmgr.query_batch(1, query_embs=qe[:2]),
                     jmgr.query_batch(1, query_embs=qe[:2]))


def test_mixed_plan_one_launch_per_group(twin_managers):
    jmgr, tmgr, jw, _, queries = twin_managers
    qe = JOracle(jw, dim=32, seed=5).embed_queries(queries)
    plan = [("akr", None, None), ("topk", 4, None), ("sampling", 6, 17),
            ("akr", None, 3), ("topk", 4, None), ("sampling", 6, None)]
    mk = lambda cls: [cls(sid=j % 3, embedding=qe[j], strategy=s, budget=b,
                          seed=seed)
                      for j, (s, b, seed) in enumerate(plan)]
    tplan = tmgr.plan(mk(QuerySpec))
    assert tplan.n_scans == 3
    got = tmgr.execute(tplan)
    want = jmgr.execute(jmgr.plan(mk(JSpec)))
    _assert_same(got, want)
    assert tops.scan_counts()["fused_draw_launches"] == 3


# ---------------------------------------------------------------------------
# state carried across: the reference's arena, queried by both packages
# ---------------------------------------------------------------------------


def test_arena_from_numpy_round_trip(twin_managers):
    """The reference arena's arrays and PRNG keys → a port manager: both
    packages answer the same queries over the same memory identically."""
    jmgr, _, jw, tw, queries = twin_managers
    a = jmgr.arena
    sids = sorted(jmgr.sessions)
    arrays = dict(
        emb=np.asarray(a.emb), members=np.asarray(a.members),
        member_count=np.asarray(a.member_count),
        index_frame=np.asarray(a.index_frame), sizes=a.sizes.copy(),
        heads=a.heads.copy(),
        keys=np.stack([np.asarray(jax.random.key_data(jmgr[s].key))
                       for s in sids]),
        emb_scale=(np.asarray(a.emb_scale) if a.emb_scale is not None
                   else None))
    tmgr = arena_from_numpy(VenusConfig(memory_capacity=256),
                            OracleEmbedder(tw, dim=32), sids=sids,
                            device="cpu", **arrays)
    qe = JOracle(jw, dim=32, seed=6).embed_queries(queries)
    qsids = [sids[j % len(sids)] for j in range(len(qe))]
    for kw in (dict(), dict(budget=9, use_akr=False)):
        _assert_same(tmgr.query_batch_cross(qsids, query_embs=qe, **kw),
                     jmgr.query_batch_cross(qsids, query_embs=qe, **kw))


# ---------------------------------------------------------------------------
# what the port does not run yet raises, naming ROADMAP
# ---------------------------------------------------------------------------


def test_later_slices_raise_clearly(twin_managers, tmp_path):
    """The dense strategies and ``fused=False`` run now (held against the
    reference in test_torch_dense.py), and so do the coarse tier and the
    merging eviction policies (test_torch_tier.py,
    test_torch_lifecycle.py) and the spill tier (test_torch_spill.py):
    ``spill_dir`` runs, ``host_retain`` without it is a ``ValueError``,
    and ``uniform`` on a window-evicting session is accepted with spill
    and rejected without."""
    _, tmgr, *_ = twin_managers
    for strategy in ("bolt", "mdf", "aks", "uniform"):
        plan = tmgr.plan([QuerySpec(sid=0, embedding=np.ones(32),
                                    strategy=strategy, budget=4)])
        assert plan.n_scans == 1
    for kw in (dict(coarse_capacity=8, eviction="consolidate"),
               dict(eviction="cluster_merge", merge_threshold=0.5)):
        assert VenusConfig(**kw).eviction == kw["eviction"]
    with pytest.raises(ValueError, match="requires spill_dir"):
        VenusConfig(host_retain=4)
    spec = QuerySpec(sid=0, embedding=np.ones(32), strategy="uniform",
                     budget=4)
    for spill in (None, str(tmp_path)):
        cfg = VenusConfig(memory_capacity=16, eviction="sliding_window",
                          spill_dir=spill,
                          host_retain=None if spill is None else 4)
        mgr = SessionManager(cfg, None, 32, device="cpu")
        mgr.create_session()
        assert mgr[0].frames.spill_enabled == (spill is not None)
        if spill is None:
            with pytest.raises(ValueError, match="no spill tier"):
                mgr.plan([spec])
        else:
            assert mgr.plan([spec]).n_scans == 1
            assert os.path.isdir(os.path.join(spill, "session-00000"))
            mgr.close_session(0)
            assert not os.listdir(spill)


def test_interleaved_sessions_match_separate_ingestion():
    """Twin of the reference's case (tests/test_multistream.py): two
    streams interleaved tick by tick through one ``SessionManager``
    build exactly the memories that single-stream ingestion builds."""
    from repro_torch.core.pipeline import VenusSystem
    from repro_torch.data.video import PixelEmbedder, VideoWorld, WorldConfig
    worlds = [VideoWorld(WorldConfig(n_scenes=5, seed=21)),
              VideoWorld(WorldConfig(n_scenes=5, seed=22))]
    n = min(w.total_frames for w in worlds)
    mgr = SessionManager(VenusConfig(), PixelEmbedder(dim=64), embed_dim=64,
                         device="cpu")
    sids = [mgr.create_session(), mgr.create_session()]
    for i in range(0, n, 50):
        mgr.ingest_tick({sid: w.frames[i:i + 50]
                         for sid, w in zip(sids, worlds)})
    mgr.flush()
    for sid, world in zip(sids, worlds):
        solo = VenusSystem(VenusConfig(), PixelEmbedder(dim=64),
                           embed_dim=64, device="cpu")
        for i in range(0, n, 50):
            solo.ingest(world.frames[i:i + 50])
        solo.flush()
        a, b = mgr[sid].memory, solo.memory
        assert a.size == b.size
        for f in ("_emb", "_members", "_member_count", "_index_frame",
                  "_scene_id"):
            np.testing.assert_array_equal(getattr(a, f)[:a.size],
                                          getattr(b, f)[:b.size], err_msg=f)
        assert mgr[sid].stats == solo.stats
