"""The PyTorch port's core layer held against the JAX reference on the
CPU: segmentation, clustering, the retrieval rules, reservoir expansion
and the memory arena (inserts, sliding-window wrap, slot reuse).

Integers (boundaries, assignments, index frames, draws, frame ids, sizes,
windows) must be equal. Floats are allclose at rtol 1e-5 / atol 1e-6:
XLA and PyTorch sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclu
from repro.core import memory as jmem
from repro.core import retrieval as jrt
from repro.core import scene as jscene
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro_torch.core import clustering as tclu
from repro_torch.core import memory as tmem
from repro_torch.core import retrieval as trt
from repro_torch.core import scene as tscene
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.data.video import PixelEmbedder, VideoWorld, WorldConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import prng


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_scan_counts()
    tops.reset_kernel_launches()
    yield


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carry", [None, 0, 3])
def test_segment_matches_reference(carry):
    phi = np.asarray([0.0, 0.01, 0.5, 0.02, 0.02, 0.9, 0.01, 0.0, 0.0,
                      0.0], np.float32)
    kw = dict(threshold=0.1, max_partition_len=3)
    b, p, c = tscene.segment(phi, carry_in=carry, **kw)
    jb, jp, jc = jscene.segment(
        jnp.asarray(phi), carry_in=(None if carry is None
                                    else jnp.asarray(carry, jnp.int32)),
        **kw)
    np.testing.assert_array_equal(b, np.asarray(jb))
    np.testing.assert_array_equal(p, np.asarray(jp))
    assert c == int(jc)


@pytest.fixture(scope="module")
def world_pair():
    cfg = dict(n_scenes=3, seed=2)
    return VideoWorld(WorldConfig(**cfg)), JWorld(JWorldConfig(**cfg))


def test_world_copy_is_identical(world_pair):
    tw, jw = world_pair
    np.testing.assert_array_equal(tw.frames, jw.frames)
    assert [(s.start, s.end, s.event) for s in tw.scenes] == \
        [(s.start, s.end, s.event) for s in jw.scenes]


@pytest.mark.parametrize("chunk", [17, 64])
def test_stream_segmenter_matches_reference(world_pair, chunk, monkeypatch):
    tw, jw = world_pair
    # the reference segmenter scores each chunk eagerly; jit it (same
    # function, compiled once per chunk shape) to keep the test fast
    monkeypatch.setattr(jscene, "scene_scores", jax.jit(
        jscene.scene_scores, static_argnums=1))

    def run(seg, frames, wrap):
        out = []
        for i in range(0, len(frames), chunk):
            out += seg.ingest(wrap(frames[i:i + chunk]))
        out += seg.flush()
        return [(p.start, p.end) for p in out]

    got = run(tscene.StreamSegmenter(threshold=0.075, max_partition_len=40),
              tw.frames, _t)
    want = run(jscene.StreamSegmenter(threshold=0.075, max_partition_len=40),
               jw.frames, jnp.asarray)
    assert got == want
    assert got[-1][1] == tw.total_frames


def test_scene_scores_match_reference(world_pair):
    tw, _ = world_pair
    frames = tw.frames[:40]
    np.testing.assert_allclose(
        tscene.scene_scores(_t(frames)).numpy(),
        np.asarray(jax.jit(jscene.scene_scores)(jnp.asarray(frames))),
        rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------


def test_frame_vectors_match_reference(world_pair):
    tw, _ = world_pair
    frames = tw.frames[:9, :45, :47]             # ragged pooling edges
    np.testing.assert_allclose(
        tclu.frame_vectors(_t(frames), 8).numpy(),
        np.asarray(jclu.frame_vectors(jnp.asarray(frames), 8)),
        rtol=1e-5, atol=1e-6)


def _cluster_inputs():
    rng = np.random.default_rng(0)
    blobs = [rng.random((1, 8)) + 5.0 * k + np.zeros((n, 8))
             for k, n in enumerate((5, 4, 7, 3))]
    grouped = np.concatenate(blobs) + rng.normal(0, 0.01, (19, 8))
    overflow = rng.normal(0, 10, (33, 16))         # > max_clusters seeds
    return [(grouped.astype(np.float32), 1.0, 8),
            (overflow.astype(np.float32), 0.1, 4)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_cluster_partition_matches_reference(case, world_pair):
    if case < 2:
        vecs, thr, kmax = _cluster_inputs()[case]
    else:                      # real frames: one scene's pooled pixels
        tw, _ = world_pair
        sc = tw.scenes[1]
        vecs = np.asarray(tclu.frame_vectors(
            _t(tw.frames[sc.start:sc.end]), 8))
        thr, kmax = 0.35, 16
    got = tclu.cluster_partition(_t(vecs), threshold=thr, max_clusters=kmax)
    want = jclu.cluster_partition(jnp.asarray(vecs), threshold=thr,
                                  max_clusters=kmax)
    n = int(want.n_clusters)
    assert int(got.n_clusters) == n
    # a CPU tensor takes the plain loop; the integers are views of the one
    # buffer the host reads back
    assert tops.kernel_launches()["cluster_partition"] == 0
    t = len(vecs)
    np.testing.assert_array_equal(
        got.packed.numpy(), np.concatenate([[n], got.assignments.numpy(),
                                            got.index_frames.numpy()]))
    assert got.packed.shape == (1 + t + kmax,)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_array_equal(got.index_frames[:n].numpy(),
                                  np.asarray(want.index_frames)[:n])
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device,t,d,k,route,threads", [
    ("cuda", 61, 2352, 16, "smem", 608),      # the cell: 224² pooled 8 × 8
    ("cuda", 1, 48, 4, "smem", 32),
    ("cuda", 256, 2352, 22, "smem", 608),     # 230,072 B of 232,448
    ("cuda", 61, 2352, 23, "global", 608),    # 239,568 B
    ("cuda", 61, 9408, 16, "global", 1024),   # 224² pooled 4 × 4
    ("cpu", 61, 2352, 16, "plain", None)])
def test_cluster_route_is_planned_from_the_shapes(device, t, d, k, route,
                                                 threads):
    """The clustering route is a function of (T, d, K) and the device:
    the K × d means on chip where they fit in a block's 227 KB with the
    ring of two frames and the block's small state, else in device
    memory; a CPU tensor takes the plain loop."""
    from repro_torch.kernels import cluster as tcluster
    assert tcluster.cluster_route(torch.device(device), t, d, k) == route
    if device == "cpu":
        return
    plan = tcluster.cluster_plan(t, d, k)
    assert plan.threads == threads
    on_chip = tcluster.cluster_smem_bytes(d, k, threads, True)
    assert (on_chip <= 227 * 1024) == (route == "smem")
    assert plan.smem == (on_chip if route == "smem" else
                         tcluster.cluster_smem_bytes(d, k, threads, False))
    assert k * d * 4 <= plan.smem or route == "global"


def test_cluster_launch_count_is_listed_and_reset():
    from repro_torch.kernels import cluster as tcluster
    assert tops.kernel_launches()["cluster_partition"] == 0
    tcluster.cluster_partition.launches = 7
    assert tops.kernel_launches()["cluster_partition"] == 7
    tops.reset_kernel_launches()
    assert tcluster.cluster_partition.launches == 0
    with pytest.raises(ValueError):
        tcluster.cluster_plan(1, 2352, 0)


@pytest.mark.parametrize("scene", [0, 1, 2])
def test_cluster_stage_reads_back_the_reference_job(world_pair, scene):
    """``cluster_stage`` reads the clustering back in one copy and gives
    the embed job the reference's clusters: the scene id, the index
    frames' absolute ids and each cluster's members."""
    from repro_torch.core.scene import Partition
    from repro_torch.core.session import SessionState, cluster_stage
    tw, _ = world_pair
    cfg = VenusConfig(memory_capacity=64)
    st = SessionState(0, cfg, 8, device="cpu")
    st.stats["partitions"] = scene
    sc = tw.scenes[scene]
    frames = _t(tw.frames[:sc.end])
    st.pending = list(frames.unbind(0))
    job = cluster_stage(st, Partition(sc.start, sc.end))
    want = jclu.cluster_partition(
        jclu.frame_vectors(jnp.asarray(tw.frames[sc.start:sc.end]),
                           cfg.cluster_pool),
        threshold=cfg.cluster_threshold,
        max_clusters=cfg.max_clusters_per_partition)
    n = int(want.n_clusters)
    assign = np.asarray(want.assignments)
    assert job.scene_id == scene and job.sid == 0
    np.testing.assert_array_equal(
        job.frame_ids, sc.start + np.asarray(want.index_frames)[:n])
    assert len(job.member_lists) == n
    for c in range(n):
        np.testing.assert_array_equal(job.member_lists[c],
                                      sc.start + np.nonzero(assign == c)[0])
    np.testing.assert_array_equal(job.frames.numpy(),
                                  tw.frames[job.frame_ids])
    assert st.stats["partitions"] == scene + 1
    assert st.stats["clusters"] == n


# ---------------------------------------------------------------------------
# retrieval rules and expansion
# ---------------------------------------------------------------------------


def _peaked_probs(seed, q, cap):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((q, cap)).astype(np.float32) * 3
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("theta,beta", [(0.9, 1.0), (0.5, 1.0), (0.8, 2.0)])
def test_akr_from_draws_matches_reference(theta, beta):
    rng = np.random.default_rng(int(theta * 10))
    draws = rng.integers(0, 12, (6, 16)).astype(np.int32)
    drawn_p = rng.random((6, 16)).astype(np.float32) * 0.2
    p_max = rng.random((6,)).astype(np.float32) * 0.3 + 0.05
    got = trt.akr_from_draws(_t(draws), _t(drawn_p), _t(p_max),
                             theta=theta, beta=beta, n_max=16)
    want = jax.vmap(lambda d, p, m: jrt.akr_from_draws(
        d, p, m, theta=theta, beta=beta, n_max=16))(
            jnp.asarray(draws), jnp.asarray(drawn_p), jnp.asarray(p_max))
    for f in ("draws", "valid", "n_drawn", "n_min"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-5, atol=1e-6)


def test_sampling_and_akr_match_reference_keys():
    """Same keys (threefry bridge) → same draws as the reference."""
    probs = _peaked_probs(3, 4, 300)
    keys = prng.split(prng.key(9), 4)
    jkeys = jax.random.wrap_key_data(jnp.asarray(keys))
    got = trt.sampling_retrieve(_t(probs), keys, 12).numpy()
    want, _ = jrt.sampling_retrieve_batch(jnp.asarray(probs), jkeys, 12)
    np.testing.assert_array_equal(got, np.asarray(want))
    a = trt.akr_progressive(_t(probs), keys, theta=0.9, n_max=16)
    b = jrt.akr_progressive_batch(jnp.asarray(probs), jkeys, theta=0.9,
                                  n_max=16)
    np.testing.assert_array_equal(a.draws.numpy(), np.asarray(b.draws))
    np.testing.assert_array_equal(a.n_drawn.numpy(), np.asarray(b.n_drawn))


def test_topk_retrieve_matches_reference():
    rng = np.random.default_rng(1)
    sims = np.round(rng.random((3, 50)), 1).astype(np.float32)   # ties
    valid = rng.random(50) < 0.8
    got = trt.topk_retrieve(_t(sims), _t(valid), 7).numpy()
    want = np.stack([np.asarray(jrt.topk_retrieve(
        jnp.asarray(s), jnp.asarray(valid), 7)) for s in sims])
    np.testing.assert_array_equal(got, want)


def test_expand_gather_matches_reference():
    rng = np.random.default_rng(5)
    cap, k, n = 20, 8, 12
    members = rng.integers(0, 1000, (2, cap, k)).astype(np.int32)
    counts = rng.integers(0, k + 1, (2, cap)).astype(np.int32)
    draws = rng.integers(-1, cap, (2, 3, n)).astype(np.int32)
    valid = rng.random((2, 3, n)) < 0.8
    u = tmem.VenusMemory.expand_u(0, n)
    np.testing.assert_array_equal(u, jmem.VenusMemory.expand_u(0, n))
    fids, ok = tmem.expand_gather(_t(members), _t(counts), _t(draws),
                                  _t(valid), _t(u))
    for s in range(2):
        jf, jok = jmem.expand_gather(
            jnp.asarray(members[s]), jnp.asarray(counts[s]),
            jnp.asarray(draws[s]), jnp.asarray(valid[s]),
            jnp.asarray(u, jnp.int32))
        np.testing.assert_array_equal(ok[s].numpy(), np.asarray(jok))
        np.testing.assert_array_equal(fids[s].numpy()[ok[s].numpy()],
                                      np.asarray(jf)[np.asarray(jok)])


# ---------------------------------------------------------------------------
# memory and arena
# ---------------------------------------------------------------------------


def _rows(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _insert_both(tm, jm, rng, n, base):
    e = _rows(rng, n, tm.dim)
    members = [list(range(base + 10 * j, base + 10 * j + 1 + j % 4))
               for j in range(n)]
    kw = dict(scene_ids=[base] * n, index_frames=list(range(base,
                                                            base + n)),
              member_lists=members)
    a = tm.insert_batch(e, **kw)
    b = jm.insert_batch(e, **kw)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_arena_inserts_match_reference(dtype):
    """Two sessions, several ticks: the arena buffers and windows equal
    the reference arena's (int8 rows bit-equal: same quantiser)."""
    cap, d, k = 16, 8, 4
    ta = tmem.MemoryArena(cap, d, k, index_dtype=dtype, device="cpu")
    ja = jmem.MemoryArena(cap, d, k, index_dtype=dtype)
    tms, jms = [], []
    for _ in range(2):
        ts, js = ta.add_session(), ja.add_session()
        assert ts == js
        tms.append(tmem.VenusMemory(cap, d, k, arena=ta, slot=ts,
                                    index_dtype=dtype))
        jms.append(jmem.VenusMemory(cap, d, k, arena=ja, slot=js,
                                    index_dtype=dtype))
    rng = np.random.default_rng(0)
    for tick in range(3):
        with ta.deferred_appends(), ja.deferred_appends():
            for s in range(2):
                _insert_both(tms[s], jms[s], rng, 2 + s + tick, 100 * tick)
    for f in ("emb", "members", "member_count", "index_frame"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)))
    if dtype == "int8":
        np.testing.assert_array_equal(ta.emb_scale.numpy(),
                                      np.asarray(ja.emb_scale))
    np.testing.assert_array_equal(ta.device_windows().numpy(),
                                  np.asarray(ja.device_windows()))
    np.testing.assert_array_equal(ta.device_valid().numpy(),
                                  np.asarray(ja.device_valid()))


def test_sliding_window_wrap_matches_reference():
    cap, d, k = 10, 8, 4
    ta = tmem.MemoryArena(cap, d, k, device="cpu")
    ja = jmem.MemoryArena(cap, d, k)
    tm = tmem.VenusMemory(cap, d, k, arena=ta, slot=ta.add_session(),
                          eviction="sliding_window")
    jm = jmem.VenusMemory(cap, d, k, arena=ja, slot=ja.add_session(),
                          eviction="sliding_window")
    rng = np.random.default_rng(1)
    for tick in range(5):                      # 5 x 3 rows into 10
        with ta.deferred_appends(), ja.deferred_appends():
            _insert_both(tm, jm, rng, 3, 100 * tick)
        assert tm.window == jm.window
    assert tm.head != 0                        # the ring wrapped
    assert tm.min_live_frame() == jm.min_live_frame()
    assert tm.io_stats["evicted_rows"] == jm.io_stats["evicted_rows"]
    for f in ("emb", "members", "member_count", "index_frame"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)))
    np.testing.assert_array_equal(ta.device_valid().numpy(),
                                  np.asarray(ja.device_valid()))


def test_capacity_guard_and_later_policies():
    m = tmem.VenusMemory(1, 4, device="cpu")
    m.insert_cluster(np.ones(4, np.float32), scene_id=0, index_frame=0,
                     member_frames=[0])
    with pytest.raises(RuntimeError):
        m.insert_cluster(np.ones(4, np.float32), scene_id=0, index_frame=1,
                         member_frames=[1])
    # the merging policies run now (held against the reference in
    # test_torch_lifecycle.py and test_torch_tier.py)
    for policy in ("cluster_merge", "consolidate"):
        m = tmem.VenusMemory(2, 4, eviction=policy, coarse_capacity=2,
                             coarse_block=2, device="cpu")
        for f in range(3):
            m.insert_cluster(np.ones(4, np.float32), scene_id=0,
                             index_frame=f, member_frames=[f])
        assert m.eviction.name == policy and m.size == 2
        assert m.io_stats["evicted_rows"] == 1


def test_slot_reuse_and_zero_restacks():
    """Close → the slot goes on the free-list, the next session recycles
    it (rows zeroed in place, no growth), and queries never restack."""
    worlds = [VideoWorld(WorldConfig(n_scenes=2, seed=40 + s))
              for s in range(3)]
    cfg = VenusConfig(memory_capacity=64)
    mgr = SessionManager(cfg, PixelEmbedder(dim=16), embed_dim=16,
                         device="cpu")
    for sid, w in enumerate(worlds):
        mgr.create_session(sid)
        mgr.ingest_tick({sid: w.frames})
    mgr.flush()
    a = mgr.arena
    assert a.io_stats["grows"] == 3 and a.n_sessions == 3
    slot = mgr[1].memory.slot
    assert int(a.member_count[slot].sum()) > 0
    mgr.close_session(1)
    assert a.free_slots == [slot]
    # a free slot is a masked-out padding lane
    res = mgr.query_batch_cross([0, 2], query_embs=np.eye(16)[:2])
    assert all(len(r.frame_ids) for r in res)
    assert mgr.scan_lanes([0, 2]) == (0, None, 2)
    mgr.create_session(7)
    assert mgr[7].memory.slot == slot
    assert a.io_stats["slot_reuses"] == 1 and a.io_stats["grows"] == 3
    assert int(a.member_count[slot].sum()) == 0
    assert not a.emb[slot].any()
    mgr.ingest_tick({7: worlds[1].frames})
    mgr.flush([7])
    res = mgr.query_batch_cross([0, 7, 2], query_embs=np.eye(16)[:3],
                                budget=5, use_akr=False)
    seen = {s: mgr[s].stats["frames_seen"] for s in (0, 7, 2)}
    for sid, r in zip((0, 7, 2), res):
        assert len(r.frame_ids) and r.frame_ids.max() < seen[sid]
    assert mgr.io_stats["stack_rebuilds"] == 0


def test_frame_store_trim():
    fs = tmem.FrameStore()
    fs.append(np.zeros((3, 4, 4, 3)))
    fs.append(np.ones((2, 4, 4, 3)))
    assert len(fs) == 5 and fs.get([0, 4])[1].max() == 1.0
    assert fs.trim(2) == 2 and fs.base == 2 and len(fs) == 5
    with pytest.raises(IndexError):
        fs.get([1])
    assert fs.get([2, 4]).shape == (2, 4, 4, 3)


def test_detached_memories_match_arena():
    """``use_arena=False``: per-session memories stacked on demand answer
    exactly like the arena, and each rebuild of the stack is counted."""
    worlds = [VideoWorld(WorldConfig(n_scenes=2, seed=50 + s))
              for s in range(2)]
    cfg = VenusConfig(memory_capacity=64, index_dtype="int8")
    mgrs = [SessionManager(cfg, PixelEmbedder(dim=16), embed_dim=16,
                           use_arena=arena, device="cpu")
            for arena in (True, False)]
    for m in mgrs:
        for sid, w in enumerate(worlds):
            m.create_session(sid)
            m.ingest_tick({sid: w.frames})
        m.flush()
    qe = np.eye(16, dtype=np.float32)[:4]
    for kw in (dict(), dict(budget=6, use_akr=False)):
        a, b = (m.query_batch_cross([0, 1, 1, 0], query_embs=qe, **kw)
                for m in mgrs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.frame_ids, y.frame_ids)
            np.testing.assert_array_equal(x.draws, y.draws)
    assert mgrs[0].io_stats["stack_rebuilds"] == 0
    assert mgrs[1].io_stats["stack_rebuilds"] == 2   # emb + members, once


# ---------------------------------------------------------------------------
# the reference's int8 arena cases (tests/test_fused_retrieval.py)
# ---------------------------------------------------------------------------


def test_int8_slot_recycle_resets_scales():
    """Twin of the reference's case: a recycled int8 slot starts with its
    row scales zeroed."""
    worlds = [VideoWorld(WorldConfig(n_scenes=3 + s, seed=160 + s))
              for s in range(2)]
    mgr = SessionManager(VenusConfig(index_dtype="int8"),
                         PixelEmbedder(dim=64), embed_dim=64, device="cpu")
    for sid, w in enumerate(worlds):
        mgr.create_session(sid)
        for i in range(0, w.total_frames, 96):
            mgr.ingest_tick({sid: w.frames[i:i + 96]})
    mgr.flush()
    assert bool((mgr.arena.emb_scale[0] > 0).any())
    mgr.close_session(0)
    mgr.create_session(5)
    assert mgr[5].memory.slot == 0              # recycled, not grown
    assert bool((mgr.arena.emb_scale[0] == 0).all())


def test_int8_topk_recall_drift_bounded():
    """Twin of the reference's case: on clustered rows int8 top-k overlaps
    f32 top-k ≥ 0.9 on average."""
    rng = np.random.default_rng(11)
    c, per, d, k = 8, 32, 64, 16
    centers = rng.standard_normal((c, d)).astype(np.float32)
    rows = np.repeat(centers, per, 0) + 0.15 * rng.standard_normal(
        (c * per, d)).astype(np.float32)
    q8 = _t(tmem.quantise_rows(rows)[0])
    q32 = _t(rows)
    valid = torch.ones((rows.shape[0],), dtype=torch.bool)
    overlaps = []
    for ci in range(c):
        query = _t((centers[ci] + 0.05 * rng.standard_normal(d)).astype(
            np.float32))[None]
        top32 = trt.topk_retrieve(
            tops.similarity(query, q32, tau=0.1, valid=valid)[0][0],
            valid, k).numpy()
        top8 = trt.topk_retrieve(
            tops.similarity(query, q8, tau=0.1, valid=valid)[0][0],
            valid, k).numpy()
        overlaps.append(len(set(top32) & set(top8)) / k)
    assert np.mean(overlaps) >= 0.9, overlaps
