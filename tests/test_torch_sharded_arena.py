"""The port's sharded, double-buffered memory path held against the JAX
reference on the CPU, at the reference tests' sizes (``PixelEmbedder(dim=
64)``, ``VenusConfig(max_partition_len=48)``, two worlds of 4 and 5
scenes, three ticks of 64 frames).

* K == 1 (a mesh whose ``model`` axis has size 1) is the unsharded
  arena: draws and frame ids equal to the reference's K == 1 mesh
  manager, arena buffers bit-equal to the port's unsharded manager,
  single-slot growth, no sharded launch.
* Double buffering is a scheduling change only: after every tick the
  front buffers are bitwise the single-buffer state, and queries answer
  like the reference's double-buffered manager.
* K > 1 runs on a mesh naming the CPU K times, the per-slab code a box
  with K cards runs. The reference's own K > 1 run raises on this JAX
  (``ShardingTypeError`` in its slot reset and append scatter), so the
  port is held to the reference's contract instead: draw for draw the
  reference's UNSHARDED manager.
* The ops-level sharded routes of #1 and #3 are bit-equal to the single
  launch for every canonical valid form.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.queryplan import QuerySpec as JSpec
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.data.video import OracleEmbedder as JOracle
from repro.data.video import PixelEmbedder as JPixel
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.core.convert import arena_from_numpy
from repro_torch.core.memory import MemoryArena
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.data.video import PixelEmbedder, VideoWorld, WorldConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import (data_axes, make_host_mesh,
                                     make_memory_mesh)
from repro_torch.launch.sharding import mesh_axis_size, slab_devices
from repro_torch.serving.venus_service import VenusService

CFG = dict(max_partition_len=48)
EVICT_CFG = dict(max_partition_len=32, memory_capacity=16,
                 eviction="sliding_window")
FINE = ("emb", "members", "member_count", "index_frame")


def cpu_mesh(k):
    return make_memory_mesh(k, devices=["cpu"] * k)


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_scan_counts()
    yield


def _worlds(n, port=True):
    return [VideoWorld(WorldConfig(n_scenes=4 + s, seed=20 + s)) if port
            else JWorld(JWorldConfig(n_scenes=4 + s, seed=20 + s))
            for s in range(n)]


def _port(cfg=CFG, **kw):
    kw.setdefault("device", None if "mesh" in kw else "cpu")
    return SessionManager(VenusConfig(**cfg), PixelEmbedder(dim=64),
                          embed_dim=64, **kw)


def _ref(cfg=CFG, **kw):
    return JManager(JConfig(**cfg), JPixel(dim=64), embed_dim=64, **kw)


def _chunk(w, t, chunk=64):
    lo = (t * chunk) % max(w.total_frames - chunk, 1)
    return np.asarray(w.frames[lo:lo + chunk], np.float32)


def _tick(mgr, stream_map, t):
    mgr.ingest_tick({sid: _chunk(w, t) for sid, w in stream_map.items()})


def _queries(qsids, seed0):
    worlds = _worlds(max(qsids) + 1, port=False)
    return np.stack([
        JOracle(worlds[s], dim=64).embed_queries(
            worlds[s].make_queries(1, seed=seed0 + j))[0]
        for j, s in enumerate(qsids)])


def _assert_same(got, want, frames=True):
    """Draws, n_drawn and (``frames``) frame ids equal. Top-k's frame ids
    are index frames, which the packages may pick apart on two-member
    clusters (ROADMAP Queue 3): against the reference top-k compares
    draws, and the frame ids are held to the unsharded port."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.draws, b.draws)
        if frames:
            np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        assert a.n_drawn == b.n_drawn


def _front(mgr, sid, name):
    return mgr.arena.slot_view(name, mgr[sid].memory.slot)


def _assert_fronts_equal(got, want, sids, label=""):
    """Each session's front rows bit-equal (slots may differ)."""
    for sid in sids:
        for name in FINE:
            assert torch.equal(_front(got, sid, name), _front(want, sid, name)
                               ), f"{label} session {sid} {name}"


def _ingest(mgr, worlds, ticks=3):
    sids = [mgr.create_session() for _ in worlds]
    for t in range(ticks):
        _tick(mgr, dict(zip(sids, worlds)), t)
    return sids


QSIDS = [0, 1, 1, 0]


def _ask(mgr, sids, qes, strategy="akr", budget=None, fused=True):
    """One group of ``QSIDS`` queries through ``execute(plan(...))``."""
    spec = JSpec if isinstance(mgr, JManager) else QuerySpec
    return mgr.execute(mgr.plan([
        spec(sid=sids[s], embedding=qes[j], strategy=strategy,
             budget=budget) for j, s in enumerate(QSIDS)]), fused=fused)


@pytest.fixture(scope="module")
def oracle():
    """The reference's unsharded manager after three ticks, and its
    answers to the akr, sampling and top-k groups."""
    mgr = _ref()
    sids = _ingest(mgr, _worlds(2, port=False))
    qes = _queries(QSIDS, 330)
    res = {s: _ask(mgr, sids, qes, strategy=s, budget=b)
           for s, b in (("akr", None), ("sampling", 16), ("topk", 8))}
    return mgr, qes, res


@pytest.fixture(scope="module")
def port_plain():
    """The port's unsharded manager over the same ticks."""
    mgr = _port()
    return mgr, _ingest(mgr, _worlds(2))


# ---------------------------------------------------------------------------
# the mesh and the slab layout
# ---------------------------------------------------------------------------


def test_mesh_shapes_and_slabs():
    m = make_host_mesh(model=2, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2}
    assert m.axis_names == ("data", "model") and len(m.devices) == 4
    assert data_axes(m) == ("data",)
    k = cpu_mesh(3)
    assert k.shape == {"data": 1, "model": 3}
    assert mesh_axis_size(k) == 3 and mesh_axis_size(None) == 1
    assert mesh_axis_size(k, "pod") == 1
    assert make_memory_mesh(0, devices=["cpu"] * 5).shape["model"] == 5
    assert slab_devices(k) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="last axis"):
        slab_devices(make_host_mesh(model=2, devices=["cpu"] * 4), "data")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_memory_mesh()


# ---------------------------------------------------------------------------
# K == 1: the unsharded arena
# ---------------------------------------------------------------------------


def test_k1_mesh_matches_reference_and_unsharded(oracle, port_plain):
    """A mesh whose model axis has size 1 changes nothing: draws and
    frame ids equal to the reference's K == 1 mesh manager's, arena
    buffers bit-equal to the port's unsharded ones (one tensor a
    buffer), single-slot growth, no sharded launch."""
    jmgr = _ref(mesh=jmake_host_mesh(model=1), double_buffer=False)
    jsids = _ingest(jmgr, _worlds(2, port=False))
    plain, psids = port_plain
    mgr = _port(mesh=cpu_mesh(1), double_buffer=False)
    sids = _ingest(mgr, _worlds(2))
    assert mgr.arena.n_shards == 1 and not mgr.arena.double_buffer
    assert mgr.arena.n_sessions == plain.arena.n_sessions == 2
    assert mgr.arena.virgin_slots == [] and mgr.arena.io_stats["grows"] == 2
    for name in FINE:
        got = getattr(mgr.arena, name)
        assert isinstance(got, torch.Tensor) and got is mgr.arena.slabs(
            name)[0]
        assert torch.equal(got, getattr(plain.arena, name)), name
    _, qes, _ = oracle
    tops.reset_scan_counts()
    for strat, budget in (("akr", None), ("topk", 8)):
        got = _ask(mgr, sids, qes, strategy=strat, budget=budget)
        _assert_same(got, _ask(jmgr, jsids, qes, strategy=strat,
                               budget=budget), frames=strat != "topk")
        _assert_same(got, _ask(plain, psids, qes, strategy=strat,
                               budget=budget))
    assert tops.scan_counts()["sharded_stack_launches"] == 0
    assert mgr.io_stats["sharded_group_scans"] == 0


# ---------------------------------------------------------------------------
# double buffering
# ---------------------------------------------------------------------------


def test_double_buffer_front_matches_single_buffer():
    """After every tick the front buffers are bitwise the single-buffer
    state; queries answer like the reference's double-buffered manager,
    and the replay counters are the reference's."""
    worlds, jworlds = _worlds(2), _worlds(2, port=False)
    single = _port(double_buffer=False)
    double = _port(double_buffer=True)
    jdouble = _ref(double_buffer=True)
    sids = [single.create_session() for _ in range(2)]
    sids_d = [double.create_session() for _ in range(2)]
    jsids = [jdouble.create_session() for _ in range(2)]
    for t in range(3):
        _tick(single, dict(zip(sids, worlds)), t)
        _tick(double, dict(zip(sids_d, worlds)), t)
        _tick(jdouble, dict(zip(jsids, jworlds)), t)
        for name in FINE:
            assert torch.equal(getattr(double.arena, name),
                               getattr(single.arena, name)), (name, t)
    qes = _queries([0, 1, 1], 310)
    qs = [0, 1, 1]
    got = double.query_batch_cross([sids_d[s] for s in qs], query_embs=qes)
    _assert_same(got, jdouble.query_batch_cross([jsids[s] for s in qs],
                                                query_embs=qes))
    _assert_same(got, single.query_batch_cross([sids[s] for s in qs],
                                               query_embs=qes))
    io, jio = double.arena.io_stats, jdouble.arena.io_stats
    assert io["double_flushes"] == io["appends"] == jio["double_flushes"] > 0
    assert io["carry_rows"] == jio["carry_rows"] > 0
    assert single.arena.io_stats["double_flushes"] == 0


def _recycle_case(pkg_mgr, worlds, fresh=False):
    """The reference's scenario: close a session right after a tick (its
    blocks sit in the carry), recycle its slot, ingest; or, ``fresh``,
    the same streams into a manager where the slot was never used."""
    mgr = pkg_mgr()
    a, b = mgr.create_session(), mgr.create_session()
    if fresh:
        _tick(mgr, {a: worlds[0]}, 0)
        new = b
    else:
        _tick(mgr, {a: worlds[0], b: worlds[1]}, 0)
        freed = mgr[b].memory.slot
        mgr.close_session(b)
        new = mgr.create_session()
        assert mgr[new].memory.slot == freed
    for t in (1, 2):
        _tick(mgr, {a: worlds[0], new: worlds[2]}, t)
    return mgr, [a, new]


def test_double_buffer_slot_recycle_filters_carry():
    """A recycled slot is not resurrected by last tick's replay (the
    reference's scenario): the recycled lane holds and answers what a
    fresh manager's does."""
    worlds = _worlds(3)
    mgr, sids = _recycle_case(lambda: _port(double_buffer=True), worlds)
    fresh, fsids = _recycle_case(lambda: _port(double_buffer=False), worlds,
                                 fresh=True)
    assert mgr.arena.io_stats["slot_reuses"] == 1
    qes = _queries([0, 2], 320)
    _assert_same(mgr.query_batch_cross(sids, query_embs=qes),
                 fresh.query_batch_cross(fsids, query_embs=qes))
    _assert_fronts_equal(mgr, fresh, [sids[0]])
    for name in FINE:
        assert torch.equal(_front(mgr, sids[1], name),
                           _front(fresh, fsids[1], name)), name


# ---------------------------------------------------------------------------
# K > 1 on CPU shards, held to the reference's unsharded manager
# ---------------------------------------------------------------------------


def test_block_growth_and_balanced_placement():
    """The arena grows in blocks of K slots, balances live sessions over
    the slabs, recycles a freed slot without growth, and keeps each
    slot's rows across a reshard."""
    k = 4
    a = MemoryArena(16, 8, mesh=cpu_mesh(k))
    assert a.n_shards == k and a.device == torch.device("cpu")
    s0 = a.add_session()
    assert a.n_sessions == k and a.io_stats["grows"] == 1
    assert sorted(a.virgin_slots + [s0]) == list(range(k))
    slots = [a.add_session() for _ in range(k - 1)]
    assert a.virgin_slots == [] and a.io_stats["grows"] == 1
    assert sorted([s0] + slots) == list(range(k))
    assert {a._shard_of(s) for s in [s0] + slots} == set(range(k))
    rows = np.arange(3 * 8, dtype=np.float32).reshape(3, 8) + 1
    for s in range(k):
        a.append(s, 0, rows + s, np.zeros((3, 128), np.int32),
                 np.ones(3, np.int32), np.arange(3) + s, (0, 3))
    nxt = a.add_session()                     # block 2: a reshard
    assert a.n_sessions == 2 * k and a.io_stats["grows"] == 2
    assert [x.shape[0] for x in a.slabs("emb")] == [2] * k
    for s in range(k):
        np.testing.assert_array_equal(a.slot_view("emb", s)[:3].numpy(),
                                      rows + s)
    assert a.whole("emb").shape == (2 * k, 16, 8)   # a copy, for tools
    with pytest.raises(RuntimeError, match="4-slab arena"):
        a.emb
    a.release_slot(nxt)
    with pytest.raises(AssertionError):
        a.release_slot(a.virgin_slots[0])     # never allocated
    assert a.add_session() == nxt             # recycled, not grown
    assert a.io_stats["grows"] == 2 and a.io_stats["slot_reuses"] == 1


@pytest.fixture(scope="module")
def sharded4():
    mgr = _port(mesh=cpu_mesh(4))
    return mgr, _ingest(mgr, _worlds(2))


def test_sharded_manager_matches_reference_oracle(oracle, port_plain,
                                                  sharded4):
    """ACCEPTANCE: a manager sharded over 4 CPU slabs answers the akr,
    sampling and top-k groups draw for draw like the reference's
    unsharded manager, with every session's rows bit-equal to the port's
    unsharded arena's; each group's scan ran once a slab."""
    jmgr, qes, want = oracle
    mgr, sids = sharded4
    plain, psids = port_plain
    assert mgr.double_buffer and mgr.arena.double_buffer  # on with a mesh
    assert mgr.arena.n_sessions == 4 and mgr.arena.n_sessions % 4 == 0
    _assert_fronts_equal(mgr, plain, sids)
    io = dict(mgr.arena.io_stats)
    assert io["double_flushes"] == io["appends"] == 3
    assert io["carry_rows"] > 0
    mgr.reset_io_stats()
    for strat, budget in (("akr", None), ("sampling", 16), ("topk", 8)):
        tops.reset_scan_counts()
        got = _ask(mgr, sids, qes, strategy=strat, budget=budget)
        assert tops.scan_counts()["sharded_stack_launches"] == 1
        _assert_same(got, want[strat], frames=strat != "topk")
        if strat == "topk":
            _assert_same(got, _ask(plain, psids, qes, strategy=strat,
                                   budget=budget))
    assert mgr.io_stats["sharded_group_scans"] == 3
    assert mgr.io_stats["stack_rebuilds"] == 0


@pytest.mark.parametrize("strategy", ["bolt", "mdf", "aks", "uniform",
                                      "akr_dense"])
def test_sharded_dense_groups_match(strategy, port_plain, sharded4,
                                    oracle):
    """The dense groups (and ``fused=False``, with seeded specs: the
    shared managers' chains stand apart) over the slabs give the
    unsharded port's draws and frame ids."""
    _, qes, _ = oracle
    mgr, sids = sharded4
    plain, psids = port_plain
    dense = strategy == "akr_dense"
    specs = lambda ss: [QuerySpec(sid=ss[s], embedding=qes[j],
                                  strategy=strategy.split("_")[0],
                                  budget=None if dense else 8,
                                  seed=7 + j if dense else None)
                        for j, s in enumerate(QSIDS)]
    tops.reset_scan_counts()
    got = mgr.execute(mgr.plan(specs(sids)), fused=not dense)
    assert tops.scan_counts()["sharded_stack_launches"] == 1
    _assert_same(got, plain.execute(plain.plan(specs(psids)),
                                    fused=not dense))


def test_sharded_eviction_ring_matches_reference():
    """Ring sessions (sliding-window eviction far past capacity) keep
    their windows under sharding: the (S, 2) windows split along the
    slot axis are each slab's valid operand."""
    worlds, jworlds = _worlds(2), _worlds(2, port=False)
    jmgr = _ref(EVICT_CFG)
    mgr = _port(EVICT_CFG, mesh=cpu_mesh(4))
    jsids = [jmgr.create_session() for _ in range(2)]
    sids = [mgr.create_session() for _ in range(2)]
    for t in range(8):                         # far past capacity
        _tick(jmgr, dict(zip(jsids, jworlds)), t)
        _tick(mgr, dict(zip(sids, worlds)), t)
    for sid in sids:
        assert mgr[sid].memory.io_stats["evicted_rows"] > 0
        assert mgr[sid].memory.window == jmgr[sid].memory.window
    qs = [0, 1, 1]
    qes = _queries(qs, 340)
    _assert_same(mgr.query_batch_cross([sids[s] for s in qs],
                                       query_embs=qes),
                 jmgr.query_batch_cross([jsids[s] for s in qs],
                                        query_embs=qes))


def test_shard_gather_bytes_are_the_epilogue(sharded4, oracle):
    """The fused sharded launch brings back its 8 raw outputs — counts
    and drawn_p (S,Q,T), top-k (S,Q,K) twice, p_last, m, l, p_max
    (S,Q,1), 4 bytes each — never an (S,Q,cap) score tensor."""
    mgr, sids = sharded4
    _, qes, _ = oracle
    tops.reset_scan_counts()
    _ask(mgr, sids, qes)                      # akr: T = n_max, K = 1
    c = tops.scan_counts()
    s, q, cap = mgr.arena.n_sessions, 2, mgr.arena.capacity
    t, k = mgr.cfg.n_max, 1
    assert c["sharded_stack_launches"] == 1
    assert c["shard_gather_bytes"] == 4 * s * q * (2 * t + 2 * k + 4)
    assert 0 < c["shard_gather_bytes"] < s * q * cap * 4


def test_queries_never_build_a_whole_buffer(sharded4, oracle, monkeypatch):
    """At K > 1 ``arena.whole`` is a concatenation for tools; the ingest
    and every query path read the slabs only."""
    mgr, sids = sharded4
    _, qes, _ = oracle

    def whole(self, name):
        raise AssertionError(f"a whole {name} was built")
    monkeypatch.setattr(MemoryArena, "whole", whole)
    _tick(mgr, dict(zip(sids, _worlds(2))), 3)
    for strat in ("akr", "sampling", "topk", "bolt", "mdf", "uniform"):
        _ask(mgr, sids, qes, strategy=strat, budget=8)
    mgr.execute(mgr.plan([QuerySpec(sid=sids[0], embedding=qes[0])]),
                fused=False)
    mgr[sids[0]].memory.search(qes[:1], tau=0.1)
    mgr[sids[1]].memory.expand_draws_device(np.arange(4), np.ones(4, bool))
    with pytest.raises(AssertionError, match="whole emb"):
        mgr.arena.whole("emb")


def test_service_reports_arena_shards(sharded4):
    mgr, _ = sharded4
    assert VenusService(mgr, None).io_stats()["arena_shards"] == 4
    plain = _port()
    plain.create_session()
    assert VenusService(plain, None).io_stats()["arena_shards"] == 1


# ---------------------------------------------------------------------------
# the hierarchical tier and standing queries under sharding
# ---------------------------------------------------------------------------


TIER_DIM = 32
TIER_CFG = dict(memory_capacity=128, member_cap=8, eviction="consolidate",
                coarse_capacity=32, coarse_block=16, coarse_topb=4)


class _ArrayEmbedder:
    def embed_queries(self, texts):
        raise AssertionError("tests pass explicit embeddings")

    def embed_frames(self, frames, aux=None, frame_ids=None):
        raise AssertionError("tests insert rows directly")


def _tier_feed(mgr, sid, rows, fid0=0):
    mem = mgr.sessions[sid].memory
    for lo in range(0, len(rows), 16):
        batch = rows[lo:lo + 16]
        fids = np.arange(fid0 + lo, fid0 + lo + len(batch))
        with mgr.arena.deferred_appends():
            mem.insert_batch(batch, scene_ids=[0] * len(batch),
                             index_frames=fids,
                             member_lists=[[int(f)] for f in fids])


def test_sharded_two_stage_matches_reference():
    """ACCEPTANCE: two-stage retrieval on a 4-slab arena (stage 1 once a
    slab, each slab gathering its own winners' candidates, stage 2
    unsharded) answers like the reference's unsharded tiered manager —
    top-k and akr, over two sessions — and the coarse plus gathered
    bytes stay below one flat scan."""
    rng = np.random.default_rng(23)
    cen = rng.normal(size=(8, TIER_DIM)).astype(np.float32)
    cen /= np.linalg.norm(cen, axis=-1, keepdims=True)
    j = JManager(JConfig(**TIER_CFG), _ArrayEmbedder(), embed_dim=TIER_DIM)
    t = SessionManager(VenusConfig(**TIER_CFG), _ArrayEmbedder(),
                       embed_dim=TIER_DIM, mesh=cpu_mesh(4))
    for sid in range(2):
        labels = rng.integers(0, 8, size=3 * TIER_CFG["memory_capacity"])
        rows = cen[labels] + 0.05 * rng.normal(size=(len(labels), TIER_DIM))
        rows = (rows / np.linalg.norm(rows, axis=-1, keepdims=True)
                ).astype(np.float32)
        for m in (j, t):
            m.create_session(sid)
            _tier_feed(m, sid, rows, fid0=10_000 * sid)
    assert t.arena.n_shards == 4 and t.arena.has_consolidated()
    for sid in range(2):
        for f in ("_coarse_emb", "_coarse_members", "_emb", "_head"):
            np.testing.assert_array_equal(getattr(t[sid].memory, f),
                                          getattr(j[sid].memory, f))
    tops.reset_scan_counts()
    t.execute(t.plan([QuerySpec(sid=0, embedding=cen[0], strategy="topk",
                                budget=8)]), coarse=False)
    flat_bytes = tops.scan_counts()["scan_bytes"]
    tops.reset_scan_counts()
    for strat, budget in (("topk", 8), ("akr", None)):
        specs = [(s, jx) for jx in range(4) for s in (0, 1)]
        got = t.execute(t.plan([QuerySpec(sid=s, embedding=cen[jx],
                                          strategy=strat, budget=budget)
                                for s, jx in specs]))
        want = j.execute(j.plan([JSpec(sid=s, embedding=cen[jx],
                                       strategy=strat, budget=budget)
                                 for s, jx in specs]))
        _assert_same(got, want)
    c = tops.scan_counts()
    assert t.io_stats["two_stage_groups"] == 2
    assert t.io_stats["sharded_group_scans"] == 3   # with the flat one
    assert c["sharded_stack_launches"] == 2 and c["two_stage_scans"] == 2
    assert t.io_stats["stack_rebuilds"] == 0
    coarse_per_group = c["coarse_scan_bytes"] // 2
    fine_per_query = (TIER_CFG["coarse_topb"] * TIER_CFG["coarse_block"]
                      * TIER_DIM * 4)
    assert coarse_per_group + fine_per_query < flat_bytes


def _block_chunk(rng, n=16, hw=16, pool=8):
    blocks = rng.uniform(-1, 1, (hw // pool, hw // pool, 3)
                         ).astype(np.float32)
    frame = np.kron(blocks, np.ones((pool, pool, 1), np.float32))
    return np.broadcast_to(frame, (n,) + frame.shape).copy()


def _alert_stream(mgr, spec_cls):
    """A target scene alternating with noise through the real ingest
    path, one embedding standing spec on it (the reference's case)."""
    rng = np.random.default_rng(15)
    sid = mgr.create_session()
    target = _block_chunk(np.random.default_rng(99))
    emb = np.asarray(mgr.embedder.embed_frames(target)[0], np.float32)
    mgr.register_standing(sid, spec_cls(sid=sid, embedding=emb,
                                        strategy="topk", budget=4),
                          threshold=0.9, hysteresis=0.05)
    for t in range(6):
        mgr.ingest_tick({sid: target if t % 2 == 0 else _block_chunk(rng)})
    mgr.flush()
    return mgr.poll_alerts()


def test_sharded_manager_same_alerts_and_bytes():
    """A sharded manager takes the identical standing path — the compact
    slab launch, never sharded — with the reference's alerts and the
    unsharded port's standing bytes."""
    cfg = dict(max_partition_len=64, scene_threshold=0.075)
    want = _alert_stream(_ref(cfg), JSpec)
    tops.reset_scan_counts()
    plain_alerts = _alert_stream(_port(cfg), QuerySpec)
    plain_bytes = tops.scan_counts()["standing_scan_bytes"]
    tops.reset_scan_counts()
    mgr = _port(cfg, mesh=cpu_mesh(4))
    got = _alert_stream(mgr, QuerySpec)
    c = tops.scan_counts()
    assert len(got) == len(want) == len(plain_alerts) == 3
    for a, b, p in zip(got, want, plain_alerts):
        assert (a.sid, a.spec_id, a.tick) == (b.sid, b.spec_id, b.tick)
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5)
        assert a.score == p.score
    assert c["standing_scan_bytes"] == plain_bytes > 0
    assert c["sharded_stack_launches"] == 0
    assert mgr.io_stats["stack_rebuilds"] == 0


def test_arena_from_numpy_lays_reference_rows_in_slabs(oracle):
    """The reference's arena carried into a 4-slab, double-buffered port
    arena answers like the reference."""
    jmgr, qes, want = oracle
    a = jmgr.arena
    keys = np.stack([np.asarray(jax.random.key_data(jmgr[s].key))
                     for s in sorted(jmgr.sessions)])
    mgr = arena_from_numpy(
        VenusConfig(**CFG), PixelEmbedder(dim=64),
        emb=np.asarray(a.emb), members=np.asarray(a.members),
        member_count=np.asarray(a.member_count),
        index_frame=np.asarray(a.index_frame), sizes=a.sizes,
        heads=a.heads, keys=keys, mesh=cpu_mesh(4), double_buffer=True)
    assert mgr.arena.n_sessions == 4 and mgr.arena.n_shards == 4
    for s in range(2):
        np.testing.assert_array_equal(
            _front(mgr, s, "emb").numpy(), np.asarray(a.emb[s]))
    _assert_same(_ask(mgr, [0, 1], qes, strategy="topk", budget=8),
                 want["topk"])
    # the carried PRNG chains continue the reference's
    _assert_same(_ask(mgr, [0, 1], qes), _ask(jmgr, [0, 1], qes))


# ---------------------------------------------------------------------------
# the ops-level sharded routes of #1 and #3
# ---------------------------------------------------------------------------


def _scan_inputs(s=4, q=3, n=40, d=16, t=5, seed=0):
    rng = np.random.default_rng(seed)
    query = torch.from_numpy(rng.standard_normal((s, q, d)).astype(
        np.float32))
    index = torch.from_numpy(rng.standard_normal((s, n, d)).astype(
        np.float32))
    sizes = torch.from_numpy(rng.integers(0, n + 1, s).astype(np.int32))
    sizes[0] = 0                              # an all-invalid session
    heads = torch.from_numpy(rng.integers(0, n, s).astype(np.int32))
    targets = torch.from_numpy(rng.uniform(0, 1.05, (s, q, t)).astype(
        np.float32))
    forms = {"sizes": sizes, "windows": torch.stack([heads, sizes], 1),
             "mask": tref.as_valid_mask(torch.stack([heads, sizes], 1), n)}
    return query, index, forms, targets


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("form", ["mask", "sizes", "windows"])
def test_sharded_fused_route_bit_equal(k, form):
    query, index, forms, targets = _scan_inputs()
    valid = forms[form]
    one = tops.fused_retrieve_stack(query, index, tau=0.1, valid=valid,
                                    targets=targets, n_topk=3)
    tops.reset_scan_counts()
    got = tops.fused_retrieve_stack(query, list(index.chunk(k)), tau=0.1,
                                    valid=valid, targets=targets, n_topk=3,
                                    mesh=cpu_mesh(k))
    for f in one._fields:
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    c = tops.scan_counts()
    assert c["sharded_stack_launches"] == 1
    assert c["scan_bytes"] == index.numel() * 4
    s, q, t = targets.shape
    assert c["shard_gather_bytes"] == 4 * s * q * (2 * t + 2 * 3 + 4)
    one_k = tops.fused_retrieve_stack(query, index, tau=0.1, valid=valid,
                                      targets=targets, n_topk=3,
                                      mesh=cpu_mesh(1))
    assert all(torch.equal(getattr(one_k, f), getattr(one, f))
               for f in one._fields)
    coarse = tops.fused_retrieve_stack(query, index, tau=0.1, valid=valid,
                                       targets=targets, n_topk=3,
                                       mesh=cpu_mesh(k), tier="coarse")
    assert torch.equal(coarse.topk_i, one.topk_i)
    assert tops.scan_counts()["sharded_stack_launches"] == 2


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("form", ["mask", "sizes", "windows"])
def test_sharded_dense_route_bit_equal(k, form):
    query, index, forms, _ = _scan_inputs(seed=1)
    valid = forms[form]
    sims, probs = tops.similarity_stack(query, index, tau=0.1, valid=valid)
    tops.reset_scan_counts()
    got = tops.similarity_stack(query, index, tau=0.1, valid=valid,
                                mesh=cpu_mesh(k))
    assert torch.equal(got[0], sims) and torch.equal(got[1], probs)
    c = tops.scan_counts()
    assert c["sharded_stack_launches"] == 1
    assert c["shard_gather_bytes"] == 2 * sims.numel() * 4


def test_sharded_routes_reject_uneven_slabs():
    query, index, forms, targets = _scan_inputs(s=6)
    with pytest.raises(ValueError, match="slabs"):
        tops.similarity_stack(query, index, tau=0.1, valid=forms["sizes"],
                              mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="slabs"):
        tops.fused_retrieve_stack(query, index, tau=0.1,
                                  valid=forms["sizes"], targets=targets,
                                  n_topk=2, mesh=cpu_mesh(4))
    # standing launches are never sharded, whatever the mesh
    r = tops.fused_retrieve_stack(query, index, tau=0.1,
                                  valid=forms["sizes"], targets=targets,
                                  n_topk=2, mesh=cpu_mesh(4),
                                  tier="standing")
    assert r.draws.shape == targets.shape
