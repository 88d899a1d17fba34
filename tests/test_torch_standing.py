"""The port's standing queries held against the JAX reference on the CPU
(``repro_torch.core.standing`` and its session and service wiring).

Both packages take the same numpy rows through ``insert_batch`` inside the
arena's deferred write, as an ingest tick does, and evaluate the same
standing specs. The alert streams must agree case for case: equal
``(sid, spec_id, tick)``, equal frame ids, scores allclose at rtol 1e-5;
the trigger counters equal. Every score the port's standing launches
return is kept at least ``MARGIN`` from every threshold of its case
(checked), so float drift between the packages cannot flip a trigger.

Within the port, the determinism contract: a standing alert's score and
frame ids are bit for bit those of an ad-hoc ``topk`` plan over the same
rows in a fresh manager (f32 and int8).

The properties (replay equivalence; alert frame ids readable at fire
time) are in ``tests/test_torch_standing_properties.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.queryplan import QuerySpec as JSpec
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.data.video import PixelEmbedder as JPixel
from repro.kernels import ops as jops
from repro.serving.venus_service import VenusService as JService
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.core.standing import _pow2
from repro_torch.data.video import PixelEmbedder
from repro_torch.kernels import ops as tops
from repro_torch.serving.venus_service import VenusService

DIM = 32
MARGIN = 1e-4
FLAT = dict(memory_capacity=128, member_cap=8)

JAX = SimpleNamespace(Manager=JManager, Config=JConfig, Spec=JSpec,
                      Service=JService, kw={})
PORT = SimpleNamespace(Manager=SessionManager, Config=VenusConfig,
                       Spec=QuerySpec, Service=VenusService,
                       kw=dict(device="cpu"))


def _unit(rows):
    rows = np.asarray(rows, np.float32)
    return rows / (np.linalg.norm(rows, axis=-1, keepdims=True) + 1e-12)


class ArrayEmbedder:
    """Managers fed by direct ``insert_batch`` calls embed nothing."""

    def embed_queries(self, texts):
        raise AssertionError("tests pass explicit embeddings")

    def embed_frames(self, frames, aux=None, frame_ids=None):
        raise AssertionError("tests insert rows directly")


@pytest.fixture()
def launches(monkeypatch):
    """The port's standing launches of the test: (query, index, valid,
    n_topk, FusedRetrieval) each."""
    tops.reset_scan_counts()
    jops.reset_scan_counts()
    seen = []
    launch = tops.fused_retrieve_stack

    def capture(query, index, *, tier="fine", **kw):
        fr = launch(query, index, tier=tier, **kw)
        if tier == "standing":
            seen.append(SimpleNamespace(query=query, index=index,
                                        valid=kw["valid"], k=kw["n_topk"],
                                        fr=fr))
        return fr
    monkeypatch.setattr(tops, "fused_retrieve_stack", capture)
    return seen


def _mgr(pkg, **cfg):
    return pkg.Manager(pkg.Config(**cfg), ArrayEmbedder(), embed_dim=DIM,
                       **pkg.kw)


def _insert(mgr, sid, rows, fid0):
    """Rows straight into a session's memory inside the arena's deferred
    write; returns the physical rows."""
    mem = mgr.sessions[sid].memory
    fids = np.arange(fid0, fid0 + len(rows))
    with mgr.arena.deferred_appends():
        phys = mem.insert_batch(rows, scene_ids=[0] * len(rows),
                                index_frames=fids,
                                member_lists=[[int(f)] for f in fids])
    return np.asarray(phys)


def _evaluate(mgr, sid_phys):
    return mgr.standing.evaluate(
        mgr.sessions, {sid: [phys] for sid, phys in sid_phys.items()},
        mgr.io_stats)


def _register(pkg, mgr, sid, emb, budget, **trigger):
    return mgr.register_standing(
        sid, pkg.Spec(sid=sid, embedding=emb, strategy="topk",
                      budget=budget), **trigger)


def _rows_with_sims(rng, emb, sims):
    """Unit rows whose cosine to ``emb`` is each of ``sims`` (in the plane
    of emb and a random orthogonal direction)."""
    out = []
    for s in sims:
        r = rng.normal(size=emb.shape)
        u = r - (r @ emb) * emb
        u /= np.linalg.norm(u)
        out.append(s * emb + np.sqrt(max(1.0 - s * s, 0.0)) * u)
    return _unit(out)


def _key(alerts):
    return [(a.sid, a.spec_id, a.tick) for a in alerts]


def _assert_same_alerts(got, want):
    assert _key(got) == _key(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5)
        assert a.priority == b.priority


def _assert_margin(launches, thresholds):
    """Every scored row of the port's standing launches is ≥ MARGIN from
    every threshold of the case."""
    for ln in launches:
        v = ln.fr.topk_v.numpy()
        v = v[v > -1e29]
        for thr in thresholds:
            assert np.abs(v - thr).min() >= MARGIN, (thr, v)


def _twin_topk(rows, fids, emb, budget, index_dtype="float32"):
    """The ad-hoc oracle in the port: a fresh flat manager holding exactly
    ``rows`` answers a top-k plan → (frame ids, top score)."""
    mgr = _mgr(PORT, memory_capacity=max(128, _pow2(len(rows))),
               member_cap=8, index_dtype=index_dtype)
    sid = mgr.create_session()
    mem = mgr.sessions[sid].memory
    with mgr.arena.deferred_appends():
        mem.insert_batch(rows, scene_ids=[0] * len(rows),
                         index_frames=np.asarray(fids),
                         member_lists=[[int(f)] for f in fids])
    got = []
    launch = tops.fused_retrieve_stack

    def capture(*a, **kw):
        got.append(launch(*a, **kw))
        return got[-1]
    tops.fused_retrieve_stack = capture
    try:
        res = mgr.query_specs([QuerySpec(sid=sid, embedding=emb,
                                         strategy="topk", budget=budget)])
    finally:
        tops.fused_retrieve_stack = launch
    return np.asarray(res[0].frame_ids), got[0].topk_v[0, 0, 0]


def _assert_adhoc_bitwise(alert, rows, fids, emb, budget, index_dtype):
    """A standing alert is bit for bit the port's ad-hoc top-k over the
    same rows (its ids are the top-k's, cut at the threshold)."""
    ids, top = _twin_topk(rows, fids, emb, budget, index_dtype)
    assert torch.equal(torch.tensor(alert.score, dtype=torch.float32), top)
    np.testing.assert_array_equal(alert.frame_ids,
                                  ids[:len(alert.frame_ids)])


# ---------------------------------------------------------------------------
# differential: the same alerts as the reference, bit-equal to ad-hoc top-k
# ---------------------------------------------------------------------------


def _flat_case(pkg, index_dtype, consolidated):
    rng = np.random.default_rng(2 if consolidated else 0)
    kw = (dict(eviction="consolidate", coarse_capacity=32, coarse_block=16,
               coarse_topb=4) if consolidated else {})
    mgr = _mgr(pkg, memory_capacity=128, member_cap=8,
               index_dtype=index_dtype, **kw)
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    fid = 0
    if consolidated:
        for _ in range(5):                     # 160 rows > capacity 128
            _insert(mgr, sid, _unit(rng.normal(size=(32, DIM))), fid)
            fid += 32
        assert mgr.arena.has_consolidated()
    rows = _rows_with_sims(rng, emb, [0.2, 0.9, 0.4, 0.95, 0.1, 0.7, 0.3,
                                      0.85, 0.5, 0.6])
    spec_id = _register(pkg, mgr, sid, emb, 4, threshold=-1.0)
    fired = _evaluate(mgr, {sid: _insert(mgr, sid, rows, fid)})
    assert len(fired) == 1 and fired[0].spec_id == spec_id
    return fired, rows, np.arange(fid, fid + len(rows)), emb


@pytest.mark.parametrize("consolidated", [False, True],
                         ids=["flat", "consolidated"])
@pytest.mark.parametrize("index_dtype", ["float32", "int8"])
def test_differential_matches_reference(index_dtype, consolidated,
                                        launches):
    """S=1, flat and consolidated (the slab gathers only the tick's fine
    rows), f32 and int8: the port's alert is the reference's, and bit for
    bit its own ad-hoc top-k over the same rows."""
    got, rows, fids, emb = _flat_case(PORT, index_dtype, consolidated)
    want, *_ = _flat_case(JAX, index_dtype, consolidated)
    _assert_same_alerts(got, want)
    _assert_adhoc_bitwise(got[0], rows, fids, emb, 4, index_dtype)
    assert len(launches) == 1 and launches[0].index.dtype == (
        torch.int8 if index_dtype == "int8" else torch.float32)


def test_differential_score_bitwise_vs_direct_kernel(launches):
    """The alert's score is bit for bit a direct ``fused_retrieve_stack``
    launch over an independently built slab of the same rows."""
    rng = np.random.default_rng(1)
    mgr = _mgr(PORT, **FLAT)
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    rows = _rows_with_sims(rng, emb, [0.3, 0.8, 0.55, 0.72, 0.15])
    _register(PORT, mgr, sid, emb, 3, threshold=-1.0)
    fired = _evaluate(mgr, {sid: _insert(mgr, sid, rows, 0)})
    slab = np.zeros((1, _pow2(len(rows)), DIM), np.float32)
    slab[0, :len(rows)] = rows
    fr = tops.fused_retrieve_stack(
        torch.from_numpy(emb[None, None, :]), torch.from_numpy(slab),
        tau=0.1, valid=torch.tensor([len(rows)], dtype=torch.int32),
        targets=torch.zeros((1, 1, 1)), n_topk=3)
    assert fired[0].score == float(fr.topk_v[0, 0, 0])


def _ring_case(pkg):
    rng = np.random.default_rng(3)
    mgr = _mgr(pkg, memory_capacity=32, member_cap=8,
               eviction="sliding_window")
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    _insert(mgr, sid, _unit(rng.normal(size=(28, DIM))), 0)
    rows = _rows_with_sims(rng, emb, [0.3, 0.9, 0.5, 0.8, 0.2, 0.7, 0.6,
                                      0.4])
    _register(pkg, mgr, sid, emb, 4, threshold=-1.0)
    phys = _insert(mgr, sid, rows, 28)
    assert (np.diff(phys) < 0).any(), "the rows must wrap the ring"
    return _evaluate(mgr, {sid: phys}), rows, emb


def test_differential_ring_wrap(launches):
    """New rows whose physical slots wrap the ring gather in commit
    order: the reference's alert, and the ad-hoc top-k's bits."""
    got, rows, emb = _ring_case(PORT)
    want, *_ = _ring_case(JAX)
    _assert_same_alerts(got, want)
    _assert_adhoc_bitwise(got[0], rows, np.arange(28, 36), emb, 4,
                          "float32")


def _mixed_case(pkg):
    rng = np.random.default_rng(4)
    mgr = _mgr(pkg, **FLAT)
    sids = [mgr.create_session() for _ in range(3)]
    embs = [_unit(rng.normal(size=(1, DIM)))[0] for _ in range(3)]
    rows = [_rows_with_sims(rng, embs[0], [0.4, 0.9, 0.1, 0.7, 0.55]),
            _rows_with_sims(rng, embs[1], [0.2, 0.85, 0.6, 0.95, 0.3, 0.5,
                                           0.75, 0.1, 0.45]),
            _unit(rng.normal(size=(4, DIM)))]
    for s, b in ((0, 3), (0, 5), (1, 4)):
        _register(pkg, mgr, sids[s], embs[s], b, threshold=-1.0)
    fired = _evaluate(mgr, {sids[s]: _insert(mgr, sids[s], rows[s], 0)
                            for s in range(3)})
    return fired, rows, embs


def test_differential_mixed_session_tick(launches):
    """One tick committing rows to three sessions, two with specs of
    different budgets batched into one launch at the largest k: the
    reference's alerts, each the bits of its own ad-hoc top-k; the
    spec-less session contributes nothing."""
    got, rows, embs = _mixed_case(PORT)
    want, *_ = _mixed_case(JAX)
    _assert_same_alerts(sorted(got, key=lambda a: a.spec_id),
                        sorted(want, key=lambda a: a.spec_id))
    assert len(launches) == 1
    assert tuple(launches[0].index.shape) == (2, 16, DIM)
    assert launches[0].k == 5
    for a in got:
        s, budget = {0: (0, 3), 1: (0, 5), 2: (1, 4)}[a.spec_id]
        _assert_adhoc_bitwise(a, rows[s], np.arange(len(rows[s])), embs[s],
                              budget, "float32")
    assert all(a.sid != 2 for a in got)


# ---------------------------------------------------------------------------
# trigger state machine
# ---------------------------------------------------------------------------


def _drive(pkg, sims, seed, **trigger):
    """One single-row tick per similarity → (fires a tick, alerts,
    counters)."""
    rng = np.random.default_rng(seed)
    mgr = _mgr(pkg, **FLAT)
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    _register(pkg, mgr, sid, emb, 1, **trigger)
    fires, alerts = [], []
    for fid, s in enumerate(sims):
        out = _evaluate(mgr, {sid: _insert(
            mgr, sid, _rows_with_sims(rng, emb, [s]), fid)})
        fires.append(len(out))
        alerts += out
    return fires, alerts, (mgr.io_stats["alerts_fired"],
                           mgr.io_stats["alerts_suppressed"])


@pytest.mark.parametrize("case", [
    # threshold .5, hysteresis .2: fire, suppressed, in the band,
    # suppressed, re-armed, fire
    (dict(threshold=0.5, hysteresis=0.2), [0.6, 0.6, 0.45, 0.6, 0.25, 0.6],
     [1, 0, 0, 0, 0, 1], (2, 2)),
    # cooldown 3: fire, re-arm, suppressed while the cooldown drains, fire
    (dict(threshold=0.5, cooldown_ticks=3), [0.6, 0.2, 0.6, 0.6],
     [1, 0, 0, 1], (2, 1)),
    # below the threshold: never
    (dict(threshold=0.9), [0.1, 0.5, 0.8, 0.85], [0, 0, 0, 0], (0, 0))],
    ids=["hysteresis", "cooldown", "subthreshold"])
def test_trigger_matches_reference(case, launches):
    trigger, sims, fires, counters = case
    got = _drive(PORT, sims, 5, **trigger)
    want = _drive(JAX, sims, 5, **trigger)
    assert got[0] == want[0] == fires
    assert got[2] == want[2] == counters
    _assert_same_alerts(got[1], want[1])
    _assert_margin(launches, [trigger["threshold"],
                              trigger["threshold"]
                              - trigger.get("hysteresis", 0.0)])


def _thresholded(pkg):
    rng = np.random.default_rng(8)
    mgr = _mgr(pkg, **FLAT)
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    rows = _rows_with_sims(rng, emb, [0.95, 0.3, 0.92, 0.1, 0.2])
    _register(pkg, mgr, sid, emb, 4, threshold=0.9)
    return _evaluate(mgr, {sid: _insert(mgr, sid, rows, 0)})


def test_alert_frame_ids_are_thresholded(launches):
    """frame_ids hold only the rows at or above the threshold."""
    got, want = _thresholded(PORT), _thresholded(JAX)
    _assert_same_alerts(got, want)
    np.testing.assert_array_equal(got[0].frame_ids, [0, 2])
    _assert_margin(launches, [0.9])


# ---------------------------------------------------------------------------
# delivery and lifecycle
# ---------------------------------------------------------------------------


def _priority_case(pkg):
    rng = np.random.default_rng(9)
    mgr = _mgr(pkg, **FLAT)
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    emb2 = _unit(rng.normal(size=(1, DIM)))[0]
    ids = [_register(pkg, mgr, sid, e, 1, threshold=-1.0, priority=p)
           for e, p in ((emb, 0.0), (emb, 5.0), (emb2, 0.0))]
    rows = _rows_with_sims(rng, emb, [0.8])
    _evaluate(mgr, {sid: _insert(mgr, sid, rows, 0)})
    assert mgr.standing.pending_alerts == 3
    first = mgr.poll_alerts(max_alerts=1)
    assert mgr.standing.pending_alerts == 2
    return first, mgr.poll_alerts(), mgr.poll_alerts(), ids


def test_poll_alerts_priority_ordered(launches):
    """Priority desc, then score desc; ``max_alerts`` caps the drain."""
    got, want = _priority_case(PORT), _priority_case(JAX)
    first, rest, empty, ids = got
    assert [a.spec_id for a in first] == [ids[1]]
    assert len(rest) == 2 and rest[0].score > rest[1].score and empty == []
    _assert_same_alerts(first + rest, want[0] + want[1])


def _callback_case(pkg):
    rng = np.random.default_rng(10)
    mgr = _mgr(pkg, **FLAT)
    svc = pkg.Service(mgr, None)
    sid = svc.create_stream()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    seen = []
    svc.on_alert(seen.append)
    spec_id = svc.register_standing(
        sid, pkg.Spec(sid=sid, embedding=emb, strategy="topk", budget=2),
        threshold=0.5)
    rows = _rows_with_sims(rng, emb, [0.9, 0.7, 0.2])
    _evaluate(mgr, {sid: _insert(mgr, sid, rows, 0)})
    return seen, svc.poll_alerts(), svc.io_stats(), spec_id


def test_on_alert_callback_observes_stream(launches):
    seen, polled, stats, spec_id = _callback_case(PORT)
    jseen, jpolled, jstats, _ = _callback_case(JAX)
    assert [a.spec_id for a in seen] == [spec_id]
    assert [a.spec_id for a in polled] == [spec_id]   # callbacks observe
    _assert_same_alerts(seen + polled, jseen + jpolled)
    for k in ("standing_specs", "alerts_fired", "alerts_suppressed"):
        assert stats[k] == jstats[k]
    assert stats["standing_specs"] == stats["alerts_fired"] == 1
    _assert_margin(launches, [0.5])


def _lifecycle_case(pkg):
    rng = np.random.default_rng(11)
    mgr = _mgr(pkg, **FLAT)
    sid = mgr.create_session()
    emb = _unit(rng.normal(size=(1, DIM)))[0]
    closed = _register(pkg, mgr, sid, emb, 1, threshold=0.5)
    rows = _rows_with_sims(rng, emb, [0.9])
    _evaluate(mgr, {sid: _insert(mgr, sid, rows, 0)})
    mgr.close_session(sid)
    assert mgr.standing.n_specs == 0
    sid2 = mgr.create_session()                 # recycles the slot
    assert mgr.sessions[sid2].memory.slot == 0
    ghost = _evaluate(mgr, {sid2: _insert(mgr, sid2, rows, 0)})
    dropped = _register(pkg, mgr, sid2, emb, 1, threshold=-1.0)
    once = _evaluate(mgr, {sid2: _insert(mgr, sid2, rows, 1)})
    mgr.unregister_standing(dropped)
    after = _evaluate(mgr, {sid2: _insert(mgr, sid2, rows, 2)})
    return ghost, once, after, mgr.poll_alerts(), closed, sid


def test_close_and_unregister_no_ghost_firing(launches):
    """Closing a stream drops its specs (the recycled slot's next tenant
    fires none of them) while its fired alert stays pollable; an
    unregistered spec is evaluated no more."""
    ghost, once, after, polled, closed, sid = _lifecycle_case(PORT)
    jghost, jonce, jafter, jpolled, *_ = _lifecycle_case(JAX)
    assert ghost == after == jghost == jafter == []
    assert len(once) == 1
    _assert_same_alerts(once, jonce)
    _assert_same_alerts(polled, jpolled)
    assert (polled[0].spec_id, polled[0].sid) == (closed, sid)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["sampling", "akr", "bolt", "uniform"])
def test_register_rejects_non_deterministic_strategies(strategy):
    for pkg in (PORT, JAX):
        mgr = _mgr(pkg, **FLAT)
        sid = mgr.create_session()
        emb = np.ones(DIM, np.float32) / np.sqrt(DIM)
        with pytest.raises(ValueError, match="standing") as err:
            mgr.register_standing(
                sid, pkg.Spec(sid=sid, embedding=emb, strategy=strategy,
                              budget=4), threshold=0.5)
        if pkg is PORT:
            port_msg = str(err.value)
    assert port_msg == str(err.value)


def test_register_rejects_explicit_seed_and_bad_trigger_params():
    msgs = {}
    for pkg in (PORT, JAX):
        mgr = _mgr(pkg, **FLAT)
        sid = mgr.create_session()
        emb = np.ones(DIM, np.float32) / np.sqrt(DIM)
        spec = pkg.Spec(sid=sid, embedding=emb, strategy="topk", budget=4)
        cases = [("seed", dict(spec=pkg.Spec(sid=sid, embedding=emb,
                                             strategy="topk", budget=4,
                                             seed=7), threshold=0.5)),
                 ("threshold", dict(spec=spec, threshold=float("inf"))),
                 ("hysteresis", dict(spec=spec, threshold=0.5,
                                     hysteresis=-0.1)),
                 ("cooldown", dict(spec=spec, threshold=0.5,
                                   cooldown_ticks=-1))]
        for match, kw in cases:
            with pytest.raises(ValueError, match=match) as err:
                mgr.register_standing(sid, **kw)
            msgs.setdefault(match, []).append(str(err.value))
        assert mgr.standing.n_specs == 0
    assert all(a == b for a, b in msgs.values())


# ---------------------------------------------------------------------------
# the bandwidth claim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index_dtype,itemsize", [("float32", 4),
                                                  ("int8", 1)])
def test_standing_scan_bytes_is_slab_sized(index_dtype, itemsize, launches):
    """One tick over n new rows streams G · pow2(n) · d · itemsize bytes,
    within 2× of n · d · itemsize and far below a capacity scan, with no
    restack; the same counters as the reference's."""
    counts = {}
    for pkg, ops in ((PORT, tops), (JAX, jops)):
        rng = np.random.default_rng(13)
        mgr = _mgr(pkg, memory_capacity=4096, member_cap=8,
                   index_dtype=index_dtype)
        sid = mgr.create_session()
        emb = _unit(rng.normal(size=(1, DIM)))[0]
        _register(pkg, mgr, sid, emb, 4, threshold=-1.0)
        phys = _insert(mgr, sid, _unit(rng.normal(size=(10, DIM))), 0)
        ops.reset_scan_counts()
        _evaluate(mgr, {sid: phys})
        counts[pkg is PORT] = ops.scan_counts()
        assert mgr.io_stats["stack_rebuilds"] == 0
    got = counts[True]["standing_scan_bytes"]
    assert got == _pow2(10) * DIM * itemsize <= 2 * 10 * DIM * itemsize
    assert got < 4096 * DIM * itemsize // 8
    assert counts[True] == counts[False]


def test_empty_tick_scans_nothing(launches):
    """A tick with no new rows for a spec'd session launches nothing."""
    rng = np.random.default_rng(14)
    mgr = _mgr(PORT, **FLAT)
    sid = mgr.create_session()
    other = mgr.create_session()
    _register(PORT, mgr, sid, _unit(rng.normal(size=(1, DIM)))[0], 1,
              threshold=-1.0)
    phys = _insert(mgr, other, _unit(rng.normal(size=(4, DIM))), 0)
    assert _evaluate(mgr, {other: phys}) == []
    assert _evaluate(mgr, {sid: phys[:0]}) == []
    assert launches == []
    assert tops.scan_counts()["standing_scan_bytes"] == 0
    assert mgr.standing.tick == 2


# ---------------------------------------------------------------------------
# the ingest path
# ---------------------------------------------------------------------------


def _block_chunk(rng, n=16, hw=16, pool=8):
    """n identical frames of one block-structured scene, zero-centred at
    the embedder's pool scale."""
    blocks = rng.uniform(-1, 1, (hw // pool, hw // pool, 3)
                         ).astype(np.float32)
    frame = np.kron(blocks, np.ones((pool, pool, 1), np.float32))
    return np.broadcast_to(frame, (n,) + frame.shape).copy()


def _ingest_alerts(pkg, embedder):
    rng = np.random.default_rng(15)
    cfg = pkg.Config(max_partition_len=64, scene_threshold=0.075)
    mgr = pkg.Manager(cfg, embedder, embed_dim=64, **pkg.kw)
    sid = mgr.create_session()
    target = _block_chunk(np.random.default_rng(99))
    emb = np.asarray(embedder.embed_frames(target)[0], np.float32)
    mgr.register_standing(sid, pkg.Spec(sid=sid, embedding=emb,
                                        strategy="topk", budget=4),
                          threshold=0.9, hysteresis=0.05)
    for t in range(6):
        mgr.ingest_tick({sid: target if t % 2 == 0 else _block_chunk(rng)})
    mgr.flush()
    return mgr, mgr.poll_alerts()


def test_ingest_path_fires_on_matching_scenes(launches):
    """Through the real ingest path (``PixelEmbedder``): the spec fires
    once per matching scene as its cluster commits, never on the noise
    between them, with the reference's alerts."""
    mgr, got = _ingest_alerts(PORT, PixelEmbedder(dim=64))
    jmgr, want = _ingest_alerts(JAX, JPixel(dim=64))
    _assert_same_alerts(got, want)
    assert len(got) == 3
    matching = set()
    for t in (0, 2, 4):
        matching.update(range(16 * t, 16 * (t + 1)))
    for a in got:
        assert a.score > 0.99
        assert set(int(f) for f in a.frame_ids) <= matching
    assert mgr.io_stats["alerts_fired"] == jmgr.io_stats["alerts_fired"] == 3
    assert mgr.io_stats["stack_rebuilds"] == 0
    assert tops.scan_counts()["standing_scan_bytes"] > 0
    _assert_margin(launches, [0.9, 0.85])
