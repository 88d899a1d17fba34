"""The PyTorch port's dense query path held against the JAX reference on
the CPU: the dense scan's plain versions and probability epilogue, the
baselines (uniform, BOLT, MDF, AKS), ``VenusMemory.search`` and
``execute_plan(fused=False)`` for every registered strategy.

The same numpy inputs go through ``repro`` (default ``jnp`` backend) and
``repro_torch`` (CPU tensors, so the plain versions run). Integers
(draws, frame ids, counters) must be equal. Floats are allclose at rtol
1e-5 / atol 1e-6: XLA and PyTorch sum in different orders. BOLT's CDF is
the port's canonical chunked sum and the reference's ``jnp.cumsum``:
they differ by ulps, so its inputs keep every quantile at least 1e-6
from every CDF value (checked here, not assumed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import retrieval as jrt
from repro.core.memory import quantise_rows as jquantise_rows
from repro.core.queryplan import QuerySpec as JSpec
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.data.video import OracleEmbedder as JOracle
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import similarity as jsim
from repro_torch.core import retrieval as trt
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.data.video import OracleEmbedder, VideoWorld, WorldConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import similarity as tsim

TAU = 0.1


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_scan_counts()
    tops.reset_kernel_launches()
    yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the dense scan: plain raw triple + epilogue against the reference
# ---------------------------------------------------------------------------


def _scan_case(name):
    """(query (S,Q,d), index (S,N,d), valid) numpy inputs. N = 300 is not
    a multiple of 256; one session of the sizes/windows forms is empty."""
    rng = np.random.default_rng(SCAN_CASES.index(name))
    s, q, n, d = (1, 5, 300, 16) if name == "s1" else (3, 4, 300, 16)
    query = rng.standard_normal((s, q, d)).astype(np.float32)
    index = rng.standard_normal((s, n, d)).astype(np.float32)
    if name == "mask":
        valid = rng.random((s, n)) < 0.6
    elif name == "windows":
        valid = np.asarray([[250, 120], [0, 0], [17, 300]], np.int32)
    elif name == "s1":
        valid = np.asarray([211], np.int32)
    else:
        valid = np.asarray([300, 0, 133], np.int32)
    if name == "int8":
        index = np.asarray(jquantise_rows(index)[0])
    return query, index, valid


SCAN_CASES = ["sizes", "windows", "mask", "s1", "int8"]


@pytest.mark.parametrize("name", SCAN_CASES)
def test_dense_scan_stack_matches_reference(name):
    query, index, valid = _scan_case(name)
    want_sims, want_probs = jops.similarity_stack(
        jnp.asarray(query), jnp.asarray(index), tau=TAU,
        valid=jnp.asarray(valid))
    sims, m, l = tref.similarity_scan_stack_ref(_t(query), _t(index),
                                                _t(valid), tau=TAU)
    vmask = tref.as_valid_mask(_t(valid), index.shape[1])
    probs = tref.scan_probs(sims, m, l, vmask[:, None, :], TAU)
    _close(sims, want_sims)
    _close(probs, want_probs)
    # the dispatch layer: the wrapper (its plain version here) + epilogue
    got_sims, got_probs = tops.similarity_stack(_t(query), _t(index),
                                                tau=TAU, valid=_t(valid))
    _close(got_sims, want_sims)
    _close(got_probs, want_probs)
    # the wrapper's CPU route is the plain version, and is no launch
    for a, b in zip(tsim.similarity_scan_stack(_t(query), _t(index),
                                               _t(valid), tau=TAU),
                    (sims, m, l)):
        assert torch.equal(a, b)
    c = tops.scan_counts()
    assert c["similarity_stack"] == 1 and c["dense_score_launches"] == 1
    assert c["scan_bytes"] == index.size * index.itemsize
    assert tops.kernel_launches()["similarity_scan_stack"] == 0


@pytest.mark.parametrize("name", ["sizes", "mask"])
def test_dense_scan_2d_matches_reference(name):
    query, index, valid = _scan_case(name)
    mask = np.asarray(jref.as_valid_mask(jnp.asarray(valid), 300))[0]
    want_sims, want_probs = jops.similarity(
        jnp.asarray(query[0]), jnp.asarray(index[0]), tau=TAU,
        valid=jnp.asarray(mask))
    sims, m, l = tref.similarity_scan_ref(_t(query[0]), _t(index[0]),
                                          _t(mask), tau=TAU)
    _close(sims, want_sims)
    _close(tref.scan_probs(sims, m, l, _t(mask)[None, :], TAU), want_probs)
    got_sims, got_probs = tops.similarity(_t(query[0]), _t(index[0]),
                                          tau=TAU, valid=_t(mask))
    _close(got_sims, want_sims)
    _close(got_probs, want_probs)
    assert tops.scan_counts()["similarity"] == 1
    for a, b in zip(tsim.similarity_scan(_t(query[0]), _t(index[0]),
                                         _t(mask), tau=TAU), (sims, m, l)):
        assert torch.equal(a, b)
    assert tops.kernel_launches()["similarity_scan"] == 0


def test_empty_session_follows_the_oracle_not_the_padded_kernel():
    """An all-invalid session: the port (no padding of N) gives m = -1e30,
    l = N and probabilities 1/N, as the reference's jnp oracle does. The
    Pallas kernel pads N = 300 to its 512-lane block and counts the pad
    lanes into l (l = 512) — the difference is on purpose."""
    query, index, valid = _scan_case("sizes")         # session 1 is empty
    sims, m, l = tref.similarity_scan_stack_ref(_t(query), _t(index),
                                                _t(valid), tau=TAU)
    np.testing.assert_array_equal(m[1].numpy(), np.float32(-1e30))
    np.testing.assert_array_equal(l[1].numpy(), 300.0)
    vmask = tref.as_valid_mask(_t(valid), 300)
    probs = tref.scan_probs(sims, m, l, vmask[:, None, :], TAU)
    np.testing.assert_allclose(probs[1].numpy(), 1.0 / 300, rtol=1e-6)
    _, want = jops.similarity_stack(jnp.asarray(query), jnp.asarray(index),
                                    tau=TAU, valid=jnp.asarray(valid))
    np.testing.assert_allclose(np.asarray(want[1]), 1.0 / 300, rtol=1e-6)
    _, _, pallas_l = jsim.similarity_scan_stack(
        jnp.asarray(query), jnp.asarray(index), jnp.asarray(valid), tau=TAU,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas_l[1]), 512.0)


# ---------------------------------------------------------------------------
# baselines over the same inputs
# ---------------------------------------------------------------------------


def test_uniform_matches_reference():
    totals = np.asarray([0, 1, 2, 5, 100, 999, 1000, 4097, 12345], np.int64)
    for n in (1, 2, 7, 32, 33):
        want = np.asarray(jrt.uniform_retrieve_batch(
            jnp.asarray(totals, jnp.int32), n))
        np.testing.assert_array_equal(
            trt.uniform_retrieve_batch(totals, n).numpy(), want)
        np.testing.assert_array_equal(
            trt.uniform_retrieve(int(totals[5]), n).numpy(),
            np.asarray(jrt.uniform_retrieve(int(totals[5]), n)))


def _bolt_margin(sims, valid, n):
    """Smallest distance between a BOLT quantile and a value of the
    reference's CDF, over every lane."""
    logits = np.where(valid[:, None, :], sims / TAU, -1e30)
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    cdf = np.cumsum(p, axis=-1)
    u = (np.arange(n) + 0.5) / n
    return float(np.abs(cdf[..., None, :] - u[:, None]).min())


@pytest.mark.parametrize("cap,n", [(700, 16), (256, 32), (1300, 8)])
def test_bolt_matches_reference(cap, n):
    rng = np.random.default_rng(cap)
    sims = rng.uniform(-1, 1, (2, 3, cap)).astype(np.float32)
    valid = rng.random((2, cap)) < 0.7
    assert _bolt_margin(sims, valid, n) > 1e-6
    want = jrt.bolt_inverse_transform_batch(jnp.asarray(sims),
                                            jnp.asarray(valid), n, tau=TAU)
    got = trt.bolt_inverse_transform_batch(_t(sims), _t(valid), n, tau=TAU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [4, 16])
def test_mdf_matches_reference(n):
    """Rows come in runs of near-duplicates (cosine ≈ 0.999 within a run,
    ≈ 0 across runs), far from the 0.95 threshold; one session keeps
    nothing (all invalid)."""
    rng = np.random.default_rng(n)
    d, cap = 24, 200
    protos = rng.standard_normal((3, 40, d))
    run = np.repeat(np.arange(40), 5)[:cap]
    embs = protos[:, run] + 0.01 * rng.standard_normal((3, cap, d))
    embs = embs.astype(np.float32)
    valid = rng.random((3, cap)) < 0.8
    valid[2] = False
    want = jrt.mdf_retrieve_batch(jnp.asarray(embs), jnp.asarray(valid), n)
    got = trt.mdf_retrieve_batch(_t(embs), _t(valid), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        trt.mdf_retrieve(_t(embs[0]), _t(valid[0]), n).numpy(),
        np.asarray(want[0]))


@pytest.mark.parametrize("cap,n", [(300, 12), (64, 32), (513, 5)])
def test_aks_matches_reference(cap, n):
    rng = np.random.default_rng(cap + n)
    sims = rng.uniform(-1, 1, (4, cap)).astype(np.float32)
    valid = rng.random((4, cap)) < 0.75
    for i in range(4):
        want = jrt.aks_retrieve(jnp.asarray(sims[i]), jnp.asarray(valid[i]),
                                n)
        got = trt.aks_retrieve(_t(sims[i]), _t(valid[i]), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_batch_matches_reference():
    rng = np.random.default_rng(3)
    sims = rng.uniform(-1, 1, (2, 3, 90)).astype(np.float32)
    valid = rng.random((2, 90)) < 0.5
    want = jrt.topk_retrieve_batch(jnp.asarray(sims), jnp.asarray(valid), 7)
    got = trt.topk_retrieve_batch(_t(sims), _t(valid), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# query plans on a three-session world: every strategy, fused=False
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin_managers():
    """Three sessions streaming one world, the later ones joining a tick
    late, ingested by both packages."""
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
    qe = JOracle(jw, dim=32, seed=77).embed_queries(tw.make_queries(6,
                                                                    seed=8))
    return jmgr, tmgr, qe


STRATEGIES = [("akr", None), ("sampling", 10), ("topk", 5), ("uniform", 9),
              ("bolt", 8), ("mdf", 6), ("aks", 7)]


def _specs(cls, qe, strategy, budget, seed=None):
    sids = [2, 0, 1, 0, 2, 1]
    return [cls(sid=s, embedding=qe[j], strategy=strategy, budget=budget,
                seed=seed if seed is None else seed + j)
            for j, s in enumerate(sids)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        np.testing.assert_array_equal(a.draws, b.draws)
        assert a.n_drawn == b.n_drawn
        np.testing.assert_allclose(a.mass, b.mass, rtol=1e-5)


@pytest.mark.parametrize("strategy,budget", STRATEGIES)
def test_dense_plan_matches_reference(twin_managers, strategy, budget):
    """``execute_plan(fused=False)``: one dense scan per group, frame ids
    identical to the reference's (chain-policy keys: both packages'
    session chains advance in step)."""
    jmgr, tmgr, qe = twin_managers
    want = jmgr.execute(jmgr.plan(_specs(JSpec, qe, strategy, budget)),
                        fused=False)
    plan = tmgr.plan(_specs(QuerySpec, qe, strategy, budget))
    assert plan.n_scans == 1
    got = tmgr.execute(plan, fused=False)
    _assert_same(got, want)
    c = tops.scan_counts()
    assert c["similarity_stack"] == 1 and c["dense_score_launches"] == 1
    assert c["fused_draw_launches"] == 0
    assert tmgr.io_stats["stack_rebuilds"] == 0
    for r, sid in zip(got, [2, 0, 1, 0, 2, 1]):
        seen = tmgr[sid].stats["frames_seen"]
        assert ((r.frame_ids >= 0) & (r.frame_ids < seen)).all()


@pytest.mark.parametrize("strategy,budget", STRATEGIES[:3])
def test_fused_and_dense_give_the_same_frame_ids(twin_managers, strategy,
                                                 budget):
    """The reference's contract inside the port: the fused launch and the
    dense path answer sampling, AKR and top-k draw for draw (explicit
    seeds, so both runs see the same keys)."""
    _, tmgr, qe = twin_managers
    specs = _specs(QuerySpec, qe, strategy, budget, seed=40)
    fused = tmgr.execute(tmgr.plan(specs))
    dense = tmgr.execute(tmgr.plan(specs), fused=False)
    _assert_same(dense, fused)
    c = tops.scan_counts()
    assert c["fused_draw_launches"] == 1 and c["dense_score_launches"] == 1


def test_dense_baselines_run_under_the_default_fused_flag(twin_managers):
    """BOLT/MDF/AKS/uniform groups take the dense scan even with
    ``fused=True`` (the same answers as ``fused=False``); a mixed plan
    costs one launch per group."""
    _, tmgr, qe = twin_managers
    specs = [QuerySpec(sid=j % 3, embedding=qe[j], strategy=s, budget=b)
             for j, (s, b) in enumerate(STRATEGIES[1:])]
    plan = tmgr.plan(specs)
    assert plan.n_scans == 6
    got = tmgr.execute(plan)
    c = tops.scan_counts()
    assert c["fused_draw_launches"] == 2 and c["dense_score_launches"] == 4
    dense = tmgr.execute(tmgr.plan(specs[2:]), fused=False)
    _assert_same(got[2:], dense)


def test_memory_search_matches_reference(twin_managers):
    jmgr, tmgr, qe = twin_managers
    for sid in range(3):
        want = jmgr[sid].memory.search(jnp.asarray(qe[:4]), tau=TAU)
        before = tmgr[sid].memory.io_stats["scans"]
        got = tmgr[sid].memory.search(qe[:4], tau=TAU)
        for a, b in zip(got, want):
            _close(a, b)
        assert tmgr[sid].memory.io_stats["scans"] == before + 1
    assert tops.scan_counts()["similarity"] == 3


def test_uniform_rejected_for_window_evicting_session():
    tw = VideoWorld(WorldConfig(n_scenes=2, seed=5))
    mgr = SessionManager(VenusConfig(memory_capacity=64),
                         OracleEmbedder(tw, dim=16), embed_dim=16,
                         device="cpu")
    mgr.create_session(0)
    mgr.create_session(1, eviction="sliding_window")
    spec = lambda sid: QuerySpec(sid=sid, embedding=np.ones(16),
                                 strategy="uniform")
    assert mgr.plan([spec(0)]).n_scans == 1
    with pytest.raises(ValueError, match="uniform"):
        mgr.plan([spec(1)])
