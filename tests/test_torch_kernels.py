"""The PyTorch port's kernel layer held against the JAX reference on the
CPU: the threefry bridge, the canonical draws, the valid-mask forms, the
plain fused retrieval and the plain scene score. The same numpy inputs go
through ``repro`` (default ``jnp`` backend) and ``repro_torch`` (CPU
tensors, so the plain PyTorch versions run).

Tolerances: integers (draws, counts, top-k lanes, PRNG words) must be
equal. Floats are allclose at rtol 1e-5 / atol 1e-6 (rtol 1e-5 / atol
1e-7 for φ): XLA and PyTorch sum in different orders, so fp32 results
differ in the last few ulps, never more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.memory import quantise_rows as jax_quantise_rows
from repro.kernels import draws as jdraws
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import draws as tdraws
from repro_torch.kernels import ops as tops
from repro_torch.kernels import prng
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scene_score as tscene
from repro_torch.kernels import similarity as tsim


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_scan_counts()
    tops.reset_kernel_launches()
    yield


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# threefry bridge: bit-equal to jax.random
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prng_key_and_split_bit_equal(seed):
    np.testing.assert_array_equal(
        prng.key(seed), np.asarray(jax.random.key_data(jax.random.key(seed))))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(
            prng.split(prng.key(seed), num),
            np.asarray(jax.random.key_data(
                jax.random.split(jax.random.key(seed), num))))


def test_prng_chain_matches_next_keys():
    """SessionState.next_keys' chain: key, sub = split(key), n times."""
    jk, tk = jax.random.key(0), prng.key(0)
    for _ in range(6):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(tsub, np.asarray(
            jax.random.key_data(jsub)))
        np.testing.assert_array_equal(tk, np.asarray(
            jax.random.key_data(jk)))


def test_session_next_keys_bit_equal():
    """The session PRNG chain itself, through both SessionStates."""
    from repro.core.session import SessionState as JState
    from repro.core.session import VenusConfig as JConfig
    from repro_torch.core.session import SessionState, VenusConfig
    js = JState(0, JConfig(memory_capacity=8, seed=5), 4)
    ts = SessionState(0, VenusConfig(memory_capacity=8, seed=5), 4,
                      device="cpu")
    for n in (1, 3, 2):
        np.testing.assert_array_equal(
            ts.next_keys(n), np.asarray(jax.random.key_data(js.next_keys(n))))


@pytest.mark.parametrize("n,lo,hi", [(32, 0, 2**20), (7, 0, 2**20),
                                     (5, 3, 1000), (9, -50, 2**31 - 1)])
def test_prng_randint_bit_equal(n, lo, hi):
    keys = prng.split(prng.key(3), 4)
    got = prng.randint(keys, n, lo, hi)
    want = np.stack([np.asarray(jax.random.randint(
        jax.random.wrap_key_data(k), (n,), lo, hi)) for k in keys])
    np.testing.assert_array_equal(got, want)


def test_draw_targets_bit_equal():
    key = jax.random.key(11)
    want = np.asarray(jdraws.draw_targets(key, 64))
    got = tdraws.draw_targets(tdraws.draw_variates(
        np.asarray(jax.random.key_data(key)), 64)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# canonical draws
# ---------------------------------------------------------------------------


def _probs(rng, shape, tau=0.1):
    x = rng.standard_normal(shape).astype(np.float32)
    e = np.exp((x - x.max(-1, keepdims=True)) / tau)
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _clear_targets(probs, rng, n, margin=1e-5):
    """Targets on the 2^20 grid at least ``margin`` from every value of
    the float64 CDF, so the two packages' summation orders cannot move
    a draw."""
    cdf = np.cumsum(probs.astype(np.float64))
    u = rng.integers(0, 1 << 20, size=50 * n)
    t = ((u + 0.5) / (1 << 20)).astype(np.float32)
    gap = np.min(np.abs(cdf[None, :] - t[:, None]), axis=1)
    return t[gap >= margin][:n]


@pytest.mark.parametrize("cap", [100, 256, 700, 1500])
def test_blockwise_cdf_allclose(cap):
    p = _probs(np.random.default_rng(cap), (cap,))
    np.testing.assert_allclose(
        tdraws.blockwise_cdf(_t(p)).numpy(),
        np.asarray(jdraws.blockwise_cdf(jnp.asarray(p))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cap", [100, 256, 700, 1500])
def test_categorical_from_targets_integers_equal(cap):
    rng = np.random.default_rng(100 + cap)
    p = _probs(rng, (cap,), tau=0.3)
    t = _clear_targets(p, rng, 64)
    assert len(t) == 64
    got = tdraws.categorical_from_targets(_t(p), _t(t)).numpy()
    want = np.asarray(jdraws.categorical_from_targets(jnp.asarray(p),
                                                      jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)


def test_draws_clip_beyond_total_mass():
    p = np.full((10,), 0.05, np.float32)              # total mass 0.5
    t = np.asarray([0.01, 0.49, 0.75], np.float32)
    got = tdraws.categorical_from_targets(_t(p), _t(t)).numpy()
    np.testing.assert_array_equal(got, [0, 9, 9])


# ---------------------------------------------------------------------------
# valid masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["mask", "sizes", "windows"])
def test_as_valid_mask_three_forms(form):
    rng = np.random.default_rng(4)
    n = 37
    if form == "mask":
        valid = rng.random((3, n)) < 0.5
    elif form == "sizes":
        valid = np.asarray([0, 20, 37], np.int32)
    else:                                  # includes a wrapping window
        valid = np.asarray([[30, 12], [0, 37], [5, 0]], np.int32)
    got = tref.as_valid_mask(_t(valid), n).numpy()
    want = np.asarray(jref.as_valid_mask(jnp.asarray(valid), n))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# fused retrieval (plain version) over the reference's cases
# ---------------------------------------------------------------------------

# the cases of tests/test_fused_retrieval.py: size-0 session, S == 1,
# cap % DRAW_BLK != 0, a wrapping ring window, cap < DRAW_BLK, int8 rows
CASES = [
    dict(S=3, Q=2, N=512, d=32, T=8, K=4, valid_kind="mask", seed=0),
    dict(S=1, Q=1, N=200, d=16, T=6, K=3, valid_kind="sizes", seed=1,
         sizes=[0]),
    dict(S=3, Q=2, N=700, d=16, T=6, K=3, valid_kind="sizes", seed=2,
         sizes=[0, 700, 123]),
    dict(S=2, Q=2, N=300, d=16, T=5, K=2, valid_kind="wins", seed=3,
         wins=[[250, 120], [0, 300]]),
    dict(S=2, Q=1, N=100, d=8, T=4, K=2, valid_kind="mask", seed=4),
    dict(S=2, Q=2, N=512, d=32, T=8, K=4, valid_kind="mask", seed=5,
         dtype="int8"),
]


def _case(S, Q, N, d, T, K, valid_kind, seed, sizes=None, wins=None,
          dtype="float32"):
    """The reference test's shapes and edge cases, drawn with numpy; the
    draw targets are the reference's own (``draws.draw_targets``)."""
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((S, Q, d)).astype(np.float32)
    index = rng.standard_normal((S, N, d)).astype(np.float32)
    if dtype == "int8":
        index = jax_quantise_rows(index)[0]
    if valid_kind == "sizes":
        valid = np.asarray(sizes, np.int32)
    elif valid_kind == "wins":
        valid = np.asarray(wins, np.int32)
    else:
        valid = rng.random((S, N)) < 0.7
    tkeys = jax.random.split(jax.random.key(seed), S * Q)
    targets = np.asarray(jax.jit(jax.vmap(
        lambda k: jdraws.draw_targets(k, T)))(tkeys)).reshape(S, Q, T)
    return query, index, valid, targets


@pytest.mark.parametrize("case", CASES,
                         ids=[f"case{i}" for i in range(len(CASES))])
def test_fused_retrieve_ref_matches_reference(case):
    case = dict(case)
    query, index, valid, targets = _case(**case)
    tau, k = 0.1, case["K"]
    want = jax.jit(lambda q, x, v, t: jops.fused_retrieve_stack(
        q, x, tau=tau, valid=v, targets=t, n_topk=k))(
            jnp.asarray(query), jnp.asarray(index), jnp.asarray(valid),
            jnp.asarray(targets))
    got = tops.fused_retrieve_stack(_t(query), _t(index), tau=tau,
                                    valid=_t(valid), targets=_t(targets),
                                    n_topk=k)
    for f in ("draws", "topk_i"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("drawn_p", "topk_v", "m", "p_max"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l),
                               rtol=1e-5)
    c = tops.scan_counts()
    assert c["fused_draw_launches"] == 1 and c["similarity_stack"] == 1
    assert c["scan_bytes"] == index.size * index.dtype.itemsize
    # a CPU tensor takes the plain version: the kernel never launched
    launches = tops.kernel_launches()
    assert launches["fused_retrieve"] == 0
    assert set(launches.values()) == {0}


def test_fused_raw_contract_shapes():
    query, index, valid, targets = _case(**CASES[0])
    r = tsim.fused_retrieve_scan_stack(_t(query), _t(index), _t(valid),
                                       _t(targets), tau=0.1, n_topk=4)
    s, q, t = targets.shape
    assert r.counts.shape == r.drawn_p.shape == (s, q, t)
    assert r.topk_v.shape == r.topk_i.shape == (s, q, 4)
    for x in (r.p_last, r.m, r.l, r.p_max):
        assert x.shape == (s, q, 1)
    assert r.counts.dtype == r.topk_i.dtype == torch.int32


def test_topk_ties_go_to_lowest_lane():
    sims = torch.tensor([[[0.5, 0.9, 0.9, 0.1, 0.9, 0.5]]])
    v, i = tref.topk_lowest_lane(sims, 4)
    assert i.tolist() == [[[1, 2, 4, 0]]]
    # fewer valid lanes than k: masked lanes fill in, lowest index first
    valid = torch.tensor([[False, False, True, False, False, True]])
    query = torch.ones((1, 1, 4))
    index = torch.ones((1, 6, 4))
    r = tref.fused_retrieve_stack_ref(query, index, valid,
                                      torch.full((1, 1, 1), 0.5), tau=0.1,
                                      n_topk=4)
    assert r.topk_i.tolist() == [[[2, 5, 0, 1]]]


def test_later_tiers_raise():
    query, index, valid, targets = _case(**CASES[0])
    for tier in ("coarse", "standing"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tops.fused_retrieve_stack(_t(query), _t(index), tau=0.1,
                                      valid=_t(valid), targets=_t(targets),
                                      n_topk=2, tier=tier)


def test_quantise_rows_identical():
    rows = np.random.default_rng(2).standard_normal((40, 24)).astype(
        np.float32)
    rows[3] = 0.0
    from repro_torch.core.memory import quantise_rows
    got, want = quantise_rows(rows), jax_quantise_rows(rows)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# scene score (plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 16, 16), (5, 12, 20)])
def test_scene_score_ref_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    frames = rng.random(shape + (3,)).astype(np.float32)
    frames[2, :4, :4] = 0.5                      # grey block: c == 0
    frames[3] = frames[2]                        # identical frames
    w = (1.0, 1.0, 1.0, 2.0)
    got = tscene.scene_score(_t(frames), w).numpy()
    want = np.asarray(jax.jit(lambda f: jref.scene_score_ref(f, w))(
        jnp.asarray(frames)))
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tref.hsle(_t(frames)).numpy(),
        np.asarray(jax.jit(jax.vmap(jref._hsle))(jnp.asarray(frames))),
        rtol=1e-5, atol=1e-6)
    assert tops.kernel_launches()["scene_score"] == 0
