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


@pytest.mark.parametrize("cap", [100, 256, 700, 1024, 1500])
def test_blockwise_cdf_is_monotone_and_counts_by_search(cap):
    """The invariant the fused kernel's draws rest on: the canonical
    chunked CDF never decreases across the row — chunk boundaries, masked
    (zero-p) lanes and ties included — each chunk's last value equals the
    next chunk's offset bit for bit (offset + total, the fold's own sum),
    so #{cdf <= t} is a search: ``searchsorted(cdf, t, right=True)``
    equals ``draws.raw_counts``, for targets past the total mass too."""
    rng = np.random.default_rng(cap)
    logits = rng.standard_normal((3, cap)).astype(np.float32) / 0.1
    logits[rng.random((3, cap)) < 0.3] = -1e30        # masked lanes: p 0
    logits[:, 5:40] = logits[:, 4:5]                   # ties
    logits[2, 300:] = -1e30                            # a masked tail
    p = torch.softmax(_t(logits), dim=-1)
    assert bool((p == 0).any())
    cdf = tdraws.blockwise_cdf(p)
    assert bool((cdf[..., 1:] >= cdf[..., :-1]).all())
    # the chunks' offsets: the sequential fold of the chunk totals
    pad = (-cap) % tdraws.DRAW_BLK
    chunks = torch.nn.functional.pad(p, (0, pad)).reshape(
        3, -1, tdraws.DRAW_BLK)
    tot = tdraws.seq_cumsum(chunks)[..., -1]
    off = torch.zeros_like(tot[..., :1])
    offs = [off]
    for k in range(tot.shape[-1]):
        off = off + tot[..., k:k + 1]
        offs.append(off)
    offs = torch.cat(offs, dim=-1)
    for k in range(tot.shape[-1]):
        last = min(cap, (k + 1) * tdraws.DRAW_BLK) - 1
        assert torch.equal(cdf[..., last], offs[..., k + 1]), k
        assert torch.equal(cdf[..., last], tot[..., k] + offs[..., k]), k
    u = rng.integers(0, 1 << 20, size=(3, 200))
    t = tdraws.draw_targets(_t(u))
    past = torch.stack([cdf[:, -1], cdf[:, -1] + 1e-3,
                        torch.full((3,), 1.5)], dim=-1)
    t = torch.cat([t, cdf[:, ::37], past], dim=-1)    # CDF values too
    got = torch.searchsorted(cdf.contiguous(), t.contiguous(), right=True)
    want = tdraws.raw_counts(p, t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert bool((want[:, -2:] == cap).all())


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
    # widths that are not a multiple of 4 (the kernels' one-element loads)
    dict(S=2, Q=3, N=300, d=6, T=6, K=3, valid_kind="mask", seed=6),
    dict(S=2, Q=3, N=300, d=6, T=6, K=3, valid_kind="mask", seed=7,
         dtype="int8"),
    dict(S=2, Q=2, N=300, d=770, T=6, K=3, valid_kind="sizes", seed=8,
         sizes=[300, 0]),
    dict(S=2, Q=2, N=300, d=770, T=6, K=3, valid_kind="sizes", seed=9,
         sizes=[0, 211], dtype="int8"),
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


@pytest.mark.parametrize("d", [6, 770, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_scan_operands_take_any_width_and_base(d, dtype):
    """The stack and fused scans take any d and any index base (one
    element a load where float4/char4 loads do not apply): the host
    checks pass an index view one element past an aligned base, and a
    width whose 8 staged queries overflow a block's shared memory raises
    with the limit named."""
    rng = np.random.default_rng(d)
    s, q, n = 2, 3, 40
    query = torch.from_numpy(rng.standard_normal((s, q, d)).astype(
        np.float32))
    flat = torch.from_numpy(rng.standard_normal(s * n * d + 1).astype(
        np.float32)).to(dtype)
    index = flat[1:].view(s, n, d)          # base one element off
    sizes = _t(np.asarray([n, 7], np.int32))
    q32, x, vmask = tsim._scan_operands(query, index, sizes)
    assert x.data_ptr() == index.data_ptr()
    assert q32.shape == (s, q, d) and vmask.shape == (s, n)
    # the limit: 8 queries at a row stride of d rounded up to 4, for the
    # stack and the fused scan alike (neither keeps a score tile or the
    # targets in shared memory any more, so the limit is wider than the
    # 7008 and 6688 - 2 T it was, and no longer narrows with T); a staged
    # ring adds 32 rows a stage
    assert tsim.scan_smem_bytes(7264) <= 227 * 1024 < tsim.scan_smem_bytes(
        7265)
    assert tsim.scan_smem_bytes(d) == 4 * 8 * (-(-d // 4) * 4)
    elt = index.element_size()
    assert tsim.scan_smem_bytes(d, elt, 2) == (tsim.scan_smem_bytes(d)
                                               + 2 * 32 * d * elt)
    wide = torch.zeros((1, 1, 7265))
    with pytest.raises(ValueError, match="shared memory"):
        tsim._scan_operands(wide, torch.zeros((1, 2, 7265), dtype=dtype),
                            _t(np.asarray([2], np.int32)))
    tsim._scan_operands(torch.zeros((1, 1, 7264)),
                        torch.zeros((1, 2, 7264), dtype=dtype),
                        _t(np.asarray([2], np.int32)))


# (d, element bytes, 16-byte aligned base, ring stages of the chunk pass)
SCAN_STAGES = [(768, 4, True, 2), (768, 1, True, 3), (768, 4, False, 0),
               (770, 4, True, 0), (6, 4, True, 0), (8, 4, True, 3),
               (804, 4, True, 2), (808, 4, True, 0), (1024, 4, True, 0),
               (1808, 1, True, 3), (1824, 1, True, 2), (2416, 1, True, 2),
               (2432, 1, True, 0), (772, 1, True, 0)]


@pytest.mark.parametrize("d,elt,aligned,stages", SCAN_STAGES)
def test_scan_stages_fit_shared_memory(d, elt, aligned, stages):
    """The score pass stages rows through its ring only where each row
    starts on 16 bytes, with 3 stages where they fit 227 KB, else 2, else
    none (rows read straight into registers)."""
    assert tsim.scan_stages(d, elt, aligned) == stages
    if stages:
        assert tsim.scan_smem_bytes(d, elt, stages) <= 227 * 1024
    if aligned and d * elt % 16 == 0 and stages < 3:
        assert tsim.scan_smem_bytes(d, elt, max(stages, 1) + 1) > 227 * 1024


# (d, element bytes, 16-byte aligned base) → the score pass's route
SCAN_PLANS = [((768, 1, True), "mma"), ((7232, 1, True), "mma"),
              ((784, 1, True), "ring"), ((800, 1, True), "ring"),
              ((768, 1, False), "direct"), ((776, 1, True), "direct"),
              ((768, 4, True), "ring"), ((770, 4, True), "direct"),
              ((7264, 1, True), "direct")]


@pytest.mark.parametrize("args,route", SCAN_PLANS)
def test_scan_plan_routes(args, route):
    """int8 rows take the tensor cores where d is a multiple of 64, the
    base is aligned and the query fragments fit 227 KB; else the ring,
    else straight loads."""
    path, stages, smem = tsim.scan_plan(*args)
    assert path == route and smem <= 227 * 1024
    assert (stages > 0) == (path == "ring")
    if path == "mma":
        assert smem == tsim.mma_smem_bytes(args[0])


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
    """``tier="coarse"`` and ``tier="standing"`` run the same launch and
    count their bytes into ``coarse_scan_bytes`` and
    ``standing_scan_bytes``; an unknown tier raises."""
    query, index, valid, targets = _case(**CASES[0])
    args = (_t(query), _t(index))
    kw = dict(tau=0.1, valid=_t(valid), targets=_t(targets), n_topk=2)
    tops.reset_scan_counts()
    fine = tops.fused_retrieve_stack(*args, **kw)
    for tier in ("coarse", "standing"):
        got = tops.fused_retrieve_stack(*args, tier=tier, **kw)
        for a, b in zip(fine, got):
            assert torch.equal(a, b)
    c = tops.scan_counts()
    assert c["coarse_scan_bytes"] == c["standing_scan_bytes"] == index.nbytes
    assert c["scan_bytes"] == 3 * index.nbytes
    with pytest.raises(ValueError, match="unknown tier"):
        tops.fused_retrieve_stack(*args, tier="spill", **kw)


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


def _scene_frames(shape):
    """Random frames of ``shape`` + (3,) from a seed; from T = 4 on, frame
    2 has a grey block (c == 0) and frame 3 repeats it."""
    rng = np.random.default_rng(sum(shape))
    frames = rng.random(shape + (3,)).astype(np.float32)
    if shape[0] >= 4:
        frames[2, :4, :4] = 0.5                  # grey block: c == 0
        frames[3] = frames[2]                    # identical frames
    return frames


@pytest.mark.parametrize("shape", [(6, 16, 16), (5, 12, 20), (1, 16, 16),
                                   (2, 16, 16), (5, 37, 53), (4, 1, 24)])
def test_scene_score_ref_matches_reference(shape):
    frames = _scene_frames(shape)
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


@pytest.mark.parametrize("shape", [(6, 16, 16), (2, 12, 20), (4, 37, 53)])
def test_scene_score_prev_matches_reference_on_the_whole_clip(shape):
    """φ with ``prev`` (the segmenter's call) is the reference's φ of prev
    and the clip together, without its leading zero."""
    frames = _scene_frames(shape)
    w = (1.0, 1.0, 1.0, 2.0)
    got = tscene.scene_score(_t(frames[1:]), w, _t(frames[0])).numpy()
    want = np.asarray(jax.jit(lambda f: jref.scene_score_ref(f, w))(
        jnp.asarray(frames)))[1:]
    assert got.shape == (shape[0] - 1,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert tops.kernel_launches()["scene_score"] == 0


SCENE_SHAPES = [(65, 224, 224), (65, 448, 448), (65, 37, 53), (65, 37, 1),
                (65, 1, 224), (1, 224, 224), (2, 224, 224), (65, 1, 1),
                (65, 8, 4150), (33, 40, 2100), (33, 40, 2732),
                (33, 40, 2734)]


@pytest.mark.parametrize("n,h,w", SCENE_SHAPES)
def test_scene_plan_covers_every_pair_once(n, h, w):
    """The scene kernel's grid: the blocks' (difference, row) pairs cover
    every frame t >= 1 of the sequence and every row exactly once; a
    band's halo is the row above it (none for row 0, whose edge map is
    zero); a chunk's first frame, featurised only to diff against, is the
    frame before its first difference, the previous chunk's last; shared
    memory and the threads' pixels fit."""
    for sms in (1, 7, 132):
        plan = tscene.scene_plan(n, h, w, sms)
        assert plan.smem == tscene.scene_smem_bytes(plan.rb, w, plan.stages,
                                                    plan.fc) <= 227 * 1024
        assert plan.stages in (2, 3) and 1 <= plan.fc <= tscene.MAX_CHUNK
        assert plan.pix == 32 or plan.stages == 3   # the builds there are
        assert 1 <= plan.rb <= h
        assert (plan.rb * w + 6) // 4 <= 256 * plan.pix // 4   # quads
        assert plan.copy == (16 if w % 4 == 0 else 4)
        # the blocks fill the SMs as far as the work goes
        assert plan.bands * plan.chunks >= min(sms, plan.bands * max(n - 1,
                                                                     1))
        assert tscene.scene_plan(n, h, w, sms, aligned=False).copy == 4
        assert plan.bands == -(-h // plan.rb)
        n_diff = n - 1
        assert plan.chunks == max(1, -(-n_diff // plan.fc))
        seen = []
        for b in range(plan.bands):
            r0, r1 = b * plan.rb, min((b + 1) * plan.rb, h)
            assert r1 > r0                               # no empty band
            halo = r0 - 1 if r0 > 0 else None
            assert halo is None if b == 0 else halo == (b - 1) * plan.rb \
                + min(plan.rb, h - (b - 1) * plan.rb) - 1
            # the band and its halo fit one ring stage
            assert (r1 - r0 + (halo is not None)) * w * 3 * 4 * plan.stages \
                <= plan.smem
            last = 0                     # the frame the walk has reached
            for c in range(plan.chunks):
                d0, d1 = c * plan.fc, min((c + 1) * plan.fc, n_diff)
                if n_diff == 0:
                    continue                             # phi_0 alone
                assert d1 > d0                           # no empty chunk
                # frames d0 .. d1 of the sequence (odd chunks walk them
                # backwards): the chunk starts at the frame before its
                # first difference, where the previous chunk ended
                assert d0 == last
                last = d1
                seen += [(d + 1, r) for d in range(d0, d1)
                         for r in range(r0, r1)]
        assert sorted(seen) == [(t, r) for t in range(1, n)
                                for r in range(h)]


# (n, h, w) → (pix, stages, copy) of the plan on 132 SMs: every build of
# k_scene a plan reaches, as chip_smoke.py's scene cases name them
SCENE_ROUTES = [((65, 224, 224), (8, 3, 16)), ((9, 37, 53), (8, 3, 4)),
                ((33, 40, 2100), (32, 3, 16)), ((33, 40, 2102), (32, 3, 4)),
                ((33, 40, 2732), (32, 2, 16)), ((33, 40, 2734), (32, 2, 4)),
                ((3, 4, 4150), (32, 2, 4))]


@pytest.mark.parametrize("shape,route", SCENE_ROUTES)
def test_scene_plan_routes(shape, route):
    plan = tscene.scene_plan(*shape, 132)
    assert (plan.pix, plan.stages, plan.copy) == route


def test_scene_plan_eight_pixels_take_three_stages():
    """Rows of at most 2,045 pixels take 8 pixels a thread, and then a
    band with its halo always fits 3 ring stages: the kernel has no
    2-stage build for them."""
    for w in range(1, 2046):
        for h in (1, 2, 64):
            plan = tscene.scene_plan(65, h, w, 132)
            assert plan.pix == 8 and plan.stages == 3, (h, w, plan)
    assert tscene.scene_plan(65, 1, 2046, 132).pix == 32


def test_scene_plan_raises_for_a_row_too_wide():
    """One row and its halo in two ring stages: 4,150 pixels fit a block's
    227 KB (threads holding 32 pixels each), 4,151 do not, and the error
    names the limit."""
    plan = tscene.scene_plan(65, 8, 4150, 132)
    assert plan.rb == 1 and plan.stages == 2 and plan.pix == 32
    with pytest.raises(ValueError, match="232448 bytes of shared memory"):
        tscene.scene_plan(65, 8, 4151, 132)
