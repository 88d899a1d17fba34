"""The PyTorch port's decode attention held against the JAX reference on
the CPU: the plain versions of the two decode kernels (``gqa_decode``,
``mla_decode``) against the reference's oracles and its Pallas kernels
(interpret mode), M-RoPE, and the GQA and MLA attention layers in
prefill (with a cache, including the ring-tail branch) and decode.

The same numpy inputs go to both packages. Everything is float32.
Tolerances: the plain versions against the oracles at rtol 1e-5 / atol
1e-6 (the same formula, summed in another order; atol 1e-5 where a
softcap case's logits reach ±20); against the Pallas
kernels at rtol 2e-5 / atol 2e-5, the reference's own tolerance for its
kernels (an online softmax over blocks); the attention layers and their
caches at rtol 1e-4 / atol 1e-5 (several products in a row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels import ref as jref
from repro.kernels.decode_attention import gqa_decode as pallas_gqa
from repro.kernels.decode_attention import mla_decode as pallas_mla
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

ORACLE = dict(rtol=1e-5, atol=1e-6)
# the softcap case's logits reach ±20 (queries scaled by 4): a last-ulp
# difference in a logit is ~2e-6 absolute, and exp passes it on
SOFTCAP = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-5, atol=2e-5)
LAYER = dict(rtol=1e-4, atol=1e-5)
# DeepSeek-V2-Lite's widths: each logit sums 576 products (not 80-144),
# so the two orders of summation differ by up to ~4x more in absolute
# terms; outputs near 0 need the larger floor
WIDE = dict(rtol=1e-5, atol=5e-6)


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_kernel_launches()
    yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _valid(rng, b, c, empty_row=None):
    """(B, C) prefix masks of random lengths in [1, C]; ``empty_row`` is
    all invalid. ``"holes"``: every row two runs of valid rows with whole
    empty 64-row tiles between and after them; ``"last"``: only row C-1
    is valid."""
    if empty_row == "holes":
        valid = np.zeros((b, c), bool)
        for i in range(b):
            valid[i, 3 + i:70 + i] = True
            valid[i, c // 2 + 5:c // 2 + 40] = True
        return valid
    if empty_row == "last":
        valid = np.zeros((b, c), bool)
        valid[:, -1] = True
        return valid
    lens = rng.integers(1, c + 1, size=(b, 1))
    valid = np.arange(c)[None] < lens
    if empty_row is not None:
        valid[empty_row] = False
    return valid


# ---------------------------------------------------------------------------
# (a) the plain decode versions vs the oracles and the Pallas kernels
# ---------------------------------------------------------------------------

GQA_CASES = [
    # b, h, hkv, d, c, blk, empty row or mask — tests/test_kernels.py's
    # cases, then the bf16 kernel's edges: holes of whole tiles, a last-row
    # mask, G = 16 (its most heads per kv head), D = 80 (zamba2's width)
    (1, 4, 4, 64, 128, 64, None),      # MHA
    (2, 8, 2, 64, 256, 64, None),      # GQA 4:1
    (2, 8, 1, 128, 192, 64, None),     # MQA, non-pow2 cache
    (3, 16, 4, 32, 64, 64, None),      # single block
    (3, 8, 2, 32, 128, 64, 1),         # an all-invalid row
    (2, 8, 2, 64, 512, 64, "holes"),   # tiles with no valid row between
    (2, 4, 1, 32, 192, 64, "last"),    # only row C-1 valid
    (2, 32, 2, 64, 128, 64, None),     # G = 16
    (2, 4, 2, 80, 128, 64, None),      # D = 80
    # shapes the bf16 split kernel leaves to the per-chunk kernel
    (1, 32, 1, 72, 64, 64, None),      # G = 32, D = 72
    (2, 4, 2, 6, 64, 64, 1),           # D = 6: not a multiple of 4
]


@pytest.mark.parametrize("b,h,hkv,d,c,blk,empty", GQA_CASES)
def test_gqa_plain_matches_oracle_and_pallas(b, h, hkv, d, c, blk, empty):
    rng = np.random.default_rng(b * 1000 + h * 10 + c)
    q, k, v = (_normal(rng, s) for s in ((b, 1, h, d), (b, c, hkv, d),
                                         (b, c, hkv, d)))
    valid = _valid(rng, b, c, empty)
    kw = dict(scale=d ** -0.5, q_per_kv=h // hkv)
    got = tops.decode_attention(_t(q), _t(k), _t(v), _t(valid), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, 1, h, d)
    want = jref.decode_attention_ref(q, k, v, valid, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ORACLE)
    pallas = pallas_gqa(q, k, v, valid, blk_s=blk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **PALLAS)
    if isinstance(empty, int):   # every weight is exp(0): the mean of v
        np.testing.assert_allclose(
            got.numpy()[empty, 0],
            np.repeat(v[empty].mean(0), h // hkv, axis=0), **ORACLE)
    assert tops.kernel_launches()["gqa_decode"] == 0      # plain route


def test_gqa_plain_softcap_and_shared_mask():
    """The softcap case of tests/test_kernels.py, and a (1, C) mask that
    broadcasts over the batch."""
    rng = np.random.default_rng(1)
    b, h, d, c = 2, 4, 32, 128
    q = _normal(rng, (b, 1, h, d), 4.0)
    k, v = _normal(rng, (b, c, h, d)), _normal(rng, (b, c, h, d))
    valid = np.ones((b, c), bool)
    kw = dict(scale=0.3, softcap=20.0)
    got = tdecode.gqa_decode(_t(q), _t(k), _t(v), _t(valid), **kw)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.decode_attention_ref(q, k, v, valid,
                                                          **kw)), **SOFTCAP)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_gqa(q, k, v, valid, blk_s=64, **kw)),
        **PALLAS)
    one = np.arange(c)[None] < 77
    got1 = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(one), **kw)
    np.testing.assert_allclose(
        got1.numpy(), np.asarray(jref.decode_attention_ref(q, k, v, one,
                                                           **kw)), **SOFTCAP)


MLA_CASES = [
    # b, h, r, dr, c, blk, empty row — tests/test_kernels.py's cases
    (1, 8, 64, 16, 128, 64, None),
    (2, 16, 128, 64, 256, 128, None),
    (2, 4, 32, 16, 96, 32, None),      # non-pow2 cache
    (3, 4, 64, 16, 128, 64, 2),        # an all-invalid row
    (2, 4, 30, 16, 64, 32, None),      # R = 30: not a multiple of 4
    (2, 16, 512, 64, 96, 32, 1),       # DeepSeek-V2-Lite's widths
]


@pytest.mark.parametrize("b,h,r,dr,c,blk,empty", MLA_CASES)
def test_mla_plain_matches_oracle_and_pallas(b, h, r, dr, c, blk, empty):
    rng = np.random.default_rng(b * 1000 + h * 10 + c + 5)
    qa, qr = _normal(rng, (b, 1, h, r)), _normal(rng, (b, 1, h, dr))
    ckv, kr = _normal(rng, (b, c, r)), _normal(rng, (b, c, dr))
    valid = _valid(rng, b, c, empty)
    got = tops.mla_decode_attention(_t(qa), _t(qr), _t(ckv), _t(kr),
                                    _t(valid), scale=0.1)
    assert got.shape == (b, 1, h, r)
    want = jref.mla_decode_attention_ref(qa, qr, ckv, kr, valid, scale=0.1)
    tol = WIDE if r + dr > 512 else ORACLE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    pallas = pallas_mla(qa, qr, ckv, kr, valid, scale=0.1, blk_s=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **PALLAS)
    if empty is not None:
        np.testing.assert_allclose(
            got.numpy()[empty, 0],
            np.broadcast_to(ckv[empty].mean(0), (h, r)), **tol)
    assert tops.kernel_launches()["mla_decode"] == 0


@pytest.mark.parametrize("b,hkv,c,lo,hi", [
    (4, 4, 2048, 8, 16),     # the serving shapes: Qwen2-VL-7B, 4 slots
    (1, 4, 64, 1, 1),        # one tile
    (4, 28, 2048, 1, 32),    # q_per_kv = 1
    (4, 2, 2000, 1, 32),     # G = 16, a ragged last tile
    (3, 2, 1, 1, 1),         # a single row
    (1, 1, 100_000, 1, 1563),
])
def test_split_plan_covers_every_tile_once(b, hkv, c, lo, hi):
    splits, per = tdecode.split_plan(b, hkv, c, sms=132)
    assert lo <= splits <= hi
    tiles = -(-c // tdecode.SPLIT_TILE)
    walked = [t for s in range(splits)
              for t in range(s * per, min((s + 1) * per, tiles))]
    assert walked == list(range(tiles))           # each tile once, in order
    assert (splits - 1) * per < tiles             # no split is empty
    if splits < tiles:                            # enough blocks to fill
        assert splits * b * hkv >= tdecode.SPLIT_BLOCKS_PER_SM * 132 / 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqa_route_takes_every_shape(dtype):
    """Every (dtype, G, D) has a route: the split kernel where its bf16
    tensor-core tiles apply (G ≤ 16, D a multiple of 16 up to 256), the
    per-chunk kernel elsewhere, with rows per chunk whose shared memory
    fits a block."""
    for g in (1, 4, 7, 16, 17, 32, 128):
        for d in (1, 6, 16, 72, 80, 128, 136, 256, 264, 512):
            split = (dtype == torch.bfloat16 and g <= tdecode.SPLIT_MAX_G
                     and d % 16 == 0 and d <= 256)
            route = tdecode.gqa_route(dtype, g, d)
            assert route == ("k_gqa_split" if split else "k_partial")
            if route == "k_partial":
                heads, rows = tdecode.partial_plan(g, d, d, True, 64)
                assert 1 <= heads <= g and 1 <= rows <= 64
    # the serving shapes keep their routes, rows and heads
    assert tdecode.gqa_route(torch.bfloat16, 7, 128) == "k_gqa_split"
    assert tdecode.gqa_route(torch.bfloat16, 16, 128) == "k_gqa_split"
    assert tdecode.partial_plan(7, 128, 128, True, 64) == (7, 64)
    assert tdecode.partial_plan(40, 288, 256, False, 32) == (40, 32)


def _partial_floats(g, d, rows):
    """Shared memory of a GQA per-chunk block, in floats (the source's
    ``layout``)."""
    gp = -(-g // 4) * 4
    return -(-(d * gp + rows * (d | 1) + rows * d) // 4) * 4 + rows * gp


@pytest.mark.parametrize("g,d,want", [
    (128, 256, (128, 32)),    # all heads, fewer rows
    (128, 512, (64, 16)),     # the queries alone overflow: half the heads
    (32, 1024, (16, 16)),
    (1, 8000, (1, 1)),        # one head of one row
])
def test_partial_plan_fits_shared_memory(g, d, want):
    """Rows halve to 16 and then heads halve until a chunk's shared memory
    fits 227 KB; a width that does not fit one head and one row raises."""
    heads, rows = tdecode.partial_plan(g, d, d, True, 64)
    assert (heads, rows) == want
    assert _partial_floats(heads, d, rows) * 4 <= 227 * 1024
    if rows < 64 and rows >= 16:
        assert _partial_floats(heads, d, 2 * rows) * 4 > 227 * 1024
    with pytest.raises(ValueError):
        tdecode.partial_plan(1, 30000, 30000, True, 64)


def test_split_mask_is_viewed_without_a_copy():
    """The bf16 route's mask: a contiguous bool mask is read in place as
    uint8 (batch stride C, or 0 for a (1, C) mask); anything else is
    converted once."""
    valid = torch.rand(3, 70) < 0.5
    u8, bs = tdecode._mask_u8(valid, 3, 70, valid.device)
    assert u8.dtype == torch.uint8 and bs == 70
    assert u8.data_ptr() == valid.data_ptr()
    one, bs1 = tdecode._mask_u8(valid[:1], 3, 70, valid.device)
    assert bs1 == 0 and one.data_ptr() == valid.data_ptr()
    cols, _ = tdecode._mask_u8(valid.t().contiguous().t(), 3, 70,
                               valid.device)
    assert torch.equal(cols.bool(), valid)
    with pytest.raises(ValueError):
        tdecode._mask_u8(valid, 2, 70, valid.device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_route_takes_every_shape(dtype):
    """Every (dtype, H, R, Dr) has a route: ``k_mla`` where its bf16
    tensor-core tiles apply (R and Dr multiples of 16, R ≤ 512, Dr ≤ 64,
    any H), with a head grouping, plan and ring that fit a block;
    ``k_partial`` elsewhere, with rows per chunk that fit."""
    for h in (1, 16, 40, 128):
        for r in (30, 256, 512):
            for dr in (32, 64):
                route = tdecode.mla_route(dtype, h, r, dr)
                want = dtype == torch.bfloat16 and r % 16 == 0
                assert route == ("k_mla" if want else "k_partial")
                if route == "k_partial":
                    heads, rows = tdecode.partial_plan(h, r + dr, r, False,
                                                       32)
                    assert 1 <= heads <= h and 1 <= rows <= 32
                    continue
                hg = tdecode.mla_heads(h, r)
                assert hg % 16 == 0 and 16 <= hg <= 64
                assert hg * r <= 16 * 1024          # 64 f32 sums a thread
                assert -(-h // hg) * hg - h < 16 * -(-h // hg)
                splits, per = tdecode.mla_split_plan(4, 2048, h, r, 132)
                assert tdecode.mla_stages(hg, r, dr, per) in (2, 3)
    # widths k_mla leaves to k_partial
    for r, dr in ((16, 8), (24, 16), (528, 64), (512, 80), (256, 0)):
        assert tdecode.mla_route(torch.bfloat16, 40, r, dr) == "k_partial"
    # the serving shapes: MiniCPM3-4B's 40 heads in one block of 48;
    # DeepSeek-V2-Lite's 16 in one; DeepSeek-V3's 128 in four of 32
    assert tdecode.mla_heads(40, 256) == 48
    assert tdecode.mla_heads(16, 512) == 16
    assert tdecode.mla_heads(128, 512) == 32
    assert tdecode.mla_heads(128, 256) == 64


@pytest.mark.parametrize("b,c,h,r", [
    (4, 2048, 40, 256),       # MiniCPM3-4B, the serving shapes
    (4, 2000, 40, 256),       # a ragged last tile
    (4, 2048, 16, 512),       # DeepSeek-V2-Lite
    (4, 2048, 128, 512),      # DeepSeek-V3's heads: four groups
    (1, 64, 1, 16),           # one tile
    (3, 1, 40, 256),          # a single row
    (1, 100_000, 40, 256),
    (16, 8192, 40, 256),      # more blocks than SMs at one tile a split
])
def test_mla_split_plan_covers_every_tile_once(b, c, h, r):
    """Each tile once, in order, no split empty; one wave of blocks (one
    a SM, or every tile its own split); and each split's f32 partial
    (hg × R per head group) at most twice the ckv bytes of the tiles it
    walks."""
    splits, per = tdecode.mla_split_plan(b, c, h, r, sms=132)
    tiles = -(-c // tdecode.MLA_TILE)
    walked = [t for s in range(splits)
              for t in range(s * per, min((s + 1) * per, tiles))]
    assert walked == list(range(tiles))
    assert (splits - 1) * per < tiles
    hg = tdecode.mla_heads(h, r)
    groups = -(-h // hg)
    assert splits * b * groups <= 132 + b * groups or per == 1
    assert per == 1 or (splits - 1) * b * groups < 132
    assert 4 * hg * r <= 2 * per * tdecode.MLA_TILE * r * 2


def test_mla_smem_fits_every_routed_shape():
    """At every shape the route sends to k_mla (H up to 160, R and Dr up
    to 512 and 64, C up to 2^20) the block's shared memory, with the
    ring's stages the wrapper picks, fits 227 KB (the card checks the
    formula against the source's ``layout``)."""
    for h in (1, 15, 16, 17, 40, 64, 65, 128, 160):
        for r in range(16, 513, 16):
            for dr in (16, 32, 48, 64):
                assert tdecode.mla_route(torch.bfloat16, h, r, dr) == "k_mla"
                hg = tdecode.mla_heads(h, r)
                for c in (1, 2048, 100_000, 1 << 20):
                    _, per = tdecode.mla_split_plan(4, c, h, r, 132)
                    st = tdecode.mla_stages(hg, r, dr, per)
                    smem = tdecode.mla_smem_bytes(hg, r, dr, st, per)
                    assert smem <= 227 * 1024
    # MiniCPM3-4B takes a 3-stage ring; DeepSeek's 576-wide rows two
    assert tdecode.mla_stages(48, 256, 32, 5) == 3
    assert tdecode.mla_stages(16, 512, 64, 2) == 2
    with pytest.raises(ValueError):
        tdecode.mla_stages(64, 2048, 64, 1)


def test_mla_routes_are_listed_and_reset():
    assert set(tdecode.mla_decode.route_launches) == {"k_mla", "k_partial"}
    tdecode.mla_decode.route_launches["k_mla"] = 3
    tdecode.gqa_decode.route_launches["k_partial"] = 2
    tops.reset_kernel_launches()
    assert set(tdecode.mla_decode.route_launches.values()) == {0}
    assert set(tdecode.gqa_decode.route_launches.values()) == {0}


def test_decode_kernels_are_listed():
    launches = tops.kernel_launches()
    assert {"gqa_decode", "mla_decode"} <= set(launches)
    assert tdecode.gqa_decode.launches == tdecode.mla_decode.launches == 0
    assert set(tdecode.gqa_decode.route_launches) == {"k_gqa_split",
                                                      "k_partial"}


# ---------------------------------------------------------------------------
# (b) M-RoPE, and the attention layers in prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_mrope_matches_reference(sections):
    rng = np.random.default_rng(3)
    d = 2 * sum(sections)
    x = _normal(rng, (2, 9, 3, d))
    pos3 = rng.integers(0, 300, size=(3, 2, 9)).astype(np.int32)
    want = jlayers.apply_mrope(x, pos3, theta=1e6, sections=sections)
    got = tlayers.apply_mrope(_t(x), _t(pos3), theta=1e6, sections=sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ORACLE)


def _gqa_cfg(kind):
    """(reference cfg, port cfg): qwen2-vl smoke (M-RoPE), or its RoPE
    variant with qk-norm and a logit softcap."""
    j = jregistry.get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
    t = tregistry.get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
    if kind == "rope_softcap":
        kw = dict(pos_type="rope", qk_norm=True, attn_logit_softcap=30.0)
        j, t = j.replace(**kw), t.replace(**kw)
    return j, t


def _jit(fn):
    """The reference layer under ``jax.jit`` (one compile per mode, where
    eager dispatch compiles every primitive: ~6x faster here)."""
    return jax.jit(fn, static_argnames=("mode",))


def _run_layer(jfn, tfn, jp, tp, x, jkw, tkw, cache_len, b, s, rng):
    """Prefill (with a cache of ``cache_len`` rows) then two decode steps
    at per-slot positions, in both packages; checks outputs and caches."""
    jcache, tcache = cache_len
    jout, jc = jfn(jp, x, mode="prefill", cache=jcache, **jkw(s, None))
    tout, tc = tfn(tp, _t(x), mode="prefill", cache=tcache, **tkw(s, None))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **LAYER)
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **LAYER)
    pos = np.asarray([s, s - 3][:b], np.int32)
    for step in range(2):
        xd = _normal(rng, (b, 1, x.shape[-1]))
        jout, jc = jfn(jp, xd, mode="decode", cache=jc,
                       cache_pos=jnp.asarray(pos), **jkw(1, pos))
        tout, tc = tfn(tp, _t(xd), mode="decode", cache=tc,
                       cache_pos=_t(pos), **tkw(1, pos))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **LAYER)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **LAYER)
        pos = pos + 1


@pytest.mark.parametrize("kind", ["mrope", "rope_softcap"])
@pytest.mark.parametrize("cache_len", [16, 8])     # 8 < S: the ring tail
def test_gqa_attention_prefill_decode_matches_reference(kind, cache_len):
    jcfg, tcfg = _gqa_cfg(kind)
    rng = np.random.default_rng(11)
    jp = jattn.gqa_init(jax.random.key(4), jcfg)
    tp = {k: _t(v) for k, v in jp.items()}
    b, s = 2, 12
    x = _normal(rng, (b, s, jcfg.d_model))

    def positions(n, pos):
        if pos is None:
            p = np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
        else:
            p = pos[:, None].astype(np.int32)
        p3 = np.broadcast_to(p[None] + 5, (3, b, n)).astype(np.int32)
        return p, p3

    def jkw(n, pos):
        p, p3 = positions(n, pos)
        return dict(positions=jnp.asarray(p), mrope_positions=(
            jnp.asarray(p3) if kind == "mrope" else None))

    def tkw(n, pos):
        p, p3 = positions(n, pos)
        return dict(positions=_t(p),
                    mrope_positions=_t(p3) if kind == "mrope" else None)

    caches = (jattn.gqa_cache_init(jcfg, b, cache_len, jnp.float32),
              tattn.gqa_cache_init(tcfg, b, cache_len, torch.float32))
    _run_layer(_jit(lambda p, x, mode, **kw: jattn.gqa_attention(
                   p, jcfg, x, mode=mode, **kw)),
               lambda p, x, **kw: tattn.gqa_attention(p, tcfg, x, **kw),
               jp, tp, x, jkw, tkw, caches, b, s, rng)


@pytest.mark.parametrize("q_lora", [96, 0])
@pytest.mark.parametrize("cache_len", [16, 8])
def test_mla_attention_prefill_decode_matches_reference(q_lora, cache_len):
    jcfg = jregistry.get_smoke_config("minicpm3-4b").replace(dtype="float32")
    tcfg = tregistry.get_smoke_config("minicpm3-4b").replace(dtype="float32")
    jcfg = jcfg.replace(mla=jcfg.mla.__class__(**{
        **jcfg.mla.__dict__, "q_lora_rank": q_lora}))
    tcfg = tcfg.replace(mla=tcfg.mla.__class__(**{
        **tcfg.mla.__dict__, "q_lora_rank": q_lora}))
    rng = np.random.default_rng(12)
    jp = jattn.mla_init(jax.random.key(5), jcfg)
    assert ("w_dq" in jp) == bool(q_lora)
    tp = {k: _t(v) for k, v in jp.items()}
    b, s = 2, 12
    x = _normal(rng, (b, s, jcfg.d_model))

    def pos(n, p):
        if p is None:
            return np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
        return p[:, None].astype(np.int32)

    caches = (jattn.mla_cache_init(jcfg, b, cache_len, jnp.float32),
              tattn.mla_cache_init(tcfg, b, cache_len, torch.float32))
    _run_layer(_jit(lambda p, x, mode, **kw: jattn.mla_attention(
                   p, jcfg, x, mode=mode, **kw)),
               lambda p, x, **kw: tattn.mla_attention(p, tcfg, x, **kw),
               jp, tp, x,
               lambda n, p: dict(positions=jnp.asarray(pos(n, p))),
               lambda n, p: dict(positions=_t(pos(n, p))),
               caches, b, s, rng)
