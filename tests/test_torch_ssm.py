"""The port's Mamba2 family — zamba2-2.7b's hybrid (Mamba2 blocks with one
weight-tied attention block after each group of ``shared_attn_period``)
— held against the JAX reference on the CPU at smoke width, with the
reference's own weights (``Transformer.init`` as numpy, carried across
by ``model_params_from_numpy``), in float32. The reference runs under
``jax.jit``.

The model: the port's versions of ``tests/test_models.py``'s smoke
forward, prefill→decode parity and parameter counts (exactly the
reference's), the weights' round trip, and the engine against the
reference's engine (exact-length prefill). The module: ``mamba2_apply``
at a prompt shorter than the chunk, two chunks, and a length that pads
the last chunk (train and prefill, the caches leaf for leaf, then
decode); ``insert_slot`` on the ``mamba`` and ``shared`` groups; the f32
recurrent state under a bf16 cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.transformer import Transformer as JTransformer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as tregistry
from repro_torch.core.convert import (model_params_from_numpy,
                                      model_params_to_numpy)
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import init_model
from repro_torch.serving import Request, ServingEngine

ARCH = "zamba2-2.7b"
LOGITS = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4          # least top-1/top-2 logit gap of a greedy token


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or LOGITS))


@pytest.fixture(scope="module")
def twin():
    """(reference model, its params, port model with the same weights)."""
    jcfg = jregistry.get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tregistry.get_smoke_config(ARCH).replace(dtype="float32")
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    jm.apply = jax.jit(jm.apply, static_argnames=("mode",))
    return jm, params, tm


def test_smoke_forward(twin):
    """tests/test_models.py::test_smoke_forward on the port: (2, 32)
    tokens (two chunks of the smoke SSD), finite logits of the
    reference's shape and values."""
    jm, params, tm = twin
    cfg = tm.cfg
    tok = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    logits, cache, aux = tm.apply(torch.from_numpy(tok), mode="train")
    assert tuple(logits.shape) == (2, 32, cfg.vocab_size) and cache is None
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
    _close(logits, jm.apply(params, jnp.asarray(tok), mode="train")[0])


def test_prefill_decode_parity(twin):
    """Train, prefill and decode logits equal the reference's (1e-4), the
    caches leaf for leaf; decode continues the port's own train logits
    (1e-3, the reference test's bound)."""
    jm, params, tm = twin
    cfg = tm.cfg
    b, s, extra = 2, 20, 6
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + extra)).astype(np.int32)
    full, _, _ = tm.apply(torch.from_numpy(tok), mode="train")
    _close(full, jm.apply(params, jnp.asarray(tok), mode="train")[0])
    jc = jm.init_cache(b, s + extra, dtype=jnp.float32)
    tc = tm.init_cache(b, s + extra, dtype=torch.float32)
    jl, jc, _ = jm.apply(params, jnp.asarray(tok[:, :s]), mode="prefill",
                         cache=jc)
    tl, tc, _ = tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                         cache=tc)
    _close(tl, jl)
    for t in range(extra):
        step = tok[:, s + t:s + t + 1]
        jl, jc, _ = jm.apply(params, jnp.asarray(step), mode="decode",
                             cache=jc)
        tl, tc, _ = tm.apply(torch.from_numpy(step), mode="decode",
                             cache=tc)
        _close(tl, jl)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, s + t].numpy(),
                                   rtol=1e-3, atol=1e-3)
    assert sorted(tc) == sorted(jc) == ["mamba", "pos", "shared"]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for g in ("mamba", "shared"):
        assert sorted(tc[g]) == sorted(jc[g])
        for n, v in jc[g].items():
            assert tuple(tc[g][n].shape) == v.shape, (g, n)
            _close(tc[g][n], v)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_counts_match_reference(size):
    """tests/test_models.py::test_param_counts_positive on the port, with
    the counts equal to the reference's (the shared block once)."""
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jregistry, get)(ARCH)
    tcfg = getattr(tregistry, get)(ARCH)
    n = tparams.count_params_analytic(tcfg)
    assert 0 < tparams.count_active_params_analytic(tcfg) == n
    assert tparams.count_params(tcfg) == jparams.count_params(jcfg)
    assert n == jparams.count_params_analytic(jcfg) == tcfg.param_count()
    assert tcfg.layer_kinds() == jcfg.layer_kinds()


def test_model_params_round_trip(twin):
    """Every reference leaf lands in the port's model bit for bit (the
    stacked Mamba blocks and the one shared block), and the port's
    parameters fold back into the reference's tree."""
    jm, params, tm = twin
    want = jax.tree.map(np.asarray, params)
    got = model_params_to_numpy(tm.cfg, tm)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_engine_matches_reference_engine(twin):
    """4 requests over 2 slots, greedy, prefilled at their exact lengths
    (one of 37 tokens: three chunks, the last padded): the same tokens as
    the reference's engine, every step's top-1/top-2 gap above GAP."""
    jm, params, tm = twin
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(3, tm.cfg.vocab_size, size=n))
            for i, n in enumerate((37, 9, 21, 5))]
    want = JEngine(jm.cfg, params, batch_slots=2, max_len=128,
                   cache_dtype=jnp.float32).run(
        [JRequest(rid=i, tokens=t, max_new_tokens=5) for i, t in reqs])
    eng = ServingEngine(tm, batch_slots=2, max_len=128,
                        cache_dtype=torch.float32)
    lengths, gaps = [], []
    apply = tm.apply

    def spy(tokens, **kw):
        active = [i for i, r in enumerate(eng._slot_req) if r is not None]
        out = apply(tokens, **kw)
        if kw.get("mode") == "prefill":
            lengths.append(tokens.shape[1])
        rows = out[0][:, -1] if kw.get("mode") == "prefill" else \
            out[0][active, -1]
        top = torch.topk(rows.to(torch.float32), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return out
    tm.apply = spy
    try:
        got = eng.run([Request(rid=i, tokens=t, max_new_tokens=5)
                       for i, t in reqs])
    finally:
        del tm.apply
    assert lengths == [37, 9, 21, 5]          # no pow2 bucket
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(4))
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.rid


# ---------------------------------------------------------------------------
# the Mamba2 layer alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba(twin):
    """(reference layer params, port layer params, config): layer 1."""
    jm, params, tm = twin
    jp = jax.tree.map(lambda a: np.asarray(a)[1], params["blocks"]["mamba"])
    return jp, tm.blocks[1].mamba, tm.cfg


@pytest.mark.parametrize("s", [10, 32, 37])
def test_mamba2_apply_matches_reference(mamba, s):
    """``mamba2_apply`` at s < chunk (one chunk of s), s = 2 × chunk, and
    s = 37 (the last of three chunks padded with dt = 0): train output,
    prefill output and cache (the SSD state and both conv states), then
    three decode steps from that cache, against the reference's."""
    jp, tp, cfg = mamba
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (2, s + 3, cfg.d_model)).astype(np.float32)
    jfn = jax.jit(jssm.mamba2_apply, static_argnames=("cfg", "mode"))
    for mode in ("train", "prefill"):
        jc = jssm.mamba2_cache_init(cfg, 2) if mode == "prefill" else None
        jy, jc = jfn(jp, cfg, jnp.asarray(x[:, :s]), cache=jc, mode=mode)
        tc = tssm.mamba2_cache_init(cfg, 2) if mode == "prefill" else None
        ty, tc = tssm.mamba2_apply(tp, cfg, torch.from_numpy(x[:, :s]),
                                   cache=tc, mode=mode)
        _close(ty, jy)
    assert sorted(tc) == sorted(jc) == ["conv_bc", "conv_x", "ssm"]
    for n in jc:
        assert tc[n].dtype == torch.float32
        _close(tc[n], jc[n])
    for t in range(s, s + 3):
        jy, jc = jfn(jp, cfg, jnp.asarray(x[:, t:t + 1]), cache=jc,
                     mode="decode")
        ty, tc = tssm.mamba2_apply(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                                   cache=tc, mode="decode")
        _close(ty, jy)
        for n in jc:
            _close(tc[n], jc[n])


def test_insert_slot_copies_mamba_and_shared_groups(twin):
    """A batch-1 prefill's cache lands in slot 1 of a 3-slot cache: every
    leaf of ``mamba`` (f32) and ``shared`` (bf16) along axis 1, ``pos``
    along axis 0; the other slots stay zero."""
    _, _, tm = twin
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        3, tm.cfg.vocab_size, (1, 19)))
    one = tm.apply(tok, mode="prefill", cache=tm.init_cache(1, 32))[1]
    cache = tm.init_cache(3, 32)
    tm.insert_slot(cache, one, 1)
    assert cache["pos"].tolist() == [0, 19, 0]
    for g in ("mamba", "shared"):
        for n, buf in cache[g].items():
            assert torch.equal(buf[:, 1:2], one[g][n]), (g, n)
            assert not buf[:, 0].any() and not buf[:, 2].any(), (g, n)
            assert bool(one[g][n].any()), (g, n)


def test_recurrent_state_is_f32_under_a_bf16_cache(twin):
    """The Mamba leaves stay f32 under a bf16 cache (the reference's
    ``mamba2_cache_init``), the shared block's KV cache takes the cache
    dtype, and the shapes are the reference's."""
    jm, _, tm = twin
    jc = jm.init_cache(2, 48, dtype=jnp.bfloat16)
    tc = tm.init_cache(2, 48, dtype=torch.bfloat16)
    for n, v in tc["mamba"].items():
        assert v.dtype == torch.float32 and jc["mamba"][n].dtype == \
            jnp.float32
        assert tuple(v.shape) == jc["mamba"][n].shape
    for n, v in tc["shared"].items():
        assert v.dtype == torch.bfloat16
        assert tuple(v.shape) == jc["shared"][n].shape
    assert tc["shared"]["k"].shape[0] == 2      # 4 layers, a period of 2
