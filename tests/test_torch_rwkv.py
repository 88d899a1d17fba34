"""The port's RWKV6 family (rwkv6-1.6b: time mix with data-dependent
decay, channel mix, LayerNorm) held against the JAX reference on the CPU
at smoke width, with the reference's own weights (``Transformer.init`` as
numpy, carried across by ``model_params_from_numpy``), in float32. The
reference runs under ``jax.jit``.

The model: the port's versions of ``tests/test_models.py``'s smoke
forward, prefill→decode parity and parameter counts (exactly the
reference's), the weights' round trip, ``tests/test_serving.py::
test_continuous_batching_matches_naive[rwkv6-1.6b]``, and the engine
against the reference's engine. The module: ``_group_norm``'s population
variance, ``insert_slot`` on the ``rwkv`` group, and the f32 state under
a bf16 cache.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import params as jparams
from repro.models import rwkv as jrwkv
from repro.models.transformer import Transformer as JTransformer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as tregistry
from repro_torch.core.convert import (model_params_from_numpy,
                                      model_params_to_numpy)
from repro_torch.models import params as tparams
from repro_torch.models import rwkv as trwkv
from repro_torch.models.transformer import init_model
from repro_torch.serving import Request, ServingEngine

ARCH = "rwkv6-1.6b"
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
    tokens, finite logits of the reference's shape and values."""
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
    states leaf for leaf; decode continues the port's own train logits
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
    assert sorted(tc) == sorted(jc) == ["pos", "rwkv"]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert sorted(tc["rwkv"]) == sorted(jc["rwkv"])
    for n, v in jc["rwkv"].items():
        assert tuple(tc["rwkv"][n].shape) == v.shape, n
        _close(tc["rwkv"][n], v)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_counts_match_reference(size):
    """tests/test_models.py::test_param_counts_positive on the port, with
    the counts equal to the reference's."""
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jregistry, get)(ARCH)
    tcfg = getattr(tregistry, get)(ARCH)
    n = tparams.count_params_analytic(tcfg)
    assert 0 < tparams.count_active_params_analytic(tcfg) == n
    assert tparams.count_params(tcfg) == jparams.count_params(jcfg)
    assert n == jparams.count_params_analytic(jcfg) == tcfg.param_count()
    assert tcfg.layer_kinds() == jcfg.layer_kinds() == ("R",) * \
        tcfg.num_layers


def test_model_params_round_trip(twin):
    """Every reference leaf (the norms' ``b`` included) lands in the
    port's model bit for bit, and the port's parameters fold back into
    the reference's tree."""
    jm, params, tm = twin
    want = jax.tree.map(np.asarray, params)
    got = model_params_to_numpy(tm.cfg, tm)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert "b" in got["final_norm"] and "b" in got["blocks"]["ln1"]


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(rid=i, tokens=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(4, 30))), max_new_tokens=5)
        for i in range(5)]


def _naive(tm, req, steps, max_len=128):
    cache = tm.init_cache(1, max_len, dtype=torch.float32)
    logits, cache, _ = tm.apply(torch.from_numpy(req.tokens)[None],
                                mode="prefill", cache=cache)
    gen = [int(torch.argmax(logits[0, -1]))]
    for _ in range(steps - 1):
        logits, cache, _ = tm.apply(torch.tensor([[gen[-1]]]),
                                    mode="decode", cache=cache)
        gen.append(int(torch.argmax(logits[0, -1])))
    return gen


def test_continuous_batching_matches_naive(twin):
    """tests/test_serving.py::test_continuous_batching_matches_naive
    [rwkv6-1.6b] on the port: 5 requests over 2 slots give each request
    the tokens of its own batch-1 prefill and decode."""
    _, _, tm = twin
    reqs = _requests(tm.cfg)
    eng = ServingEngine(tm, batch_slots=2, max_len=128,
                        cache_dtype=torch.float32)
    outs = eng.run(copy.deepcopy(reqs))
    assert len(outs) == 5
    for r in outs:
        assert r.generated[:5] == _naive(tm, reqs[r.rid], 5), r.rid


def test_engine_matches_reference_engine(twin):
    """The same 5 requests over 2 slots, greedy, prefilled at their exact
    lengths: the same tokens as the reference's engine, every step's
    top-1/top-2 gap above GAP."""
    jm, params, tm = twin
    reqs = _requests(tm.cfg)
    want = JEngine(jm.cfg, params, batch_slots=2, max_len=128,
                   cache_dtype=jnp.float32).run(
        [JRequest(rid=r.rid, tokens=r.tokens, max_new_tokens=5)
         for r in reqs])
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
        got = eng.run(reqs)
    finally:
        del tm.apply
    assert lengths == [len(r.tokens) for r in reqs]   # no pow2 bucket
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(5))
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.rid


def test_group_norm_uses_the_population_variance():
    """``_group_norm`` equals the reference's (``jnp.var``: the population
    variance, eps 64e-5), and the unbiased variance would not: at a head
    width of 8 the two differ by a factor 8/7."""
    rng = np.random.default_rng(2)
    y = rng.normal(0.3, 2.0, (2, 3, 4, 8)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, (4, 8)).astype(np.float32)
    got = trwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale),
                            64e-5)
    _close(got, jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), 64e-5),
           rtol=1e-5, atol=1e-5)
    yt = torch.from_numpy(y)
    unbiased = ((yt - yt.mean(-1, keepdim=True))
                * torch.rsqrt(yt.var(-1, keepdim=True) + 64e-5)
                * torch.from_numpy(scale))
    assert not torch.allclose(got, unbiased, rtol=1e-3, atol=1e-3)


def test_insert_slot_copies_the_rwkv_group(twin):
    """A batch-1 prefill's state lands in slot 2 of a 3-slot cache: every
    leaf of ``rwkv`` along axis 1, ``pos`` along axis 0; the other slots
    stay zero."""
    _, _, tm = twin
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        3, tm.cfg.vocab_size, (1, 11)))
    one = tm.apply(tok, mode="prefill", cache=tm.init_cache(1, 32))[1]
    cache = tm.init_cache(3, 32)
    tm.insert_slot(cache, one, 2)
    assert cache["pos"].tolist() == [0, 0, 11]
    for n, buf in cache["rwkv"].items():
        assert torch.equal(buf[:, 2:3], one["rwkv"][n]), n
        assert not buf[:, :2].any() and bool(one["rwkv"][n].any()), n


def test_state_is_f32_under_a_bf16_cache(twin):
    """The RWKV state stays f32 under a bf16 cache (the reference's
    ``rwkv6_state_init``), in the reference's shapes; so does a prefill's
    and a decode step's state, with bf16 activations."""
    jm, _, tm = twin
    jc = jm.init_cache(2, 48, dtype=jnp.bfloat16)
    tc = tm.init_cache(2, 48, dtype=torch.bfloat16)
    for n, v in tc["rwkv"].items():
        assert v.dtype == torch.float32 and jc["rwkv"][n].dtype == \
            jnp.float32
        assert tuple(v.shape) == jc["rwkv"][n].shape
    st = trwkv.rwkv6_state_init(tm.cfg, 2)
    x = torch.randn(2, 1, tm.cfg.d_model).to(torch.bfloat16)
    p = tm.blocks[0].mix
    _, tm_st = trwkv.rwkv6_time_mix(p, tm.cfg, x, st, "decode")
    _, cm_st = trwkv.rwkv6_channel_mix(p, tm.cfg, x, st, "decode")
    assert {n: t.dtype for n, t in {**tm_st, **cm_st}.items()} == {
        n: torch.float32 for n in ("wkv", "shift_tm", "shift_cm")}
