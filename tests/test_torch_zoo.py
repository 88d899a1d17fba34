"""The port's model zoo beyond the first two architectures — glm4-9b
(partial rotary), nemotron-4-15b (squared-ReLU, non-gated MLP),
deepseek-7b, olmoe-1b-7b (MoE, QK-norm) and deepseek-v2-lite-16b (MLA
without query compression, shared experts, a leading dense block) —
held against the JAX reference on the CPU at smoke width, with the
reference's own weights (``Transformer.init`` as numpy, carried across
by ``model_params_from_numpy``), in float32. The reference's model runs
under ``jax.jit``.

Each test is parametrised over the five archs: the port's versions of
``tests/test_models.py``'s prefill→decode parity, sliding-window ring
cache, right-padded prefill and parameter counts; the round trip of
the weights; the engine against the reference's engine; and, on OLMoE,
``tests/test_serving.py::test_serve_step_factory_shapes``. One more
test holds the dry runs' input shapes to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import params as jparams
from repro.models.transformer import Transformer as JTransformer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import make_serve_step as jmake_serve_step
from repro_torch.configs import registry as tregistry
from repro_torch.core.convert import (model_params_from_numpy,
                                      model_params_to_numpy)
from repro_torch.models import params as tparams
from repro_torch.models.transformer import GROUPS, init_model
from repro_torch.serving import Request, ServingEngine, make_serve_step

LOGITS = dict(rtol=1e-4, atol=1e-4)
AUX = dict(rtol=1e-6, atol=1e-6)
GAP = 1e-4          # least top-1/top-2 logit gap of a greedy token
ARCHS = ["glm4-9b", "nemotron-4-15b", "deepseek-7b", "olmoe-1b-7b",
         "deepseek-v2-lite-16b"]


def _pair(arch, **kw):
    jcfg = jregistry.get_smoke_config(arch).replace(dtype="float32", **kw)
    tcfg = tregistry.get_smoke_config(arch).replace(dtype="float32", **kw)
    return jcfg, tcfg


def _port(tcfg, params):
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    return tm


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    """(reference model, its params, port model with the same weights)."""
    jcfg, tcfg = _pair(request.param)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    tm = _port(tcfg, params)
    jm.apply = jax.jit(jm.apply, static_argnames=("mode",))
    return jm, params, tm


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or LOGITS))


def test_prefill_decode_parity(twin):
    """Train, prefill and decode logits and the aux loss equal the
    reference's (logits rtol/atol 1e-4, aux 1e-6); decode continues the
    port's own train logits (1e-3, the reference test's bound)."""
    jm, params, tm = twin
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    b, s, extra = 2, 20, 6
    tok = rng.integers(0, cfg.vocab_size, (b, s + extra)).astype(np.int32)
    jfull, _, jaux = jm.apply(params, jnp.asarray(tok), mode="train")
    full, _, aux = tm.apply(torch.from_numpy(tok), mode="train")
    _close(full, jfull)
    _close(aux, jaux, **AUX)
    jc = jm.init_cache(b, s + extra, dtype=jnp.float32)
    tc = tm.init_cache(b, s + extra, dtype=torch.float32)
    assert sorted(g for g in GROUPS if g in tc) == sorted(
        g for g in GROUPS if g in jc)
    jl, jc, jaux = jm.apply(params, jnp.asarray(tok[:, :s]), mode="prefill",
                            cache=jc)
    tl, tc, aux = tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                           cache=tc)
    _close(tl, jl)
    _close(aux, jaux, **AUX)
    for t in range(extra):
        step = tok[:, s + t:s + t + 1]
        jl, jc, jaux = jm.apply(params, jnp.asarray(step), mode="decode",
                                cache=jc)
        tl, tc, aux = tm.apply(torch.from_numpy(step), mode="decode",
                               cache=tc)
        _close(tl, jl)
        _close(aux, jaux, **AUX)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, s + t].numpy(),
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for g in GROUPS:
        for n, v in jc.get(g, {}).items():
            np.testing.assert_allclose(tc[g][n].numpy(), np.asarray(v),
                                       **LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sliding_window_cache_bounded(arch):
    """The port's version of tests/test_models.py::
    test_sliding_window_cache_bounded, on every arch: ring-buffer decode
    over an 8-row window equals the reference's train logits with the
    same window."""
    jcfg, tcfg = _pair(arch, sliding_window=8)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    tm = _port(tcfg, params)
    tok = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (1, 24)).astype(np.int32)
    want, _, _ = jax.jit(jm.apply, static_argnames=("mode",))(
        params, jnp.asarray(tok), mode="train")
    cache = tm.init_cache(1, 64, dtype=torch.float32)
    group = "moe" if tcfg.moe and not tcfg.moe.first_dense_layers else \
        "dense"
    assert next(iter(cache[group].values())).shape[2] == 8
    _, cache, _ = tm.apply(torch.from_numpy(tok[:, :4]), mode="prefill",
                           cache=cache)
    for t in range(4, 23):
        dl, cache, _ = tm.apply(torch.from_numpy(tok[:, t:t + 1]),
                                mode="decode", cache=cache)
        _close(dl[:, 0], np.asarray(want)[:, t])


def test_prompt_lengths_padding_equivalence(twin):
    """The port's version of tests/test_models.py::
    test_prompt_lengths_padding_equivalence: right-padded prefill with
    prompt_lengths equals exact-length prefill (the smoke MoE configs
    drop no token, so the pads' pairs take no real token's slot), decode
    continues identically, and the padded run matches the reference's."""
    jm, params, tm = twin
    tok = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (1, 13)).astype(np.int32)
    padded = np.pad(tok, ((0, 0), (0, 19)))
    c1, c2 = (tm.init_cache(1, 64, torch.float32) for _ in range(2))
    exact, c1, _ = tm.apply(torch.from_numpy(tok), mode="prefill", cache=c1)
    pad, c2, _ = tm.apply(torch.from_numpy(padded), mode="prefill",
                          cache=c2, prompt_lengths=torch.tensor([13]))
    np.testing.assert_allclose(exact.numpy(), pad.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(c2["pos"][0]) == 13
    jc = jm.init_cache(1, 64, dtype=jnp.float32)
    jpad, jc, _ = jm.apply(params, jnp.asarray(padded), mode="prefill",
                           cache=jc, prompt_lengths=jnp.asarray([13]))
    _close(pad, jpad)
    nxt = np.asarray([[5]], np.int32)
    d1, _, _ = tm.apply(torch.from_numpy(nxt), mode="decode", cache=c1)
    d2, _, _ = tm.apply(torch.from_numpy(nxt), mode="decode", cache=c2)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5, atol=1e-5)
    jd, _, _ = jm.apply(params, jnp.asarray(nxt), mode="decode", cache=jc)
    _close(d2, jd)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_padded_prefill_pads_take_capacity_like_the_reference(arch):
    """At capacity factor 1.0 a right-padded bucket's pad tokens route
    through the MoE and take slots, in the port as in the reference
    (which passes ``prompt_lengths`` to attention only): the padded
    prefill's logits and aux equal the reference's."""
    jcfg, tcfg = _pair(arch)
    jcfg = jcfg.replace(moe=jcfg.moe.__class__(
        **{**jcfg.moe.__dict__, "capacity_factor": 1.0}))
    tcfg = tcfg.replace(moe=tcfg.moe.__class__(
        **{**tcfg.moe.__dict__, "capacity_factor": 1.0}))
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    tm = _port(tcfg, params)
    tok = np.random.default_rng(5).integers(
        3, tcfg.vocab_size, (1, 21)).astype(np.int32)
    padded = np.pad(tok, ((0, 0), (0, 11)))
    jl, _, jaux = jm.apply(params, jnp.asarray(padded), mode="prefill",
                           cache=jm.init_cache(1, 64, dtype=jnp.float32),
                           prompt_lengths=jnp.asarray([21]))
    tl, _, aux = tm.apply(torch.from_numpy(padded), mode="prefill",
                          cache=tm.init_cache(1, 64, torch.float32),
                          prompt_lengths=torch.tensor([21]))
    _close(tl, jl)
    _close(aux, jaux, **AUX)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_counts_match_reference(arch, size):
    """The port's version of tests/test_models.py::
    test_param_counts_positive, with the counts equal to the
    reference's: total, non-embedding and active."""
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jregistry, get)(arch)
    tcfg = getattr(tregistry, get)(arch)
    n = tparams.count_params_analytic(tcfg)
    na = tparams.count_active_params_analytic(tcfg)
    assert 0 < na <= n
    if tcfg.moe is not None:
        assert na < n
    assert tparams.count_params(tcfg) == jparams.count_params(jcfg)
    assert n == jparams.count_params_analytic(jcfg) == tcfg.param_count()
    assert na == jparams.count_active_params_analytic(jcfg) == \
        tcfg.active_param_count()


def test_input_shapes_match_reference():
    """The dry runs' input shapes, field for field, and ``get_shape``'s
    lookup and its error on an unknown name."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert {k: dataclasses.astuple(v) for k, v in
            tbase.INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jbase.INPUT_SHAPES.items()}
    for name in jbase.INPUT_SHAPES:
        assert tbase.get_shape(name) is tbase.INPUT_SHAPES[name]
    with pytest.raises(KeyError, match="unknown shape"):
        tbase.get_shape("train_8k")


def test_model_params_round_trip(twin):
    """Every reference leaf lands in the port's model bit for bit, and
    the port's parameters fold back into the reference's tree."""
    jm, params, tm = twin
    want = jax.tree.map(np.asarray, params)
    got = model_params_to_numpy(tm.cfg, tm)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def _spy_gaps(eng):
    """Record the top-1/top-2 logit gap of every active row the engine's
    model produces."""
    gaps = []
    apply = eng.model.apply

    def spy(*args, **kw):
        active = [i for i, r in enumerate(eng._slot_req) if r is not None]
        out = apply(*args, **kw)
        rows = out[0][:, -1] if kw.get("mode") == "prefill" else \
            out[0][active, -1]
        top = torch.topk(rows.to(torch.float32), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return out
    eng.model.apply = spy
    return gaps, lambda: delattr(eng.model, "apply")


def test_engine_matches_reference_engine(twin):
    """5 requests over 2 slots, greedy: the same tokens as the
    reference's engine (prompts right-padded into pow2 buckets, whose
    pads route through the MoE in both)."""
    jm, params, tm = twin
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(3, tm.cfg.vocab_size,
                             size=int(rng.integers(4, 30))))
            for i in range(5)]
    want = JEngine(jm.cfg, params, batch_slots=2, max_len=128,
                   cache_dtype=jnp.float32).run(
        [JRequest(rid=i, tokens=t, max_new_tokens=5) for i, t in reqs])
    eng = ServingEngine(tm, batch_slots=2, max_len=128,
                        cache_dtype=torch.float32)
    gaps, unspy = _spy_gaps(eng)
    got = eng.run([Request(rid=i, tokens=t, max_new_tokens=5)
                   for i, t in reqs])
    unspy()
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(5))
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.rid


def test_serve_step_factory_shapes():
    """tests/test_serving.py::test_serve_step_factory_shapes on the port:
    OLMoE smoke, a cache at positions 5 and 9; the step's tokens equal
    the reference step's."""
    jcfg, tcfg = _pair("olmoe-1b-7b")
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    tm = _port(tcfg, params)
    jc = jm.init_cache(2, 32, dtype=jnp.float32)
    jc["pos"] = jnp.asarray([5, 9], jnp.int32)
    tc = tm.init_cache(2, 32, dtype=torch.float32)
    tc["pos"] = torch.tensor([5, 9], dtype=torch.int32)
    assert sorted(g for g in GROUPS if g in tc) == ["moe"]
    tok = np.asarray([[4], [7]], np.int32)
    jn, jnc = jax.jit(jmake_serve_step(jcfg))(params, jnp.asarray(tok), jc)
    nxt, nc = make_serve_step(tm)(torch.from_numpy(tok), tc)
    assert tuple(nxt.shape) == (2,)
    assert nc["pos"].tolist() == [6, 10] == np.asarray(jnc["pos"]).tolist()
    assert nxt.tolist() == np.asarray(jn).tolist()
