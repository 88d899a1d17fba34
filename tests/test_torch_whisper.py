"""The port's audio family (whisper-base: a bidirectional encoder over
frame embeddings, a decoder with learned positions, causal self-attention
with a KV cache, cross attention over the encoder's output, LayerNorm and
a tied head) held against the JAX reference on the CPU at smoke width,
with the reference's own weights (``Transformer.init`` as numpy, carried
across by ``model_params_from_numpy``), in float32. The reference runs
under ``jax.jit``.

The model: the port's versions of ``tests/test_models.py``'s smoke
forward, prefill→decode parity and parameter counts (exactly the
reference's), the weights' round trip, the engine against the
reference's engine (each request with its own encoder frames) and
``make_prefill_step``. The module: ``cross_attention``, ``insert_slot``
on the ``self`` group and ``enc_out``, and ``enc_out`` in the cache dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import params as jparams
from repro.models.transformer import Transformer as JTransformer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import make_prefill_step as jmake_prefill_step
from repro_torch.configs import registry as tregistry
from repro_torch.core.convert import (model_params_from_numpy,
                                      model_params_to_numpy)
from repro_torch.models import attention as tattn
from repro_torch.models import params as tparams
from repro_torch.models.transformer import init_model
from repro_torch.serving import Request, ServingEngine, make_prefill_step

ARCH = "whisper-base"
LOGITS = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4          # least top-1/top-2 logit gap of a greedy token


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or LOGITS))


def _frames(cfg, b, seed):
    """(b, encoder_seq_len, d) frame embeddings, N(0, 0.02) as the
    reference's tests and launcher draw them."""
    return np.random.default_rng(seed).normal(
        0, 0.02, (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


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
    tokens over (2, 64) frames, finite logits of the reference's shape and
    values."""
    jm, params, tm = twin
    cfg = tm.cfg
    tok = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    fr = _frames(cfg, 2, 5)
    logits, cache, aux = tm.apply(torch.from_numpy(tok), mode="train",
                                  encoder_frames=torch.from_numpy(fr))
    assert tuple(logits.shape) == (2, 32, cfg.vocab_size) and cache is None
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
    _close(logits, jm.apply(params, jnp.asarray(tok), mode="train",
                            encoder_frames=jnp.asarray(fr))[0])


def test_prefill_decode_parity(twin):
    """Train, prefill and decode logits equal the reference's (1e-4), the
    caches (self-attention KV and ``enc_out``) leaf for leaf; decode, which
    reads the encoder's output back from the cache, continues the port's
    own train logits (1e-3, the reference test's bound)."""
    jm, params, tm = twin
    cfg = tm.cfg
    b, s, extra = 2, 20, 6
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + extra)).astype(np.int32)
    fr = _frames(cfg, b, 2)
    full, _, _ = tm.apply(torch.from_numpy(tok), mode="train",
                          encoder_frames=torch.from_numpy(fr))
    _close(full, jm.apply(params, jnp.asarray(tok), mode="train",
                          encoder_frames=jnp.asarray(fr))[0])
    jc = jm.init_cache(b, s + extra, dtype=jnp.float32)
    tc = tm.init_cache(b, s + extra, dtype=torch.float32)
    jl, jc, _ = jm.apply(params, jnp.asarray(tok[:, :s]), mode="prefill",
                         cache=jc, encoder_frames=jnp.asarray(fr))
    tl, tc, _ = tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                         cache=tc, encoder_frames=torch.from_numpy(fr))
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
    assert sorted(tc) == sorted(jc) == ["enc_out", "pos", "self"]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["enc_out"], jc["enc_out"])
    assert sorted(tc["self"]) == sorted(jc["self"])
    for n, v in jc["self"].items():
        assert tuple(tc["self"][n].shape) == v.shape, n
        _close(tc["self"][n], v)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_counts_match_reference(size):
    """tests/test_models.py::test_param_counts_positive on the port, with
    the counts equal to the reference's (``enc_pos_embed`` and
    ``pos_embed`` are embeddings)."""
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jregistry, get)(ARCH)
    tcfg = getattr(tregistry, get)(ARCH)
    n = tparams.count_params_analytic(tcfg)
    assert 0 < tparams.count_active_params_analytic(tcfg) == n
    assert tparams.count_params(tcfg) == jparams.count_params(jcfg)
    assert n == jparams.count_params_analytic(jcfg) == tcfg.param_count()


def test_model_params_round_trip(twin):
    """Every reference leaf (encoder, decoder with ``ln_x``/``xattn``,
    both position tables, both final norms; no ``lm_head``: the head is
    the embedding) lands in the port's model bit for bit, and the port's
    parameters fold back into the reference's tree."""
    jm, params, tm = twin
    want = jax.tree.map(np.asarray, params)
    got = model_params_to_numpy(tm.cfg, tm)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert "lm_head" not in got and "xattn" in got["blocks"]


def test_engine_matches_reference_engine(twin):
    """4 requests over 2 slots, greedy, each with its own encoder frames
    (prompts in pow2 buckets: the decoder is attention): the same tokens
    as the reference's engine, every step's top-1/top-2 gap above GAP."""
    jm, params, tm = twin
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(3, cfg.vocab_size, size=n), _frames(cfg, 1, i)[0])
            for i, n in enumerate((13, 5, 22, 9))]
    want = JEngine(jm.cfg, params, batch_slots=2, max_len=64,
                   cache_dtype=jnp.float32).run(
        [JRequest(rid=i, tokens=t, max_new_tokens=5, encoder_frames=f)
         for i, t, f in reqs])
    eng = ServingEngine(tm, batch_slots=2, max_len=64,
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
        got = eng.run([Request(rid=i, tokens=t, max_new_tokens=5,
                               encoder_frames=f) for i, t, f in reqs])
    finally:
        del tm.apply
    assert lengths == [16, 16, 32, 16]
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(4))
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.rid


def test_prefill_step_reads_the_encoder_frames(twin):
    """``make_prefill_step`` passes an audio model its frames: the
    last-token logits equal the reference's step's, and the bf16 cache
    holds ``enc_out`` in bf16 as the reference's does, within one bf16
    ulp of it (f32 values a few 1e-7 apart may round to neighbouring
    bf16 values)."""
    jm, params, tm = twin
    tok = np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    fr = _frames(tm.cfg, 2, 7)
    jl, jc = jax.jit(jmake_prefill_step(jm.cfg, 32))(
        params, jnp.asarray(tok), encoder_frames=jnp.asarray(fr))
    tl, tc = make_prefill_step(tm, 32)(torch.from_numpy(tok),
                                       encoder_frames=torch.from_numpy(fr))
    _close(tl, jl)
    assert tc["enc_out"].dtype == torch.bfloat16 and jc["enc_out"].dtype \
        == jnp.bfloat16
    _close(tc["enc_out"].to(torch.float32),
           np.asarray(jc["enc_out"].astype(jnp.float32)), rtol=2 ** -7,
           atol=1e-6)


def test_cross_attention_matches_reference(twin):
    """``cross_attention`` of 5 decoder rows over 64 encoder rows with the
    first decoder layer's ``xattn`` weights."""
    jm, params, tm = twin
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 5, tm.cfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 64, tm.cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: np.asarray(a)[0], params["blocks"]["xattn"])
    want = jattn.cross_attention(jp, jm.cfg, jnp.asarray(x), jnp.asarray(enc))
    got = tattn.cross_attention(tm.blocks[0].xattn, tm.cfg,
                                torch.from_numpy(x), torch.from_numpy(enc))
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_insert_slot_copies_self_and_enc_out(twin):
    """A batch-1 prefill's cache lands in slot 1 of a 3-slot cache: the
    ``self`` group's leaves along axis 1, ``pos`` and ``enc_out`` along
    axis 0; the other slots stay zero."""
    _, _, tm = twin
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        3, tm.cfg.vocab_size, (1, 7)))
    one = tm.apply(tok, mode="prefill", cache=tm.init_cache(1, 32),
                   encoder_frames=torch.from_numpy(_frames(tm.cfg, 1, 9)))[1]
    cache = tm.init_cache(3, 32)
    tm.insert_slot(cache, one, 1)
    assert cache["pos"].tolist() == [0, 7, 0]
    for n, buf in cache["self"].items():
        assert torch.equal(buf[:, 1:2], one["self"][n]), n
        assert not buf[:, 0].any() and not buf[:, 2].any(), n
    assert torch.equal(cache["enc_out"][1:2], one["enc_out"])
    assert not cache["enc_out"][0].any() and not cache["enc_out"][2].any()
    assert bool(one["enc_out"].any())
