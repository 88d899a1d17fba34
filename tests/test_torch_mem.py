"""The PyTorch port's MEM embedder held against the JAX reference on the
CPU, at ``smoke_config()`` width with the reference's own weights
(``MEM.init`` as numpy, carried across by ``mem_params_from_numpy``).

In float32 (the towers' ``dtype`` replaced, no new knob) every piece is
allclose at rtol 1e-4 / atol 1e-5: XLA and PyTorch sum matrix products
and reductions in different orders. In bfloat16 the two frameworks round
at different places, so embeddings are compared by cosine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.venus_mem import smoke_config as jsmoke_config
from repro.core.pipeline import MEMEmbedder as JEmbedder
from repro.data.text import tokenize_batch as jtokenize_batch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.mem import MEM as JMEM
from repro_torch.configs.venus_mem import smoke_config
from repro_torch.core.convert import (mem_params_from_numpy,
                                      mem_params_to_numpy)
from repro_torch.core.pipeline import MICRO_BATCH, MEMEmbedder
from repro_torch.data.text import tokenize_batch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.mem import MEM
from repro_torch.models.transformer import AttnBlock

TEXTS = ["a red car turns left at the crossing", "person", "",
         "two dogs run across the wet grass near the old stone bridge"]
# cosine floor of bf16 outputs against the reference's bf16 ones (the
# measured worst case at smoke width is 0.99998)
BF16_COS = 0.9999


def _with_dtype(cfg, dtype):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype=dtype),
        vision=dataclasses.replace(cfg.vision, dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def twin_mem(request):
    """The reference MEM and its weights, and the port's MEM holding the
    same weights, both in one activation dtype."""
    jcfg = _with_dtype(jsmoke_config(), request.param)
    jmem = JMEM(jcfg)
    params = jmem.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tmem = MEM.init(_with_dtype(smoke_config(), request.param), device="cpu")
    tmem.load_state_dict(mem_params_from_numpy(tree))
    return request.param, jmem, params, tmem


def _frames(n=3, hw=24, seed=0):
    return np.random.default_rng(seed).random((n, hw, hw, 3)).astype(
        np.float32)


def _check(dtype, got, want):
    got = np.asarray(torch.as_tensor(got).to(torch.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= BF16_COS, cos


def _j2t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# the pieces (float32; the block in both dtypes)
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(_j2t(x), _j2t(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-4, atol=1e-5)
    b = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.layer_norm(_j2t(x), _j2t(w), _j2t(b)).numpy(),
        np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b))),
        rtol=1e-4, atol=1e-5)
    pos = np.stack([np.arange(7), np.arange(7) + 20]).astype(np.int32)
    for fraction in (1.0, 0.5):
        np.testing.assert_allclose(
            tlayers.apply_rope(_j2t(x), torch.from_numpy(pos), theta=1e4,
                               fraction=fraction).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta=1e4, fraction=fraction)),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("relu2", False)])
def test_mlp_apply_matches_reference(act, gated):
    rng = np.random.default_rng(2)
    p = {"w_up": rng.standard_normal((16, 24)), "w_down":
         rng.standard_normal((24, 16)) * 0.2}
    if gated:
        p["w_gate"] = rng.standard_normal((16, 24))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.mlp_apply({k: _j2t(v) for k, v in p.items()}, _j2t(x),
                          act).numpy(),
        np.asarray(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x), act)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("softcap,q_per_kv", [(0.0, 1), (5.0, 2)])
def test_sdpa_matches_reference(softcap, q_per_kv):
    rng = np.random.default_rng(3)
    b, s, hkv, d = 2, 9, 2, 8
    q = rng.standard_normal((b, s, hkv * q_per_kv, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    mask = np.tril(np.ones((s, s), bool))
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), 0.35, softcap, q_per_kv)
    got = tattn._sdpa(_j2t(q), _j2t(k), _j2t(v), torch.from_numpy(mask),
                      0.35, softcap, q_per_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 12])
def test_sdpa_causal_chunked_matches_reference(window, monkeypatch):
    """Chunks of 8 queries over 32 (the reference reads its chunk size at
    call time too), with and without a sliding window, right-padded."""
    monkeypatch.setattr(jattn, "SDPA_Q_CHUNK", 8)
    monkeypatch.setattr(tattn, "SDPA_Q_CHUNK", 8)
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
               for _ in range(3))
    lengths = np.asarray([32, 21], np.int32)
    want = jattn._sdpa_causal_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, 0.0, 1,
        window, jnp.asarray(lengths))
    got = tattn._sdpa_causal_chunked(_j2t(q), _j2t(k), _j2t(v), 0.3, 0.0,
                                     1, window, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_attn_block_matches_reference(twin_mem):
    dtype, jmem, params, tmem = twin_mem
    cfg = jmem.cfg.text
    p0 = jax.tree.map(lambda a: a[0], params["text"]["dense_blocks"])
    x = np.random.default_rng(5).standard_normal((2, 11, cfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    want, _, _ = jtransformer._attn_block(
        p0, cfg, jnp.asarray(x, getattr(jnp, dtype)),
        positions=jnp.asarray(pos))
    block = tmem.text.blocks[0]
    assert isinstance(block, AttnBlock)
    got = block(_j2t(x).to(getattr(torch, dtype)), torch.from_numpy(pos))
    _check(dtype, got, want)


# ---------------------------------------------------------------------------
# the towers and the embedder, in float32 and in bfloat16
# ---------------------------------------------------------------------------


def test_encode_text_and_image_match_reference(twin_mem):
    dtype, jmem, params, tmem = twin_mem
    toks, mask = jtokenize_batch(TEXTS, jmem.cfg.text.vocab_size, 16)
    ttoks, tmask = tokenize_batch(TEXTS, tmem.cfg.text.vocab_size, 16)
    np.testing.assert_array_equal(ttoks, toks)
    assert mask[2].sum() == 2 and not mask.all()      # padding is pooled out
    want = jmem.encode_text(params, jnp.asarray(toks), jnp.asarray(mask))
    got = tmem.encode_text(torch.from_numpy(ttoks), torch.from_numpy(tmask))
    assert got.dtype == getattr(torch, dtype)
    _check(dtype, got, want)
    patches = np.random.default_rng(6).standard_normal(
        (3, 20, jmem.cfg.vision.d_model)).astype(np.float32)
    _check(dtype, tmem.encode_image(_j2t(patches)),
           jmem.encode_image(params, jnp.asarray(patches)))


def test_mem_embedder_matches_reference(twin_mem):
    dtype, jmem, params, tmem = twin_mem
    jemb = JEmbedder(jmem, params, text_max_len=16)
    temb = MEMEmbedder(tmem, text_max_len=16)
    frames = _frames(n=MICRO_BATCH + 3, hw=16)     # two micro-batches
    aux = ["kitchen scene", "", "street at night"] * 12
    aux = aux[:len(frames)]
    _check(dtype, temb.embed_frames(frames), jemb.embed_frames(frames))
    _check(dtype, temb.embed_frames(torch.from_numpy(frames), aux),
           jemb.embed_frames(frames, aux))
    _check(dtype, temb.embed_queries(TEXTS), jemb.embed_queries(TEXTS))
    got = temb.embed_query(TEXTS[0])
    assert got.dtype == np.float32 and got.shape == (tmem.cfg.embed_dim,)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_mem_params_round_trip(twin_mem):
    """Reference tree → port state → back to the layer-stacked tree by
    ``mem_params_to_numpy``: every array equal, ``logit_scale`` and
    ``logit_bias`` among them (the unused LM heads are the only leaves
    dropped)."""
    _, _, params, tmem = twin_mem
    want = jax.tree.map(np.asarray, params)
    for t in ("text", "vision"):
        want[t] = {k: v for k, v in want[t].items() if k != "lm_head"}
    got = mem_params_to_numpy(tmem)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert {"logit_scale", "logit_bias"} <= {
        k for k, _ in tmem.named_parameters()}


def test_port_init_scales():
    """The port's own init (no JAX on the card's machine): the reference's
    shapes and scales (normal·1/sqrt(fan_in), embeddings normal·0.02,
    norms 1), reproducible from the seed."""
    cfg = smoke_config()
    a = MEM.init(cfg, seed=3, device="cpu")
    b = MEM.init(cfg, seed=3, device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    wq = a.text.blocks[0].attn["wq"]
    assert wq.shape == (64, 64) and abs(float(wq.std()) - 64 ** -0.5) < 0.02
    assert abs(float(a.text.embed.std()) - 0.02) < 0.002
    assert torch.equal(a.vision.final_norm["w"], torch.ones(64))
    assert a.vision.embed.shape == (0, 64)
