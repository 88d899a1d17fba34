"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) held
against the reference's (``repro.models.moe``) on the CPU in float32, on
the same numpy weights and inputs from a seed:

* ``moe_apply``: y at rtol/atol 1e-5, aux at 1e-6, and the routing of
  every (token, slot) pair — its expert, its weight, kept or dropped —
  equal to the reference's dispatch, read from the reference's own
  einsums (run eagerly under ``jax.disable_jit``). Capacity factors 1.0
  and 1.25 (tokens are dropped), 4.0 = E/k (none are), several chunks
  (S = 24: three of 8), decode (S = 1), B = 2 and 4, shared experts on
  and off;
* top-k ties go to the lowest expert index, as ``jax.lax.top_k``;
* whole models with ``first_dense_layers`` 0 and 1 at capacity factor
  1.0: logits and the summed aux loss.

Router inputs keep a margin from top-k ties (``MARGIN``) where the test
is not about ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro.models.transformer import Transformer as JTransformer
from repro_torch.configs.base import MoEConfig, ModelConfig
from repro_torch.core.convert import model_params_from_numpy
from repro_torch.models import moe
from repro_torch.models.transformer import init_model

Y = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-6, atol=1e-6)
MARGIN = 1e-5      # least gap between the k-th and (k+1)-th router prob


def _cfgs(*, e=8, k=2, cf=1.25, shared=True, dense=0, layers=1, d=32):
    mc = dict(num_experts=e, experts_per_token=k, d_ff=48,
              num_shared_experts=int(shared), shared_d_ff=40 if shared
              else 0, first_dense_layers=dense, dense_d_ff=56,
              capacity_factor=cf, router_aux_coef=0.01)
    kw = dict(name="moe-test", family="moe", num_layers=layers, d_model=d,
              num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
              vocab_size=96, dtype="float32")
    return (JModelConfig(**kw, moe=JMoEConfig(**mc)),
            ModelConfig(**kw, moe=MoEConfig(**mc)))


def _port_tree(tree):
    return {k: (_port_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v))) for k, v in tree.items()}


class _Spy:
    """Stands in for ``jnp`` inside the reference's moe module and keeps
    the operands of its combine einsum: per chunk, the (B, n, k) weights,
    the (B, n, k, E) one-hot experts and the (B, n, k, E, C) kept slots."""

    def __init__(self):
        self.chunks = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops):
        if spec == "bnk,bnke,bnkec->bnec":
            self.chunks.append([np.asarray(o) for o in ops])
        return jnp.einsum(spec, *ops)


def _reference(monkeypatch, jcfg, params, x):
    """(y, aux, top_i, top_w, keep, slot) of the reference's moe_apply,
    the routing read from its einsums, chunks joined along S."""
    spy = _Spy()
    monkeypatch.setattr(jmoe, "jnp", spy)
    with jax.disable_jit():
        y, aux = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    monkeypatch.undo()
    w = np.concatenate([c[0] for c in spy.chunks], 1)
    onehot = np.concatenate([c[1] for c in spy.chunks], 1)
    slots = np.concatenate([c[2] for c in spy.chunks], 1)
    keep = slots.sum((-1, -2)) > 0
    slot = np.where(keep, slots.sum(-2).argmax(-1), -1)
    return (np.asarray(y), float(aux), onehot.argmax(-1), w, keep, slot)


def _port_slots(r: moe.Routing, cfg, n: int) -> np.ndarray:
    """Each kept pair's 0-based slot in its expert's buffer, -1 where
    dropped: the count of earlier pairs of its batch row and chunk with
    the same expert (token-major, then slot)."""
    b, s, k = r.top_i.shape
    ids = r.top_i.numpy().reshape(b, s // n, n * k)
    pos = np.zeros_like(ids)
    for idx in np.ndindex(*ids.shape[:2]):
        seen = {}
        for j, e in enumerate(ids[idx]):
            pos[idx + (j,)] = seen.get(e, 0)
            seen[e] = pos[idx + (j,)] + 1
    pos = pos.reshape(b, s, k)
    return np.where(r.keep.numpy(), pos, -1)


def _margin(probs: np.ndarray, k: int) -> float:
    top = -np.sort(-probs, axis=-1)
    return float((top[..., k - 1] - top[..., k]).min())


@pytest.mark.parametrize("cf,b,s,shared", [
    (1.0, 2, 24, True),
    (1.25, 2, 24, False),
    (1.25, 4, 1, True),
    (4.0, 2, 48, True),
    (1.0, 1, 16, False),
])
def test_moe_apply_matches_reference(monkeypatch, cf, b, s, shared):
    jcfg, tcfg = _cfgs(cf=cf, shared=shared)
    params = jmoe.moe_init(jax.random.key(3), jcfg)
    rng = np.random.default_rng(int(cf * 100) + 7 * s + b)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    y_ref, aux_ref, ti_ref, tw_ref, keep_ref, slot_ref = _reference(
        monkeypatch, jcfg, params, x)
    p = _port_tree(jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ p["router"], -1).numpy()
    assert _margin(probs, 2) > MARGIN

    n = moe.chunk_size(s)
    assert n == jmoe._chunk_size(s)
    r = moe.route(p, tcfg, xt, n)
    np.testing.assert_array_equal(r.top_i.numpy(), ti_ref)
    np.testing.assert_allclose(r.top_w.numpy(), tw_ref, **Y)
    np.testing.assert_array_equal(r.keep.numpy(), keep_ref)
    np.testing.assert_array_equal(_port_slots(r, tcfg, n), slot_ref)
    dropped = int((~keep_ref).sum())
    if cf < 4.0 and s > 1:
        assert dropped > 0, "the case must drop tokens"
    else:
        assert dropped == 0

    y, aux = moe.moe_apply(p, tcfg, xt)
    np.testing.assert_allclose(y.numpy(), y_ref, **Y)
    np.testing.assert_allclose(float(aux), aux_ref, **AUX)


def test_top_k_ties_go_to_the_lowest_expert(monkeypatch):
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1 for every token (``jax.lax.top_k``'s
    order), so only the first ``capacity`` tokens of each chunk keep
    their pairs; the port follows the reference pair for pair."""
    jcfg, tcfg = _cfgs(cf=1.0, shared=False)
    params = jmoe.moe_init(jax.random.key(0), jcfg)
    params["router"] = jnp.zeros_like(params["router"])
    x = np.random.default_rng(0).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    y_ref, aux_ref, ti_ref, _, keep_ref, _ = _reference(
        monkeypatch, jcfg, params, x)
    p = _port_tree(jax.tree.map(np.asarray, params))
    r = moe.route(p, tcfg, torch.from_numpy(x), 16)
    assert (r.top_i.numpy() == np.arange(2)).all()
    np.testing.assert_array_equal(r.top_i.numpy(), ti_ref)
    np.testing.assert_array_equal(r.keep.numpy(), keep_ref)
    cap = moe.capacity(16, tcfg)
    assert r.keep.numpy()[:, :cap].all() and not r.keep.numpy()[:, cap:].any()
    y, aux = moe.moe_apply(p, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, **Y)
    np.testing.assert_allclose(float(aux), aux_ref, **AUX)


def test_chunk_size_matches_reference():
    for s in (1, 2, 3, 12, 24, 48, 100, 2048, 3000, 4096, 6144, 32768):
        assert moe.chunk_size(s) == jmoe._chunk_size(s), s


@pytest.mark.parametrize("dense", [0, 1])
def test_model_with_dense_and_moe_groups_matches_reference(dense):
    """A 2-layer MoE model (GQA) with ``first_dense_layers`` 0 or 1 at
    capacity factor 1.0: train logits and the summed aux loss equal the
    reference's; the cache has the reference's groups."""
    jcfg, tcfg = _cfgs(cf=1.0, dense=dense, layers=2)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(1))
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    tok = np.random.default_rng(dense).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _, jaux = jax.jit(jm.apply, static_argnames=("mode",))(
        params, jnp.asarray(tok), mode="train")
    tl, _, taux = tm.apply(torch.from_numpy(tok), mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX)
    assert float(taux) > 0
    jc = jm.init_cache(2, 32, dtype=jnp.float32)
    tc = tm.init_cache(2, 32, dtype=torch.float32)
    assert sorted(k for k in tc if k in ("dense", "moe")) == sorted(
        k for k in jc if k in ("dense", "moe"))
    for g in ("dense", "moe"):
        if g in jc:
            for n, v in jc[g].items():
                assert tuple(tc[g][n].shape) == v.shape, (g, n)
