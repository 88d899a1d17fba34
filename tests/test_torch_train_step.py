"""The port's train path of every arch of the zoo, held against the JAX
reference on the CPU at smoke size in float32: the LM loss and every
gradient leaf against ``jax.value_and_grad`` of the reference's loss
(``repro.training.trainer``'s ``loss_fn``: ``apply`` in train mode,
``lm_cross_entropy`` + the MoE aux loss), with the reference's weights
carried across by ``model_params_from_numpy`` and its gradients mapped
the same way; the port's ``remat=True`` gradients against the same; one
``make_train_step`` (the port's ``tests/test_models.py::
test_smoke_train_step``); an MoE model that drops pairs at capacity,
its router's gradient finite and the reference's; and MEM's SigLIP loss
and gradients, ``logit_scale`` and ``logit_bias`` among them. The
reference runs under ``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.venus_mem import smoke_config as jmem_smoke
from repro.models.mem import MEM as JMEM
from repro.models.transformer import Transformer as JTransformer
from repro.training.losses import lm_cross_entropy as jlm_ce
from repro.training.losses import siglip_loss as jsiglip
from repro_torch.configs import registry as tregistry
from repro_torch.configs.venus_mem import smoke_config as tmem_smoke
from repro_torch.core.convert import (mem_params_from_numpy,
                                      model_params_from_numpy)
from repro_torch.models import moe as moe_mod
from repro_torch.models.mem import MEM
from repro_torch.models.transformer import init_model
from repro_torch.training import TrainHParams, adamw_init, make_train_step
from repro_torch.training.trainer import lm_loss, mem_loss

ARCHS = list(tregistry.ARCH_IDS)
B, S = 2, 32
LOSS = dict(rtol=1e-6, atol=1e-6)
GRAD_REL_L2 = 1e-5          # ‖port − reference‖ / ‖reference‖ a leaf


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "mask": rng.random((B, S)) > 0.2}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            0, 0.02, (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["encoder_frames"] = rng.normal(
            0, 0.02, (B, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)
    return batch


def _ref_value_and_grad(jcfg, params, batch):
    jm = JTransformer(jcfg)

    def loss_fn(p, b):
        kw = {k: b[k] for k in ("vision_embeds", "encoder_frames") if k in b}
        logits, _, aux = jm.apply(p, b["tokens"], mode="train", **kw)
        if "vision_embeds" in b:
            logits = logits[:, b["vision_embeds"].shape[1]:]
        loss, metrics = jlm_ce(logits, b["labels"], b["mask"])
        return loss + aux, {**metrics, "moe_aux": aux}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    return float(loss), jax.tree.map(float, metrics), \
        jax.tree.map(np.asarray, grads)


def _port_value_and_grad(model, loss, params):
    """(loss, {name: gradient}) of ``loss`` over the model's parameters."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {k: (torch.zeros_like(p) if g is None else g).numpy()
            for (k, p), g in zip(params.items(), grads)}


def _rel_l2(got, want):
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got.astype(np.float64) - want))
    return num / den if den else num


def _check_grads(got, want, bound=GRAD_REL_L2):
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k], want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bound, (worst, errs[worst])
    assert all(np.isfinite(g).all() for g in got.values())


def _twin(arch, edit=lambda cfg: cfg):
    jcfg = edit(jregistry.get_smoke_config(arch).replace(dtype="float32"))
    tcfg = edit(tregistry.get_smoke_config(arch).replace(dtype="float32"))
    params = JTransformer(jcfg).init(jax.random.key(0))
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    return jcfg, tcfg, params, tm


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(port model with the reference's weights, its batch, the
    reference's loss, metrics and gradients as port-named tensors)."""
    jcfg, tcfg, params, tm = _twin(request.param)
    batch = _batch(tcfg)
    loss, metrics, grads = _ref_value_and_grad(jcfg, params, batch)
    return tm, batch, loss, metrics, model_params_from_numpy(tcfg, grads)


def _port(tm, batch, remat):
    tm.requires_grad_(True)
    params = dict(tm.named_parameters())
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = lm_loss(tm.cfg, tm, tb, remat=remat)
    grads = _port_value_and_grad(tm, loss, params)
    return float(loss.detach()), metrics, grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(case, remat):
    """The loss, nll, accuracy and aux at 1e-6; every gradient leaf
    within a relative L2 error of 1e-5 of the reference's, with and
    without remat."""
    tm, batch, loss, metrics, want = case
    got_loss, got_metrics, got = _port(tm, batch, remat)
    np.testing.assert_allclose(got_loss, loss, **LOSS)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_metrics[k].detach()), v,
                                   **LOSS)
    _check_grads(got, want)


def test_remat_grads_equal_plain(case):
    """Checkpointing recomputes the same operations: the gradients with
    ``remat=True`` equal those without, bit for bit, on the CPU."""
    tm = case[0]
    _, _, plain = _port(tm, case[1], False)
    _, _, remat = _port(tm, case[1], True)
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """One step of ``make_train_step`` (remat on, the default): a finite
    loss and changed parameters, every metric present."""
    cfg = tregistry.get_smoke_config(arch)
    tm = init_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = adamw_init(dict(tm.named_parameters()))
    step = make_train_step(cfg, TrainHParams(warmup=1, total_steps=10))
    batch = _batch(cfg)
    del batch["mask"]
    tm, opt, metrics = step(tm, opt, batch, 1)
    assert set(metrics) == {"loss", "nll", "accuracy", "moe_aux", "lr",
                            "grad_norm"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(opt.count) == 1
    diff = max(float((tm.state_dict()[k] - v).abs().max())
               for k, v in before.items())
    assert diff > 0


def test_moe_dropped_pairs_router_grad():
    """OLMoE at capacity factor 1.0 drops pairs (counted by the port's
    routing): the loss and every gradient — the router's included — are
    finite and the reference's, the dropped pairs' rows (which the
    grouped products leave unwritten) kept out of the backward pass."""
    jcfg, tcfg, params, tm = _twin("olmoe-1b-7b", lambda cfg: cfg.replace(
        moe=dataclasses.replace(cfg.moe, capacity_factor=1.0)))
    batch = _batch(tcfg, seed=3)
    loss, _, grads = _ref_value_and_grad(jcfg, params, batch)
    kept = []
    route = moe_mod.route

    def spy(*a, **kw):
        r = route(*a, **kw)
        kept.append(r.keep)
        return r
    moe_mod.route = spy
    try:
        got_loss, _, got = _port(tm, batch, remat=False)
    finally:
        moe_mod.route = route
    dropped = sum(int((~k).sum()) for k in kept)
    assert dropped > 0
    np.testing.assert_allclose(got_loss, loss, **LOSS)
    want = model_params_from_numpy(tcfg, grads)
    routers = [k for k in got if k.endswith("moe.router")]
    assert routers and all(np.abs(got[k]).max() > 0 for k in routers)
    _check_grads(got, want)


@pytest.fixture(scope="module")
def mem_case():
    """(port MEM with the reference's weights, a batch, the reference's
    SigLIP loss, accuracy and gradients as port-named tensors)."""
    def f32(cfg):
        return dataclasses.replace(
            cfg, text=cfg.text.replace(dtype="float32"),
            vision=cfg.vision.replace(dtype="float32"))
    jcfg, tcfg = f32(jmem_smoke()), f32(tmem_smoke())
    jm = JMEM(jcfg)
    params = jm.init(jax.random.key(0))
    tmem = MEM.init(tcfg, device="cpu")
    tmem.load_state_dict(mem_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(3, tcfg.text.vocab_size,
                                    (4, 12)).astype(np.int32),
             "mask": rng.random((4, 12)) > 0.3,
             "patches": rng.normal(0, 1, (4, 6, tcfg.vision.d_model)
                                   ).astype(np.float32)}

    def loss_fn(p, b):
        txt = jm.encode_text(p, b["tokens"], b["mask"])
        img = jm.encode_image(p, b["patches"])
        return jsiglip(img, txt, p["logit_scale"], p["logit_bias"])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    want = mem_params_from_numpy(jax.tree.map(np.asarray, grads))
    return tmem, batch, float(loss), float(metrics["contrastive_acc"]), want


@pytest.mark.parametrize("remat", [False, True])
def test_mem_siglip_grads_match_reference(mem_case, remat):
    """MEM's SigLIP loss and accuracy at 1e-6 and every gradient leaf
    (``logit_scale`` and ``logit_bias`` included; the towers' unused LM
    heads are not in the port) within 1e-5 relative L2."""
    tmem, batch, loss, acc, want = mem_case
    tmem.requires_grad_(True)
    params = dict(tmem.named_parameters())
    got_loss, metrics = mem_loss(
        tmem, {k: torch.as_tensor(v) for k, v in batch.items()},
        remat=remat)
    got = _port_value_and_grad(tmem, got_loss, params)
    np.testing.assert_allclose(float(got_loss.detach()), loss, **LOSS)
    assert float(metrics["contrastive_acc"]) == acc
    assert {"logit_scale", "logit_bias"} <= set(got)
    assert got["logit_scale"] != 0 and got["logit_bias"] != 0
    _check_grads(got, want)
