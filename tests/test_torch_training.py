"""The port's training substrate held against the JAX reference on the
CPU: ``lm_batches`` bit for bit; the cosine schedule, both losses and
AdamW (fed the same numpy gradients) at 1e-6; the reference's
``tests/test_training.py`` cases (a quadratic, the LM loss falling end to
end, MEM contrastive training) with the port's curve held to the
reference's; checkpoints crossing between the packages bit for bit; a
resumed run equal to an unbroken one; serving building no autograd
graph; and the launcher. The reference runs under ``jax.jit``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.venus_mem import smoke_config as jmem_smoke
from repro.data import text as jtext
from repro.models.mem import MEM as JMEM
from repro.models.transformer import Transformer as JTransformer
from repro.training import TrainHParams as JHParams
from repro.training import adamw_init as jadamw_init
from repro.training import adamw_update as jadamw_update
from repro.training import checkpoint as jckpt
from repro.training import cosine_schedule as jcosine
from repro.training import make_mem_train_step as jmake_mem_step
from repro.training import make_train_step as jmake_step
from repro.training.losses import lm_cross_entropy as jlm_ce
from repro.training.losses import siglip_loss as jsiglip
from repro_torch.configs import registry as tregistry
from repro_torch.configs.venus_mem import smoke_config as tmem_smoke
from repro_torch.core.convert import (mem_params_from_numpy,
                                      model_params_from_numpy,
                                      model_params_to_numpy)
from repro_torch.core.pipeline import MEMEmbedder
from repro_torch.data import text as ttext
from repro_torch.launch import train as launch_train
from repro_torch.models.mem import MEM
from repro_torch.models.transformer import init_model
from repro_torch.serving import Request, ServingEngine, make_serve_step
from repro_torch.training import (TrainHParams, adamw_init, adamw_update,
                                  cosine_schedule, make_mem_train_step,
                                  make_train_step)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.losses import lm_cross_entropy, siglip_loss

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(cfg):
    return cfg.replace(dtype="float32")


def _mem_f32(cfg):
    return dataclasses.replace(cfg, text=_f32(cfg.text),
                               vision=_f32(cfg.vision))


# ---------------------------------------------------------------------------
# data, schedule, losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 64, 0),
                                                  (102400, 3, 17, 7)])
def test_lm_batches_match_reference(vocab, batch, seq, seed):
    """The same token stream for the same seed, bit for bit (vocabularies
    under and over the 4,096-entry transition table)."""
    a = ttext.lm_batches(vocab, batch, seq, seed)
    b = jtext.lm_batches(vocab, batch, seq, seed)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.keys() == y.keys() == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_cosine_schedule_matches_reference():
    """Every step 0..130 of two schedules at 1e-6, and the reference's
    ``test_cosine_schedule_shape``: 0 at step 0, the base rate at the end
    of warm-up, the floor at the end."""
    for warmup, total in ((10, 100), (0, 120)):
        steps = np.arange(131)
        got = cosine_schedule(torch.from_numpy(steps), base_lr=3e-4,
                              warmup=warmup, total=total)
        want = jcosine(jnp.asarray(steps), base_lr=3e-4, warmup=warmup,
                       total=total)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    assert float(cosine_schedule(0, base_lr=1.0, warmup=10,
                                 total=100)) == 0.0
    assert abs(float(cosine_schedule(10, base_lr=1.0, warmup=10,
                                     total=100)) - 1.0) < 1e-5
    assert float(cosine_schedule(100, base_lr=1.0, warmup=10,
                                 total=100)) <= 0.11


@pytest.mark.parametrize("masked", [False, True])
def test_lm_cross_entropy_matches_reference(masked):
    """Loss (NLL + z-loss), NLL and accuracy at 1e-6 over (3, 17, 300)
    logits, with and without a mask; an all-masked batch gives 0."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 17, 300)).astype(np.float32)
    labels = rng.integers(0, 300, (3, 17)).astype(np.int32)
    labels[0, :5] = logits[0, :5].argmax(-1)          # some hits
    mask = (rng.random((3, 17)) > 0.3) if masked else None
    got, gm = lm_cross_entropy(_t(logits), _t(labels),
                               None if mask is None else _t(mask))
    want, wm = jlm_ce(jnp.asarray(logits), jnp.asarray(labels),
                      None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), **TIGHT)
    for k in ("nll", "accuracy"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **TIGHT)
    assert float(gm["accuracy"]) > 0
    zero, _ = lm_cross_entropy(_t(logits), _t(labels),
                               torch.zeros((3, 17), dtype=torch.bool))
    assert float(zero) == 0.0


def test_lm_cross_entropy_gold_and_first_index_ties():
    """The reference's ``test_lm_cross_entropy_gold``; tied maxima count
    the first index as the prediction, as ``jnp.argmax``."""
    logits = torch.tensor([[[10.0, 0.0, 0.0], [0.0, 10.0, 0.0]]])
    loss, m = lm_cross_entropy(logits, torch.tensor([[0, 1]]), z_loss=0.0)
    assert float(loss) < 1e-3 and float(m["accuracy"]) == 1.0
    tied = np.asarray([[[5.0, 5.0, 1.0], [2.0, 7.0, 7.0]]], np.float32)
    for labels in ([[0, 1]], [[1, 2]]):
        got = lm_cross_entropy(_t(tied), torch.tensor(labels))[1]
        want = jlm_ce(jnp.asarray(tied), jnp.asarray(labels))[1]
        assert float(got["accuracy"]) == float(want["accuracy"])
    assert float(lm_cross_entropy(_t(tied), torch.tensor([[0, 1]]))[1][
        "accuracy"]) == 1.0


def test_siglip_loss_matches_reference():
    """Loss at 1e-6 and accuracy over 6 pairs of unit rows; and the
    reference's ``test_siglip_loss_prefers_diagonal``."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(6, 16)).astype(np.float32)
    txt = (img + rng.normal(0, 0.8, (6, 16))).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    got, gm = siglip_loss(_t(img), _t(txt), torch.tensor(2.0),
                          torch.tensor(-1.5))
    want, wm = jsiglip(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(2.0),
                       jnp.asarray(-1.5))
    np.testing.assert_allclose(float(got), float(want), **TIGHT)
    assert float(gm["contrastive_acc"]) == float(wm["contrastive_acc"])
    eye = torch.eye(4, 8)
    perm = [1, 0, 3, 2]
    lm, _ = siglip_loss(eye, eye, torch.tensor(2.0), torch.tensor(-1.0))
    lx, _ = siglip_loss(eye, eye[perm], torch.tensor(2.0),
                        torch.tensor(-1.0))
    assert float(lm) < float(lx)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree_params(rng, dtype=np.float32):
    return {"a": {"w": rng.normal(size=(7, 5)).astype(dtype)},
            "b": rng.normal(size=(11,)).astype(dtype)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("grad_scale,clip", [(0.01, 1.0), (10.0, 1.0),
                                             (10.0, 0.0)])
def test_adamw_update_matches_reference(grad_scale, clip):
    """5 updates fed the same numpy gradients as the reference's (clip
    inactive, active, off; a cosine rate): params and both moments at
    rtol 1e-6, the count equal."""
    rng = np.random.default_rng(2)
    jp = _tree_params(rng)
    tp = {k: _t(v) for k, v in _flat(jp).items()}
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * grad_scale
                                    ).astype(np.float32), jp)
        lr = jcosine(jnp.asarray(i), base_lr=1e-2, warmup=2, total=5)
        jp, jopt = jadamw_update(g, jopt, jp, lr=lr, grad_clip=clip)
        tp, topt = adamw_update({k: _t(v) for k, v in _flat(g).items()},
                                topt, tp, lr=cosine_schedule(
                                    i, base_lr=1e-2, warmup=2, total=5),
                                grad_clip=clip)
    assert int(topt.count) == int(jopt.count) == 5
    for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        want = _flat(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_adamw_bf16_params_match_reference():
    """bf16 parameters (bf16 gradients) take the update computed in f32
    and keep their dtype beside f32 moments, written into the given
    tensors: 3 steps equal the reference's within one bf16 rounding, the
    moments at rtol 1e-6."""
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                      _tree_params(rng))
    tp = {k: _t(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in _flat(jp).items()}
    live = dict(tp)
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape), jnp.bfloat16), jp)
        jp, jopt = jadamw_update(g, jopt, jp, lr=0.01)
        tp, topt = adamw_update(
            {k: _t(np.asarray(v, np.float32)).to(torch.bfloat16)
             for k, v in _flat(g).items()}, topt, tp, lr=0.01)
    want = _flat(jp)
    for k, p in tp.items():
        assert p is live[k] and p.dtype == torch.bfloat16
        assert topt.mu[k].dtype == torch.float32
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=2 ** -8, atol=0)
        np.testing.assert_allclose(topt.mu[k].numpy(),
                                   np.asarray(_flat(jopt.mu)[k]), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(topt.nu[k].numpy(),
                                   np.asarray(_flat(jopt.nu)[k]), rtol=1e-6,
                                   atol=1e-9)


def test_adamw_converges_quadratic():
    """The reference's case: 300 steps on Σ (w − target)² reach the
    target within 0.05, the port's trajectory (gradients by autograd)
    within 1e-5 of the reference's."""
    target = np.asarray([1.0, 2.0], np.float32)
    jp = {"w": jnp.asarray([5.0, -3.0])}
    jopt = jadamw_init(jp)
    w = torch.tensor([5.0, -3.0], requires_grad=True)
    topt = adamw_init({"w": w})
    for _ in range(300):
        g = jax.grad(lambda p: jnp.sum((p["w"] - target) ** 2))(jp)
        jp, jopt = jadamw_update(g, jopt, jp, lr=0.05, weight_decay=0.0)
        (gw,) = torch.autograd.grad(((w - _t(target)) ** 2).sum(), [w])
        _, topt = adamw_update({"w": gw}, topt, {"w": w}, lr=0.05,
                               weight_decay=0.0)
    np.testing.assert_allclose(w.detach().numpy(), target, atol=0.05)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _lm_twin(arch, dtype="float32"):
    jcfg = jregistry.get_smoke_config(arch).replace(dtype=dtype)
    tcfg = tregistry.get_smoke_config(arch).replace(dtype=dtype)
    params = JTransformer(jcfg).init(jax.random.key(0))
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    return jcfg, tcfg, params, tm


def test_lm_loss_decreases_end_to_end():
    """The reference's case on deepseek-7b smoke (f32; lr 1e-3, warm-up
    2, 12 steps of 4 × 64 from ``lm_batches``), from the reference's
    weights: the loss falls, and each step's loss is within 2e-4
    relative of the reference's (AdamW's first steps move each weight by
    ≈ lr · sign(g), so a gradient within rounding of 0 can move a weight
    by a whole lr in one package and not the other)."""
    jcfg, tcfg, params, tm = _lm_twin("deepseek-7b")
    hp = dict(base_lr=1e-3, warmup=2, total_steps=50, remat=False)
    jstep = jax.jit(jmake_step(jcfg, JHParams(**hp)))
    tstep = make_train_step(tcfg, TrainHParams(**hp))
    jopt = jadamw_init(params)
    topt = adamw_init(dict(tm.named_parameters()))
    it = ttext.lm_batches(tcfg.vocab_size, 4, 64, seed=0)
    got, want = [], []
    for i in range(12):
        b = next(it)
        params, jopt, jm = jstep(params, jopt,
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 jnp.asarray(i))
        tm, topt, tmx = tstep(tm, topt, b, i)
        want.append(float(jm["loss"]))
        got.append(float(tmx["loss"]))
    assert np.isfinite(got).all()
    assert np.mean(got[-3:]) < np.mean(got[:3])
    np.testing.assert_allclose(got, want, rtol=2e-4)


def _mem_batches(cfg, steps, seed=0):
    """The reference test's synthetic pairs: 4 classes, a prototype patch
    row and a caption each, 4 distinct classes a batch."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (4, cfg.vision.d_model)).astype(np.float32)
    texts = [f"class{i} object{i}" for i in range(4)]
    for _ in range(steps):
        cls = rng.integers(0, 4, size=4)
        while len(set(cls.tolist())) < 4:
            cls = rng.integers(0, 4, size=4)
        patches = protos[cls][:, None, :].repeat(4, 1) \
            + rng.normal(0, 0.1, (4, 4, cfg.vision.d_model))
        toks, mask = ttext.tokenize_batch([texts[c] for c in cls],
                                          cfg.text.vocab_size, 16)
        yield {"tokens": toks, "mask": mask,
               "patches": patches.astype(np.float32)}


def test_mem_contrastive_training_improves():
    """The reference's case (MEM smoke, f32, lr 3e-4, 30 steps) from the
    reference's weights, the port with remat: the contrastive accuracy of
    the last 5 steps above the first 5's, each step's loss within 1e-4
    relative of the reference's and its accuracy equal."""
    jcfg, tcfg = _mem_f32(jmem_smoke()), _mem_f32(tmem_smoke())
    jm = JMEM(jcfg)
    params = jm.init(jax.random.key(0))
    tmem = MEM.init(tcfg, device="cpu")
    tmem.load_state_dict(mem_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    hp = dict(base_lr=3e-4, warmup=2, total_steps=60)
    jstep = jax.jit(jmake_mem_step(jm, JHParams(**hp, remat=False)))
    tstep = make_mem_train_step(tmem, TrainHParams(**hp, remat=True))
    jopt = jadamw_init(params)
    topt = adamw_init(dict(tmem.named_parameters()))
    accs, losses, wlosses, waccs = [], [], [], []
    for i, b in enumerate(_mem_batches(tcfg, 30)):
        params, jopt, jmx = jstep(params, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()},
                                  jnp.asarray(i))
        tmem, topt, tmx = tstep(tmem, topt, b, i)
        losses.append(float(tmx["loss"]))
        accs.append(float(tmx["contrastive_acc"]))
        wlosses.append(float(jmx["loss"]))
        waccs.append(float(jmx["contrastive_acc"]))
    assert np.mean(accs[-5:]) > np.mean(accs[:5])
    np.testing.assert_allclose(losses, wlosses, rtol=1e-4)
    assert accs == waccs


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _one_port_step(arch):
    cfg = tregistry.get_smoke_config(arch)
    tm = init_model(cfg, seed=1, device="cpu")
    opt = adamw_init(dict(tm.named_parameters()))
    batch = next(ttext.lm_batches(cfg.vocab_size, 2, 16, seed=1))
    if cfg.family == "vlm":
        batch["vision_embeds"] = np.zeros(
            (2, cfg.vision_tokens, cfg.d_model), np.float32)
    if cfg.family == "audio":
        batch["encoder_frames"] = np.zeros(
            (2, cfg.encoder_seq_len, cfg.d_model), np.float32)
    tm, opt, _ = make_train_step(cfg, TrainHParams(warmup=1))(
        tm, opt, batch, 1)
    return cfg, tm, opt


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b"])
def test_checkpoint_port_to_reference(tmp_path, arch):
    """A port checkpoint (params and AdamW state after a step) restores
    in the reference's ``checkpoint.restore`` into the reference's own
    target, every leaf bit for bit; the manifest lists the reference's
    keys, with the caller's metadata."""
    cfg, tm, opt = _one_port_step(arch)
    path = os.path.join(tmp_path, "ck")
    ckpt.save(path, ckpt.train_state(cfg, tm, opt), {"step": 1})
    jcfg = jregistry.get_smoke_config(arch)
    jp = JTransformer(jcfg).init(jax.random.key(5))
    target = jax.tree.map(np.zeros_like,
                          {"params": jp, "opt": jadamw_init(jp)._asdict()})
    got = jckpt.restore(path, target)
    want = {"params": model_params_to_numpy(cfg, tm),
            "opt": {"count": np.int32(1),
                    "mu": model_params_to_numpy(cfg, opt.mu),
                    "nu": model_params_to_numpy(cfg, opt.nu)}}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(path + ".json") as f:
        meta = json.load(f)
    ref_path = os.path.join(tmp_path, "ref")
    jckpt.save(ref_path, target)
    with open(ref_path + ".json") as f:
        assert meta["keys"] == json.load(f)["keys"]
    assert meta["step"] == 1


def test_checkpoint_reference_to_port(tmp_path):
    """A reference checkpoint (params and AdamW state after one of its
    steps) restores in the port into its model and optimiser state, bit
    for bit, and the port's next step equals the reference's at 1e-6."""
    arch = "olmoe-1b-7b"
    jcfg, tcfg, params, _ = _lm_twin(arch)
    jstep = jax.jit(jmake_step(jcfg, JHParams(warmup=1, remat=False)))
    it = ttext.lm_batches(tcfg.vocab_size, 2, 16, seed=2)
    b0, b1 = next(it), next(it)
    jp, jopt, _ = jstep(params, jadamw_init(params),
                        {k: jnp.asarray(v) for k, v in b0.items()},
                        jnp.asarray(0))
    path = os.path.join(tmp_path, "ck")
    jckpt.save(path, {"params": jp, "opt": jopt._asdict()})
    tm = init_model(tcfg, seed=7, device="cpu")
    tree = ckpt.restore(path, ckpt.train_state(
        tcfg, tm, adamw_init(dict(tm.named_parameters()))))
    topt = ckpt.load_train_state(tcfg, tm, tree)
    want = jax.tree.map(np.asarray, {"params": jp, "opt": jopt._asdict()})
    got = ckpt.train_state(tcfg, tm, topt)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    _, _, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b1.items()},
                     jnp.asarray(1))
    _, _, tmx = make_train_step(tcfg, TrainHParams(warmup=1, remat=False))(
        tm, topt, b1, 1)
    np.testing.assert_allclose(float(tmx["loss"]), float(jm["loss"]),
                               **TIGHT)


def test_resume_equals_unbroken(tmp_path):
    """3 steps, a checkpoint, a fresh model restored from it and 3 more
    steps: the parameters, moments and losses of 6 unbroken steps, bit
    for bit (rwkv6 smoke: every recurrent leaf in the file)."""
    cfg = tregistry.get_smoke_config("rwkv6-1.6b")
    hp = TrainHParams(warmup=2, total_steps=6)
    step = make_train_step(cfg, hp)
    batches = list(zip(range(6), ttext.lm_batches(cfg.vocab_size, 2, 16)))

    def run(model, opt, part):
        losses = []
        for i, b in part:
            model, opt, m = step(model, opt, b, i)
            losses.append(float(m["loss"]))
        return model, opt, losses
    straight = init_model(cfg, device="cpu")
    straight, s_opt, s_loss = run(
        straight, adamw_init(dict(straight.named_parameters())), batches)
    first = init_model(cfg, device="cpu")
    first, opt, loss_a = run(first, adamw_init(dict(
        first.named_parameters())), batches[:3])
    path = os.path.join(tmp_path, "ck")
    ckpt.save(path, ckpt.train_state(cfg, first, opt), {"step": 3})
    second = init_model(cfg, seed=9, device="cpu")
    tree = ckpt.restore(path, ckpt.train_state(
        cfg, second, adamw_init(dict(second.named_parameters()))))
    second, opt, loss_b = run(second, ckpt.load_train_state(cfg, second,
                                                            tree),
                              batches[3:])
    assert loss_a + loss_b == s_loss
    for a, b in zip(jax.tree.leaves(ckpt.train_state(cfg, second, opt)),
                    jax.tree.leaves(ckpt.train_state(cfg, straight, s_opt))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# serving and ingest build no graph; the launcher
# ---------------------------------------------------------------------------


def _no_grad_outputs(fn, record):
    def spy(*a, **kw):
        out = fn(*a, **kw)
        record.append(out[0] if isinstance(out, tuple) else out)
        return out
    return spy


def test_serving_and_ingest_build_no_graph():
    """Parameters of ``init_model`` and ``MEM.init`` are frozen. After a
    ``make_train_step`` has run, an engine's prefill and decode and
    ``make_serve_step`` on a fresh model — and on the trained one — and
    ``MEMEmbedder.embed_frames`` / ``embed_queries`` on a fresh MEM and
    on a trained one return tensors that need no gradient."""
    cfg, trained, _ = _one_port_step("qwen2-vl-7b")
    assert all(p.requires_grad for p in trained.parameters())
    fresh = init_model(cfg, device="cpu")
    assert not any(p.requires_grad for p in fresh.parameters())
    for model in (fresh, trained):
        outs = []
        model.apply = _no_grad_outputs(model.apply, outs)
        eng = ServingEngine(model, batch_slots=2, max_len=64,
                            cache_dtype=torch.float32)
        eng.run([Request(rid=i, tokens=np.arange(3, 9 + i),
                         max_new_tokens=3,
                         vision_embeds=np.zeros((cfg.vision_tokens,
                                                 cfg.d_model), np.float32))
                 for i in range(2)])
        nxt, cache = make_serve_step(model)(
            torch.full((2, 1), 5, dtype=torch.int32), eng.cache)
        del model.apply
        assert len(outs) >= 4
        assert not any(t.requires_grad for t in outs + [nxt])
        assert not any(t.requires_grad for g in ("dense",)
                       for t in cache[g].values())
    mcfg = tmem_smoke()
    mem = MEM.init(mcfg, device="cpu")
    assert not any(p.requires_grad for p in mem.parameters())
    trained_mem = MEM.init(mcfg, seed=1, device="cpu")
    make_mem_train_step(trained_mem, TrainHParams(warmup=1))(
        trained_mem, adamw_init(dict(trained_mem.named_parameters())),
        next(_mem_batches(mcfg, 1)), 1)
    assert trained_mem.logit_scale.requires_grad
    frames = np.random.default_rng(0).random((3, 32, 32, 3)).astype(
        np.float32)
    for m in (mem, trained_mem):
        outs = []
        for name in ("encode_image", "encode_text"):
            setattr(m, name, _no_grad_outputs(getattr(m, name), outs))
        emb = MEMEmbedder(m)
        assert np.isfinite(emb.embed_frames(frames)).all()
        assert np.isfinite(emb.embed_queries(["a red car"])).all()
        for name in ("encode_image", "encode_text"):
            delattr(m, name)
        assert len(outs) == 2 and not any(t.requires_grad for t in outs)


def test_launch_train_smoke(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` at smoke size
    for the audio family (zero stub frames), with remat and a
    checkpoint: finite losses, a falling one, and a file the reference's
    ``restore`` reads."""
    path = os.path.join(tmp_path, "ck")
    launch_train.main(["--arch", "whisper-base", "--steps", "12", "--seq",
                       "32", "--lr", "3e-3", "--remat", "--device", "cpu",
                       "--ckpt", path])
    lines = capsys.readouterr().out.splitlines()
    losses = [float(ln.split()[3]) for ln in lines
              if ln.startswith("step ")]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    jp = JTransformer(jregistry.get_smoke_config("whisper-base")).init(
        jax.random.key(0))
    got = jckpt.restore(path, {"params": jax.tree.map(np.zeros_like, jp)})
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(got))
    with open(path + ".json") as f:
        assert json.load(f)["arch"] == "whisper-base"
