"""Training on the model axis on the CPU: four gloo processes under one
``torchrun --standalone`` train the smoke models of every family — the
VLM (qwen2-vl-7b), KV heads that do not divide the axis (glm4-9b), MLA
with MoE (deepseek-v2-lite-16b), the Mamba2 hybrid (zamba2-2.7b),
rwkv6-1.6b and whisper-base — on ``("data", "model")`` meshes of (2, 2)
and (1, 4): each model placed on the model axis (``init_model(mesh=,
mode="train")``), sharded by FSDP2 over ``data`` (``fsdp_shard``: 2-D
DTensors), two steps of ``make_train_step(mesh=)`` in float32
activations, one intra-op thread. This process holds what they wrote
against the port in one process on the same seed-0 weights and batches:
the losses at rtol 1e-5, every gradient leaf of step 1 (gathered whole)
within a relative L2 of 1e-5 (``tests/test_torch_train_step.py``'s
bound), the parameters after step 2 within 1e-5 · max |p| (the model's
largest parameter: AdamW moves an element whose gradient is at f32
rounding level by a share of the learning rate, whatever its leaf's
own scale) and the clip's global norm at rtol 1e-5. Remat runs off, and
on for glm4-9b on both meshes. Four more cases on (1, 4) split a head by
the axis, one a family (``SPLIT``); their gradient leaves are held to
1e-5 or, where a leaf's own rounding floor in one process is higher, to
twice that floor.

DeepSeek-V2-Lite's MoE aux loss is each data rank's own routing
statistic (``training.trainer``), so at (2, 2) it is held against the
port's FSDP2 run over ``data`` alone (the (2, 1) step: the same ranks'
data sub-mesh, the model unplaced) on the same batches; at (1, 4), with
one data rank, against one process.

Also here: the reference's deepseek-7b smoke weights at (2, 2), its
loss and gathered gradients against ``jax.value_and_grad`` of the
reference's loss; the bytes that rank 0's ``TensorParallel``
collectives moved in a train, a prefill and a decode step of glm4-9b at
(2, 2), against ``launch.dryrun``'s count; the parameters' 2-D
placements against the train table; the step's and ``fsdp_shard``'s
refusals; and the launcher, ``torchrun ... -m repro_torch.launch.train
--model 2``, whose checkpoint holds the one-process run's leaves and
which the reference's ``restore`` reads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.text import lm_batches
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models.params import meta_model
from repro_torch.models.transformer import init_model
from repro_torch.training import TrainHParams, adamw_init, trainer
from repro_torch.training.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-vl-7b", "glm4-9b", "deepseek-v2-lite-16b", "zamba2-2.7b",
         "rwkv6-1.6b", "whisper-base")
MESHES = ((2, 2), (1, 4))
REMAT = "glm4-9b"                     # also trained with remat on
MOE = "deepseek-v2-lite-16b"
B, S, STEPS, LR = 4, 16, 2, 1e-5
# a head split by the axis, one case a family on (1, 4) (config overrides
# as "key=value" words; ``ssm_head_dim`` and ``rwkv_head_dim`` set the
# nested configs' head widths): MLA's heads gathered and its prefill
# sequence-parallel, Mamba2 and RWKV6 on gathered inputs, Whisper's
# encoder sequence-parallel and its cross attention on gathered heads.
# Some of their leaves' gradients sit above 1e-5 of rounding in one
# process (each parameter moved by one ulp of a random sign moves
# zamba2's ``dt_bias`` gradient by 3.7e-5, rwkv6's ``wk`` by 1.9e-4),
# so a leaf of these is held within SENS_X times its own one-ulp
# sensitivity where that is larger than 1e-5.
SPLIT = (("minicpm3-4b_h6", "minicpm3-4b", "num_heads=6 num_kv_heads=6"),
         ("zamba2-2.7b_h6", "zamba2-2.7b",
          "num_heads=6 num_kv_heads=6 ssm_head_dim=128"),
         ("rwkv6-1.6b_h2", "rwkv6-1.6b",
          "num_heads=2 num_kv_heads=2 rwkv_head_dim=64"),
         ("whisper-base_h6", "whisper-base", "num_heads=6 num_kv_heads=6"))
# (mesh, tag, arch, overrides, remat)
CASES = ([(m, a, a, "", False) for m in MESHES for a in ARCHS]
         + [(m, REMAT, REMAT, "", True) for m in MESHES]
         + [((1, 4), t, a, o, False) for t, a, o in SPLIT])
GRAD_REL_L2 = 1e-5
SENS_X = 2
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5                      # × the model's largest |p|
SHAPES = {"train": ShapeSpec("train_4k", S, B, "train"),
          "prefill": ShapeSpec("prefill_32k", S, B, "prefill"),
          "decode": ShapeSpec("decode_32k", S, B, "decode")}

# Shared by the ranks and this process: a smoke config in f32 with a
# case's overrides.
CONFIG = r'''
def case_config(arch, overrides):
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch).replace(dtype="float32")
    kw = {k: int(v) for k, v in (w.split("=") for w in overrides.split())}
    for key, sub in (("ssm_head_dim", "ssm"), ("rwkv_head_dim", "rwkv")):
        if key in kw:
            cfg = cfg.replace(**{sub: dataclasses.replace(
                getattr(cfg, sub), head_dim=kw.pop(key))})
    return cfg.replace(**kw)
'''
exec(CONFIG)

# Each rank: every case from seed 0 on its mesh; the MoE arch's FSDP2 run
# over ``data`` alone at (2, 2); the reference's deepseek-7b weights
# (``ref.pt``) at (2, 2); rank 0's model-axis bytes of a glm4-9b train
# (the remat run's first step), prefill and decode step; the refusals.
# Rank 0 writes one npz.
SCRIPT = CONFIG + r'''
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.text import lm_batches
from repro_torch.launch.mesh import init_ranks, make_abstract_mesh, \
    to_device_mesh
from repro_torch.launch.sharding import tp_shard, via_host
from repro_torch.models.transformer import Transformer, init_model
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.training import TrainHParams, adamw_init, trainer
from repro_torch.training.trainer import fsdp_shard, make_train_step

out, ref_state = sys.argv[1], sys.argv[2]
B, S, STEPS = (int(a) for a in sys.argv[3:6])
LR = float(sys.argv[6])
CASES, MOE = json.loads(sys.argv[7]), sys.argv[8]
torch.set_num_threads(1)
init_ranks("cpu")
rank = dist.get_rank()
update, grads_of = trainer.adamw_update, {}


def spy(grads, *a, **kw):
    # step 1's gradients, every leaf gathered whole (a collective)
    if "g" not in grads_of:
        grads_of["g"] = {k: (g.full_tensor() if hasattr(g, "full_tensor")
                             else g).detach().clone()
                         for k, g in grads.items()}
    return update(grads, *a, **kw)


trainer.adamw_update = spy


def batches(cfg):
    it = lm_batches(cfg.vocab_size, B, S, seed=1)
    rng = np.random.default_rng(2)
    out = []
    for _ in range(STEPS):
        b = next(it)
        if cfg.family == "vlm":
            b["vision_embeds"] = rng.normal(0, 0.02, (
                B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["encoder_frames"] = rng.normal(0, 0.02, (
                B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def rows(b, d, n):
    per = B // n
    return {k: v[d * per:(d + 1) * per] for k, v in b.items()}


def train(tag, model, cfg, dm, remat, on_first=None):
    hp = TrainHParams(base_lr=LR, warmup=0, total_steps=STEPS, remat=remat)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, hp, mesh=dm)
    n = dm.size(0)
    d = dm.get_local_rank("data")
    grads_of.clear()
    losses, norms = [], []
    for i, b in enumerate(batches(cfg)):
        if i == 0 and on_first:
            on_first(model, True)
        model, opt, m = step(model, opt, rows(b, d, n), i)
        if i == 0 and on_first:
            on_first(model, False)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    res[f"{tag}/loss"] = np.array(losses)
    res[f"{tag}/grad_norm"] = np.array(norms)
    for k, g in grads_of["g"].items():
        res[f"{tag}/grad/{k}"] = g.numpy()
    for k, p in model.named_parameters():
        res[f"{tag}/param/{k}"] = p.full_tensor().detach().numpy()
    return model


def moved(model, start):
    if start:
        model.tp.moved = {}
    else:
        res["bytes/train"] = dict(model.tp.moved)
        model.tp.moved = None


def refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


res = {}
for mesh in ([2, 2], [1, 4]):
    dm = to_device_mesh(make_abstract_mesh(mesh, ("data", "model")), "cpu")
    for _, tag, arch, overrides, remat in (c for c in CASES
                                           if c[0] == mesh):
        cfg = case_config(arch, overrides)
        model = fsdp_shard(init_model(cfg, seed=0, device="cpu", mesh=dm,
                                      mode="train"), dm)
        if arch == MOE and mesh == [2, 2]:
            for name, p in model.named_parameters():
                res[f"placement/{name}"] = str(tuple(p.placements))
                res[f"via_host/{name}"] = bool(torch.equal(
                    via_host(p.detach()), p.detach().full_tensor()))
        train(f"{mesh[0]}x{mesh[1]}_{tag}" + ("_remat" if remat else ""),
              model, cfg, dm, remat,
              moved if remat and mesh == [2, 2] else None)
    if mesh != [2, 2]:
        continue
    # the MoE arch's FSDP2 step over the data axis alone: the (2, 1) step
    cfg = get_smoke_config(MOE).replace(dtype="float32")
    train(f"2x1_{MOE}", fsdp_shard(init_model(cfg, seed=0, device="cpu"),
                                   dm["data"]), cfg, dm["data"], False)
    # the reference's deepseek-7b weights: step 1's loss and gradients
    cfg = get_smoke_config("deepseek-7b").replace(dtype="float32")
    model = Transformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(ref_state))
    model = fsdp_shard(tp_shard(model, dm, mode="train"), dm)
    batch = np.load(ref_state + ".batch.npz")
    grads_of.clear()
    _, _, m = make_train_step(cfg, TrainHParams(remat=False), mesh=dm)(
        model, adamw_init(dict(model.named_parameters())),
        rows(dict(batch), dm.get_local_rank("data"), 2), 0)
    res["ref/loss"] = float(m["loss"])
    for k, g in grads_of["g"].items():
        res[f"ref/grad/{k}"] = g.numpy()
    # rank 0's model-axis bytes of glm4-9b's prefill and decode steps
    cfg = get_smoke_config("glm4-9b").replace(dtype="float32")
    model = init_model(cfg, seed=0, device="cpu", mesh=dm)
    tok = torch.from_numpy(batches(cfg)[0]["tokens"])
    model.tp.moved = {}
    make_prefill_step(model, max_len=S)(tok)
    res["bytes/prefill"], model.tp.moved = dict(model.tp.moved), {}
    make_serve_step(model)(tok[:, :1], model.init_cache(B, S,
                                                       torch.bfloat16))
    res["bytes/decode"], model.tp.moved = dict(model.tp.moved), None
    # the refusals
    step = make_train_step(cfg, TrainHParams())
    b = rows(batches(cfg)[0], dm.get_local_rank("data"), 2)
    res["refuse/placed_no_mesh"] = refusal(lambda: step(model, None, b, 0))
    res["refuse/placed_not_fsdp"] = refusal(lambda: make_train_step(
        cfg, TrainHParams(), mesh=dm)(model, None, b, 0))
    res["refuse/fsdp_no_tp"] = refusal(lambda: fsdp_shard(
        init_model(cfg, seed=0, device="cpu"), dm))
for k in ("train", "prefill", "decode"):
    res[f"bytes/{k}"] = np.array(sorted(res[f"bytes/{k}"].items()),
                                 dtype=object)
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(arch):
    return get_smoke_config(arch).replace(dtype="float32")


def _batches(cfg):
    """The ranks' batches (``SCRIPT``'s ``batches``)."""
    it = lm_batches(cfg.vocab_size, B, S, seed=1)
    rng = np.random.default_rng(2)
    out = []
    for _ in range(STEPS):
        b = next(it)
        if cfg.family == "vlm":
            b["vision_embeds"] = rng.normal(0, 0.02, (
                B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["encoder_frames"] = rng.normal(0, 0.02, (
                B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _ref_batch():
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.fixture(scope="module")
def twin():
    """The reference's smoke deepseek-7b (key 0, f32): its weights as the
    port's state dict, and its loss and gradients (port names) on
    ``_ref_batch`` by ``jax.value_and_grad`` of its loss."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.models.transformer import Transformer as JTransformer
    from repro.training.losses import lm_cross_entropy as jlm_ce
    from repro_torch.core.convert import model_params_from_numpy
    jcfg = jregistry.get_smoke_config("deepseek-7b").replace(
        dtype="float32")
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))

    def loss_fn(p, b):
        logits, _, aux = jm.apply(p, b["tokens"], mode="train")
        loss, _ = jlm_ce(logits, b["labels"], None)
        return loss + aux
    batch = _ref_batch()
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = _f32("deepseek-7b")
    return (model_params_from_numpy(cfg, jax.tree.map(np.asarray, params)),
            float(loss),
            model_params_from_numpy(cfg, jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, twin):
    """One ``torchrun --standalone`` of 4 gloo processes → its npz."""
    tmp = tmp_path_factory.mktemp("tp_train")
    script, out, state = (str(tmp / n) for n in ("w.py", "w.npz", "ref.pt"))
    with open(script, "w") as f:
        f.write(SCRIPT)
    torch.save(twin[0], state)
    np.savez(state + ".batch.npz", **_ref_batch())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", script, out, state,
         *map(str, (B, S, STEPS, LR)), json.dumps(CASES), MOE],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "[ranks] world 4, backend gloo" in run.stdout
    with np.load(out, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_process():
    """The port in one process, per case's config: losses, the clip's
    norms, step 1's gradients and the parameters after step 2 (remat off;
    remat's gradients are bit-equal, ``tests/test_torch_train_step.py``)."""
    update = trainer.adamw_update
    out = {}
    for _, tag, arch, overrides, _ in CASES:
        if tag in out:
            continue
        cfg = case_config(arch, overrides)
        model = init_model(cfg, seed=0, device="cpu")
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(cfg, TrainHParams(
            base_lr=LR, warmup=0, total_steps=STEPS, remat=False))
        seen = {}

        def spy(grads, *a, **kw):
            seen.setdefault("g", {k: g.detach().clone()
                                  for k, g in grads.items()})
            return update(grads, *a, **kw)
        trainer.adamw_update = spy
        try:
            losses, norms = [], []
            for i, b in enumerate(_batches(cfg)):
                model, opt, m = step(model, opt, b, i)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        finally:
            trainer.adamw_update = update
        out[tag] = dict(
            loss=np.array(losses), grad_norm=np.array(norms),
            grad={k: g.numpy() for k, g in seen["g"].items()},
            param={k: p.detach().numpy()
                   for k, p in model.named_parameters()})
        if overrides:
            out[tag]["sens"] = _sensitivity(cfg, out[tag]["grad"])
    return out


def _sensitivity(cfg, grads):
    """Each gradient leaf's largest relative L2 move, in one process, when
    every parameter is scaled by 1 ± 2^-23 (one ulp), the signs drawn
    from two seeds: the rounding floor of its step-1 gradient."""
    worst = {k: 0.0 for k in grads}
    b = {k: torch.as_tensor(v) for k, v in _batches(cfg)[0].items()}
    for seed in (1, 2):
        model = init_model(cfg, seed=0, device="cpu")
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                p.mul_(1 + sign * 2.0 ** -23)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        got = torch.autograd.grad(trainer.lm_loss(cfg, model, b)[0],
                                  list(params.values()), allow_unused=True)
        for k, g in zip(params, got):
            if g is not None:
                worst[k] = max(worst[k], _rel_l2(g.numpy(), grads[k]))
    return worst


def _tag(mesh, tag, remat=False):
    return f"{mesh[0]}x{mesh[1]}_{tag}" + ("_remat" if remat else "")


def _got(ranks, tag):
    def leaves(kind):
        pre = f"{tag}/{kind}/"
        return {k[len(pre):]: v for k, v in ranks.items()
                if k.startswith(pre)}
    return dict(loss=ranks[f"{tag}/loss"],
                grad_norm=ranks[f"{tag}/grad_norm"],
                grad=leaves("grad"), param=leaves("param"))


def _want(ranks, one_process, mesh, tag):
    """One process's run, or for the MoE arch at data 2 the ranks' (2, 1)
    run (each data rank's own aux)."""
    if tag == MOE and mesh[0] > 1:
        return _got(ranks, f"2x1_{MOE}")
    return one_process[tag]


def _rel_l2(got, want):
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got.astype(np.float64) - want))
    return num / den if den else num


@pytest.mark.parametrize("mesh,tag,arch,overrides,remat", CASES)
def test_losses_and_norms_match_one_process(ranks, one_process, mesh, tag,
                                            arch, overrides, remat):
    """Both steps' losses (means over ``data``) and the clip's global
    norms (each element once: a leaf replicated over ``model`` counted
    once) at rtol 1e-5."""
    got = _got(ranks, _tag(mesh, tag, remat))
    want = _want(ranks, one_process, mesh, tag)
    assert got["loss"].shape == (STEPS,)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=LOSS_RTOL)
    assert np.all(got["grad_norm"] > 1)            # the clip engaged


@pytest.mark.parametrize("mesh,tag,arch,overrides,remat", CASES)
def test_step1_gradients_match_one_process(ranks, one_process, mesh, tag,
                                           arch, overrides, remat):
    """Every gradient leaf of step 1, gathered whole over both axes,
    within a relative L2 of 1e-5 of one process's — the embeddings and
    every layer below the logits included; a head-split case's leaf
    within ``SENS_X`` times its one-ulp sensitivity where that is
    larger."""
    want_run = _want(ranks, one_process, mesh, tag)
    got = _got(ranks, _tag(mesh, tag, remat))["grad"]
    want = want_run["grad"]
    sens = want_run.get("sens", {})
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k], want[k]) / max(
        GRAD_REL_L2, SENS_X * sens.get(k, 0.0)) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1, (worst, errs[worst] * max(
        GRAD_REL_L2, SENS_X * sens.get(worst, 0.0)), sens.get(worst))
    assert np.abs(got["embed"]).max() > 0


@pytest.mark.parametrize("mesh,tag,arch,overrides,remat", CASES)
def test_parameters_after_step2_match_one_process(ranks, one_process, mesh,
                                                  tag, arch, overrides,
                                                  remat):
    """Every parameter after step 2, gathered whole, within 1e-5 · max
    |p| (the model's largest) of one process's: AdamW on 2-D DTensors,
    shard by shard."""
    got = _got(ranks, _tag(mesh, tag, remat))["param"]
    want = _want(ranks, one_process, mesh, tag)["param"]
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=PARAM_TOL * scale, err_msg=k)


def test_moe_aux_at_data2_is_each_data_ranks_own(ranks, one_process):
    """At (2, 2) the MoE step is the (2, 1) FSDP2 step (held above), not
    one process's: each data rank's aux is over its own routing."""
    got = _got(ranks, _tag((2, 2), MOE))["loss"]
    assert abs(got[0] - one_process[MOE]["loss"][0]) > 1e-5


def test_reference_weights_match_jax_value_and_grad(ranks, twin):
    """The reference's deepseek-7b weights at (2, 2): step 1's loss at
    rtol/atol 1e-6 and every gathered gradient leaf within a relative L2
    of 1e-5 of ``jax.value_and_grad`` of the reference's loss."""
    _, loss, want = twin
    np.testing.assert_allclose(float(ranks["ref/loss"]), loss, rtol=1e-6,
                               atol=1e-6)
    got = {k[len("ref/grad/"):]: v for k, v in ranks.items()
           if k.startswith("ref/grad/")}
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k], want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_counts_rank0s_model_axis_bytes(ranks, kind):
    """The dry run's model-axis bytes by op for glm4-9b smoke at (2, 2)
    (the train step with remat: its forward, recompute and backward) are
    what rank 0's ``TensorParallel`` collectives moved; the record's
    collective bytes add FSDP2's, and its note no longer says the port
    runs no tensor-parallel collective."""
    rec = dryrun.lower_combo("glm4-9b", SHAPES[kind],
                             mesh=make_abstract_mesh((2, 2),
                                                     ("data", "model")),
                             cfg=_f32("glm4-9b"), verbose=False)
    got = {op: float(v) for op, v in ranks[f"bytes/{kind}"]}
    want = {op: v for op, v in
            rec["model_axis_collective_bytes_per_device"].items() if v}
    assert got == want and got["all-reduce"] > 0
    coll = rec["collective_bytes_per_device"]
    assert coll["all-reduce"] == want["all-reduce"]
    if kind == "train":
        assert coll["all-gather"] > want["all-gather"]
        assert got.get("reduce-scatter", 0) == 0    # heads divide 2
    assert "no tensor-parallel" not in rec["collective_note"]


def test_parameters_are_2d_dtensors_by_the_train_table(ranks):
    """At (2, 2) every parameter of the MLA + MoE model is a DTensor of
    the ("data", "model") mesh: over ``model`` the train table's split
    (``Shard`` of its TP dim, else ``Replicate``); over ``data`` its FSDP
    dim, or FSDP2's ``Shard(0)`` where the table gives none — interleaved
    (``_StridedShard``) where that is the TP dim too (the vocabulary
    table, which the table replicates over ``data``)."""
    cfg = _f32(MOE)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    specs = shd.param_specs(meta_model(cfg), mesh, mode="train")
    got = {k[len("placement/"):]: str(v) for k, v in ranks.items()
           if k.startswith("placement/")}
    assert set(got) == set(specs)
    strided = 0
    for name, spec in specs.items():
        tp = [d for d in range(len(spec)) if "model" in
              shd.spec_axes(spec, d)]
        fsdp = [d for d in range(len(spec)) if "data" in
                shd.spec_axes(spec, d)]
        model = f"Shard(dim={tp[0]})" if tp else "Replicate()"
        dim = fsdp[0] if fsdp else 0
        assert got[name].endswith(f", {model})"), (name, got[name])
        if tp and dim == tp[0]:
            strided += 1
            assert got[name].startswith(f"(_StridedShard(dim={dim}"), name
        else:
            assert got[name].startswith(f"(Shard(dim={dim})"), name
    assert strided == 1 and got["embed"].startswith("(_StridedShard(dim=0")


def test_host_gather_equals_full_tensor(ranks):
    """``launch.sharding.via_host`` (the shards gathered on a CPU twin of
    the mesh: how ``gather_whole`` gathers CUDA DTensors over gloo) gives
    every 2-D parameter's ``full_tensor``, strided ones included."""
    got = {k: bool(v) for k, v in ranks.items() if k.startswith("via_host/")}
    assert len(got) == len([k for k in ranks if k.startswith("placement/")])
    assert all(got.values())


def test_refusals(ranks):
    """The step refuses a model placed on the model axis without
    ``fsdp_shard`` (with or without a mesh), and ``fsdp_shard`` refuses
    an unplaced model on a model axis larger than 1."""
    assert "fsdp_shard" in str(ranks["refuse/placed_no_mesh"])
    assert "fsdp_shard" in str(ranks["refuse/placed_not_fsdp"])
    assert "tp_shard" in str(ranks["refuse/fsdp_no_tp"])


def test_launcher_model2_checkpoint_holds_one_process(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --model
    2`` in f32 activations: the (2, 2) mesh, the one-process run's
    printed losses, a checkpoint of every leaf gathered whole — the
    moments within 1e-5 of each leaf's scale, the parameters within 1e-5
    of the model's largest (at the launcher's default lr, 3e-4, AdamW
    moves a few embedding elements whose gradient is at f32 rounding
    level by a tenth of lr: run at 1e-5) — which the reference's
    ``restore`` reads."""
    from repro.configs import registry as jregistry
    from repro.models.transformer import Transformer as JTransformer
    from repro.training import checkpoint as jckpt
    from repro.training.optim import adamw_init as jadamw_init
    import jax
    args = ["--arch", "deepseek-7b", "--steps", "3", "--batch", "4",
            "--seq", "32", "--device", "cpu", "--dtype", "float32",
            "--lr", "1e-5"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    mesh = str(tmp_path / "mesh")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--model", "2", *args, "--ckpt", mesh],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "mesh=(data 2, model 2) fsdp x tp" in run.stdout
    one = str(tmp_path / "one")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt",
         one], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]

    def steps(out):
        return [ln.split()[3] for ln in out.splitlines()
                if ln.startswith("step ")]
    assert steps(run.stdout) == steps(proc.stdout) and len(
        steps(run.stdout)) == 3
    with np.load(one + ".npz") as x, np.load(mesh + ".npz") as y:
        assert sorted(x.files) == sorted(y.files)
        top = max(float(np.abs(x[k]).max()) for k in x.files
                  if k.startswith("params/"))
        for k in x.files:
            a, b = x[k], y[k]
            if a.dtype.kind != "f":
                np.testing.assert_array_equal(b, a, err_msg=k)
                continue
            scale = top if k.startswith("params/") else float(
                np.abs(a).max())
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
    jp = JTransformer(jregistry.get_smoke_config("deepseek-7b")).init(
        jax.random.key(5))
    target = jax.tree.map(np.zeros_like,
                          {"params": jp, "opt": jadamw_init(jp)._asdict()})
    back = jckpt.restore(mesh, target)
    assert jax.tree.structure(back) == jax.tree.structure(target)
    with np.load(mesh + ".npz") as y:
        np.testing.assert_array_equal(back["params"]["embed"],
                                      y["params/embed"])
        assert int(back["opt"]["count"]) == 3


def test_collectives_carry_gradients_on_a_recording_rank():
    """``RecordingTP`` (rank 0 of a (1, 4) mesh, no process group): the
    autograd collectives' backward — ``copy`` sums (an all-reduce),
    ``all_reduce`` passes through, ``all_reduce_stat`` sums, a gather
    takes the rank's slice, or reduce-scatters with ``scatter`` — each
    recorded by op with the reference's ring factors."""
    tp = shd.RecordingTP(make_abstract_mesh((1, 4), ("data", "model")),
                         device="cpu")
    x = torch.randn(2, 3, requires_grad=True)
    y = tp.all_reduce(tp.copy(x) * 2)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    assert tp.moved["all-reduce"] == 2 * 2 * (2 * 3 * 4)
    tp.moved = {}
    x.grad = None
    tp.all_reduce_stat(x).sum().backward()
    assert tp.moved["all-reduce"] == 2 * 2 * (2 * 3 * 4)
    tp.moved = {}
    g = tp.gather_model(x)
    assert g.shape == (2, 12)
    (g * torch.arange(12.0)).sum().backward(inputs=[x])
    assert tp.moved == {"all-gather": 2 * 12 * 4}
    tp.moved = {}
    x.grad = None
    (tp.gather_model(x, 0, scatter=True) * 1.0).sum().backward()
    assert tp.moved == {"all-gather": 8 * 3 * 4, "reduce-scatter": 2 * 3 * 4}
    with torch.no_grad():
        tp.moved = {}
        assert tp.copy(x) is x
        assert tp.moved == {}
