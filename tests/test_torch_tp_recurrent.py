"""Serving the rest of the zoo on the model axis on the CPU: four gloo
processes under one ``torchrun --standalone`` place the smoke zamba2-2.7b
(Mamba2 layers and the weight-tied shared attention block), rwkv6-1.6b
and whisper-base (encoder, decoder self and cross attention, learned
positions) on ``("data", "model")`` meshes of (2, 2) and (1, 4) and serve
them, in float32 activations and caches; this process holds what they
wrote against the reference's tables, against the port in one process
and against the reference's own ``apply``.

In the smoke cases the heads divide the model axis: each rank keeps its
Mamba2 heads (and its slices of ``A_log``, ``D``, ``dt_bias``,
``norm_scale``; the gated norm's sum of squares all-reduced), its RWKV6
heads, its attention heads and their cache, and its ``ssm`` or ``wkv``
state heads. Three more cases on (1, 4) split a head: zamba2-2.7b with
6 attention heads and 2 Mamba2 heads of 128 channels (the shared block's
cache by its sequence, #5's partials merged across the ranks, the Mamba2
layers on gathered x and z), rwkv6-1.6b with 2 heads of 64 (r, k, v, g
and the decay gathered) and whisper-base with 6 heads (the encoder and
the decoder's self-attention through the sequence-parallel hook, the
self-attention cache by its sequence). Logits within rtol/atol 1e-5 of
one process, greedy tokens equal, the recurrent state shards equal to
the one process's heads; the reference's weights carried over by
``core.convert`` give the reference's logits within 1e-4.

Also here, in this process: the gated norm of Mamba2 over simulated
ranks, with and without its all-reduce."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import ssm as tssm
from repro_torch.models.params import meta_model
from repro_torch.models.transformer import init_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("zamba2-2.7b", "rwkv6-1.6b", "whisper-base")
MESHES = ((2, 2), (1, 4))
# (tag, arch, config overrides as "key=value" words, mesh)
EXTRA = (("zamba2-2.7b_h6", "zamba2-2.7b",
          "num_heads=6 num_kv_heads=6 ssm_head_dim=128", (1, 4)),
         ("rwkv6-1.6b_h2", "rwkv6-1.6b",
          "num_heads=2 num_kv_heads=2 rwkv_head_dim=64", (1, 4)),
         ("whisper-base_h6", "whisper-base", "num_heads=6 num_kv_heads=6",
          (1, 4)))
CASES = ([(m, a, a, "") for m in MESHES for a in ARCHS]
         + [(m, t, a, o) for t, a, o, m in EXTRA])
SLOTS, MAX_LEN, STEPS = 2, 64, 4
CLOSE = dict(rtol=1e-5, atol=1e-5)
REF_CLOSE = dict(rtol=1e-4, atol=1e-4)
N_REQ, MAX_NEW = 3, 4
# the recurrent state of each family: (cache group, leaf)
STATE = {"zamba2-2.7b": ("mamba", "ssm"), "rwkv6-1.6b": ("rwkv", "wkv")}

# Shared by the ranks and this process: a smoke config in f32 with the
# overrides of a case (``ssm_head_dim`` and ``rwkv_head_dim`` set the
# nested configs' head widths).
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

# Each rank: every case from seed 0 (``init_model(mesh=)``), its
# placements, teacher-forced logits, the recurrent state shard after
# them (gathered to rank 0 with the rank's coordinates), the engine's
# greedy tokens, and the calls into the sequence-parallel hook and #5's
# partials; then the reference's weights (``<arch>.pt``) on (1, 4) by
# ``ServingEngine(mesh=)``, with one ``make_serve_step`` step. Rank 0
# writes one npz.
SCRIPT = CONFIG + r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_ranks, make_abstract_mesh, \
    to_device_mesh
from repro_torch.launch import serve
from repro_torch.launch.sharding import is_placed, local
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Transformer, init_model
from repro_torch.serving.engine import (Request, ServingEngine,
                                        make_serve_step)

out, tmp = sys.argv[1], sys.argv[2]
SLOTS, MAX_LEN, STEPS, N_REQ, MAX_NEW = (int(a) for a in sys.argv[3:8])
cases = [c.split("|") for c in sys.argv[8].split(";")]
twins = sys.argv[9].split(",")
states = dict(s.split(":") for s in sys.argv[10].split(","))
torch.set_num_threads(1)
init_ranks("cpu")
rank = dist.get_rank()
calls = {"seq_shard": 0, "gqa_partials": 0, "placements": 0}
hook, gqa, apply = A._seq_shard, ops.decode_attention, Transformer.apply
place_params = T.place_params
last = {}


def place_spy(model, tp, **kw):
    # a call that finds parameters to place: one block drawn since the last
    calls["placements"] += any(not is_placed(p)
                               for p in model.parameters())
    return place_params(model, tp, **kw)


def seq_shard(q, k, v, tp):
    calls["seq_shard"] += 1
    return hook(q, k, v, tp)


def decode_attention(*a, partials=False, **kw):
    calls["gqa_partials"] += partials
    return gqa(*a, partials=partials, **kw)


def keep_cache(self, tokens, **kw):
    out = apply(self, tokens, **kw)
    last["cache"] = out[1]
    return out


A._seq_shard = seq_shard
A.kops.decode_attention = decode_attention
Transformer.apply = keep_cache
T.place_params = place_spy


def requests(cfg):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQ):
        r = Request(rid=i, tokens=rng.integers(3, cfg.vocab_size, size=int(
            rng.integers(8, 40))), max_new_tokens=MAX_NEW)
        if cfg.family == "audio":
            r.encoder_frames = rng.normal(0, 0.02, (
                cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        reqs.append(r)
    return reqs


def placements(tree, prefix=""):
    got = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            got.update(placements(v, name + "/"))
        else:
            assert is_placed(v), name
            got[name] = str(tuple(v.placements))
    return got


def mesh_of(mesh):
    return to_device_mesh(make_abstract_mesh(mesh, ("data", "model")), "cpu")


res = {}
for mesh, tag, arch, overrides in cases:
    mesh = tuple(int(x) for x in mesh.split("x"))
    tag = f"{mesh[0]}x{mesh[1]}_{tag}"
    cfg = case_config(arch, overrides)
    calls.update(placements=0)
    model = init_model(cfg, seed=0, device="cpu", mesh=mesh_of(mesh))
    res[f"{tag}/placements"] = np.array(calls["placements"])
    for name, p in model.named_parameters():
        assert is_placed(p), name
        res[f"{tag}/param/{name}"] = str(tuple(p.placements))
    for name, pl in placements(model.init_cache(SLOTS, MAX_LEN)).items():
        res[f"{tag}/cache/{name}"] = pl
    calls.update(seq_shard=0, gqa_partials=0)
    _, _, logits = serve.teacher_forced(model, cfg, batch=SLOTS,
                                        max_len=MAX_LEN, steps=STEPS)
    res[f"{tag}/logits"] = logits
    res[f"{tag}/calls"] = np.array([calls["seq_shard"],
                                    calls["gqa_partials"]])
    if arch in states:
        group, leaf = states[arch].split("/")
        shard = local(last["cache"][group][leaf]).numpy()
        tp = model.tp
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (tp.data_rank, tp.rank, shard))
        for r, (dr, mr, s) in enumerate(got):
            res[f"{tag}/state/{r}"] = s
            res[f"{tag}/coords/{r}"] = np.array([dr, mr])
    done = ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                         cache_dtype=torch.float32).run(requests(cfg))
    res[f"{tag}/tokens"] = np.array([r.generated for r in done])

# the reference's weights, placed on (1, 4) by ServingEngine(mesh=); then
# one greedy step of make_serve_step(mesh=) after a teacher prefill
for arch in twins:
    cfg = case_config(arch, "")
    model = Transformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(f"{tmp}/{arch}.pt"))
    dm = mesh_of((1, 4))
    ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                  cache_dtype=torch.float32, mesh=dm)
    _, _, logits = serve.teacher_forced(model, cfg, batch=SLOTS,
                                        max_len=MAX_LEN, steps=STEPS)
    res[f"ref/{arch}/logits"] = logits
    tok, lens, fed, side = serve.teacher_inputs(cfg, batch=SLOTS,
                                                steps=STEPS)
    kw = {} if side is None else {"encoder_frames": torch.from_numpy(side)}
    _, cache, _ = model.apply(
        torch.from_numpy(tok), cache=model.init_cache(
            SLOTS, MAX_LEN, torch.float32), mode="prefill",
        prompt_lengths=torch.from_numpy(lens.astype(np.int32)), **kw)
    nxt, _ = make_serve_step(model, mesh=dm)(torch.from_numpy(fed[0]),
                                             cache)
    res[f"ref/{arch}/serve_tokens"] = nxt.numpy()
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


def _tag(mesh, tag):
    return f"{mesh[0]}x{mesh[1]}_{tag}"


@pytest.fixture(scope="module")
def twins():
    """Per arch: the reference's smoke model, its params (its jitted
    ``init`` at key 0: a third of the eager one's time), its jitted
    ``apply``, and the same weights as the port's state dict."""
    import jax
    from repro.configs import registry as jregistry
    from repro.models.transformer import Transformer as JTransformer
    from repro_torch.core.convert import model_params_from_numpy
    out = {}
    for arch in ARCHS:
        jcfg = jregistry.get_smoke_config(arch).replace(dtype="float32")
        jm = JTransformer(jcfg)
        params = jax.jit(jm.init)(jax.random.key(0))
        state = model_params_from_numpy(case_config(arch, ""),
                                        jax.tree.map(np.asarray, params))
        out[arch] = (jm, params, jax.jit(jm.apply, static_argnames=("mode",
                                                                    )), state)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, twins):
    """One ``torchrun --standalone`` of 4 gloo processes → its npz."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    script, out = str(tmp / "tp.py"), str(tmp / "tp.npz")
    with open(script, "w") as f:
        f.write(SCRIPT)
    for arch, tw in twins.items():
        torch.save(tw[-1], str(tmp / f"{arch}.pt"))
    cases = ";".join(f"{m[0]}x{m[1]}|{t}|{a}|{o}" for m, t, a, o in CASES)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", script, out, str(tmp),
         *map(str, (SLOTS, MAX_LEN, STEPS, N_REQ, MAX_NEW)), cases,
         ",".join(ARCHS),
         ",".join(f"{a}:{g}/{leaf}" for a, (g, leaf) in STATE.items())],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "[ranks] world 4, backend gloo" in run.stdout
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_process():
    """The port in one process: per case, teacher-forced logits, the
    recurrent state after them, and the engine's greedy tokens (the same
    seeds and requests as the ranks)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import Request, ServingEngine
    out, last, apply = {}, {}, Transformer.apply

    def keep_cache(self, tokens, **kw):
        res = apply(self, tokens, **kw)
        last["cache"] = res[1]
        return res
    Transformer.apply = keep_cache
    try:
        for _, tag, arch, overrides in CASES:
            if tag in out:
                continue
            cfg = case_config(arch, overrides)
            model = init_model(cfg, seed=0, device="cpu")
            _, _, logits = tserve.teacher_forced(
                model, cfg, batch=SLOTS, max_len=MAX_LEN, steps=STEPS)
            state = None
            if arch in STATE:
                group, leaf = STATE[arch]
                state = last["cache"][group][leaf].numpy()
            rng = np.random.default_rng(0)
            reqs = []
            for i in range(N_REQ):
                r = Request(rid=i, tokens=rng.integers(
                    3, cfg.vocab_size, size=int(rng.integers(8, 40))),
                    max_new_tokens=MAX_NEW)
                if cfg.family == "audio":
                    r.encoder_frames = rng.normal(0, 0.02, (
                        cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
                reqs.append(r)
            done = ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                                 cache_dtype=torch.float32).run(reqs)
            out[tag] = (logits, np.array([r.generated for r in done]),
                        state)
    finally:
        Transformer.apply = apply
    return out


class _Names:                 # to_placements reads only the dim names
    mesh_dim_names = ("data", "model")


def _walk(tree, spec, want, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            _walk(v, spec[k], want, f"{prefix}{k}/")
        else:
            want[f"{prefix}{k}"] = str(tuple(shd.to_placements(spec[k],
                                                               _Names())))


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_params_placed_by_the_tables(ranks, mesh, tag, arch, overrides):
    """Every parameter's placements are ``to_placements(param_spec(...,
    mode="serve"))`` of the reference's tables, leaf for leaf: Mamba2's
    ``in_z``/``in_x``/``in_dt`` and the x convolution by head (``in_dt``
    whole where its heads do not divide), ``in_bc`` whole, ``out_proj`` by
    rows; RWKV6's ``cm_wv`` and ``cm_wr`` by columns (the first-match
    quirk); Whisper's learned positions by rows; the hybrid's shared
    block and Whisper's encoder as the decoders' blocks."""
    cfg = case_config(arch, overrides)
    model = meta_model(cfg)
    specs = shd.param_specs(model, make_abstract_mesh(mesh, ("data",
                                                             "model")),
                            mode="serve")
    got = {k.split("/param/")[1]: str(v) for k, v in ranks.items()
           if k.startswith(f"{_tag(mesh, tag)}/param/")}
    assert set(got) == set(specs)
    for name, spec in specs.items():
        assert got[name] == str(tuple(shd.to_placements(spec, _Names()))), \
            name
    if arch == "zamba2-2.7b":
        assert specs["blocks.0.mamba.in_x"] == shd.P(None, "model")
        assert specs["blocks.0.mamba.in_bc"] == shd.P(None, None)
        assert specs["blocks.0.mamba.out_proj"] == shd.P("model", None)
        assert specs["blocks.0.mamba.in_dt"] == (
            shd.P(None, None) if tag.endswith("_h6") else
            shd.P(None, "model"))
        assert specs["shared.attn.wq"] == shd.P(None, "model")
    if arch == "rwkv6-1.6b":
        for leaf in ("cm_wk", "cm_wv", "cm_wr"):
            assert specs[f"blocks.0.mix.{leaf}"] == shd.P(None, "model")
        assert specs["blocks.0.mix.bonus_u"] == (
            shd.P(None, None) if tag.endswith("_h2") else
            shd.P("model", None))
    if arch == "whisper-base":
        for leaf in ("pos_embed", "enc_pos_embed"):
            assert specs[leaf] == shd.P("model", None)
        assert specs["enc_blocks.0.attn.wo"] == shd.P("model", None)
        assert specs["blocks.0.xattn.wk"] == shd.P(None, "model")


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_blocks_placed_as_they_are_drawn(ranks, mesh, tag, arch,
                                         overrides):
    """``init_model(mesh=)`` places each block before the next is drawn
    (a rank never holds the whole model): a placement that finds new
    parameters after every block, the encoder's too, and one before the
    first."""
    cfg = case_config(arch, overrides)
    blocks = cfg.num_layers + (cfg.num_encoder_layers
                               if arch == "whisper-base" else 0)
    assert int(ranks[f"{_tag(mesh, tag)}/placements"]) >= blocks + 1


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_cache_placed_by_the_tables(ranks, mesh, tag, arch, overrides):
    """Every cache leaf's placements are ``cache_specs``': ``ssm``,
    ``conv_x`` and ``wkv`` by head where the heads divide the axis (else
    whole), the attention caches by their heads or else their sequence,
    ``enc_out`` and the token shifts whole; the batch over ``data``."""
    model = meta_model(case_config(arch, overrides))
    cache = model._cache_tree(SLOTS, MAX_LEN, torch.float32, "meta")
    want = {}
    _walk(cache, shd.cache_specs(cache, make_abstract_mesh(
        mesh, ("data", "model"))), want)
    got = {k.split("/cache/")[1]: str(v) for k, v in ranks.items()
           if k.startswith(f"{_tag(mesh, tag)}/cache/")}
    assert got == want
    split = "(Shard(dim=1), Shard(dim=2))"
    if arch == "zamba2-2.7b":
        assert (got["mamba/ssm"] == split) == (tag == arch)
        assert got["shared/k"] == ("(Shard(dim=1), Shard(dim=3))"
                                   if tag == arch else split)
    if arch == "rwkv6-1.6b":
        assert (got["rwkv/wkv"] == split) == (tag == arch)
    if arch == "whisper-base":
        assert got["enc_out"] == "(Shard(dim=0), Replicate())"
        assert got["self/k"] == ("(Shard(dim=1), Shard(dim=3))"
                                 if tag == arch else split)


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_logits_match_one_process(ranks, one_process, mesh, tag, arch,
                                  overrides):
    """Prefill and 4 teacher-forced decode steps: the mesh's logits
    within rtol/atol 1e-5 of one process's."""
    got = ranks[f"{_tag(mesh, tag)}/logits"]
    want = one_process[tag][0]
    assert got.shape == want.shape == (1 + STEPS, SLOTS,
                                       case_config(arch, "").vocab_size)
    np.testing.assert_allclose(got, want, **CLOSE)


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_greedy_tokens_match_one_process(ranks, one_process, mesh, tag,
                                         arch, overrides):
    """The engine's greedy tokens (3 requests over 2 slots; Whisper's
    with encoder frames) equal one process's."""
    got = ranks[f"{_tag(mesh, tag)}/tokens"]
    np.testing.assert_array_equal(got, one_process[tag][1])
    assert got.shape == (N_REQ, MAX_NEW)


@pytest.mark.parametrize("mesh,tag,arch,overrides",
                         [c for c in CASES if c[2] in STATE])
def test_state_shards_are_the_heads(ranks, one_process, mesh, tag, arch,
                                    overrides):
    """After the teacher-forced steps each rank's ``ssm`` or ``wkv`` state
    (L, B, H, P, N) is the one process's state at its data rank's batch
    rows and its model rank's heads: a quarter or a half of the heads
    where they divide the axis, all of them where a head is split. The
    tolerance is rtol 1e-5 and an atol of 1e-5 of the state's largest
    entry: a state entry sums products of k and v over the prompt, so
    the f32 rounding of the earlier layers (summed in another order on
    the mesh) reaches it in proportion to the largest terms, not to the
    entry (an RWKV6 entry of 0.34 among entries of 12 moved by 1.5e-5)."""
    want = one_process[tag][2]
    heads = want.shape[2]
    close = dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    for r in range(4):
        dr, mr = ranks[f"{_tag(mesh, tag)}/coords/{r}"]
        got = ranks[f"{_tag(mesh, tag)}/state/{r}"]
        nb, nh = got.shape[1], got.shape[2]
        assert nb == SLOTS // mesh[0]
        assert nh == (heads // mesh[1] if heads % mesh[1] == 0 else heads)
        lo = mr * nh if nh < heads else 0
        np.testing.assert_allclose(
            got, want[:, dr * nb:(dr + 1) * nb, lo:lo + nh], **close)


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_hook_and_partials_run_where_they_should(ranks, mesh, tag, arch,
                                                 overrides):
    """Where the attention heads split (the ``_h6`` cases), prefill went
    through the sequence-parallel hook once a layer (Whisper's encoder
    layers too) and each decode step through #5's partials once an
    attention layer (the hybrid's shared-block applications); nowhere
    else."""
    seq, partials = ranks[f"{_tag(mesh, tag)}/calls"]
    cfg = case_config(arch, overrides)
    if cfg.num_kv_heads % mesh[1] == 0 or arch == "rwkv6-1.6b":
        assert (seq, partials) == (0, 0)
        return
    attn = (cfg.num_layers // cfg.shared_attn_period
            if arch == "zamba2-2.7b" else cfg.num_layers)
    enc = cfg.num_encoder_layers if arch == "whisper-base" else 0
    assert (seq, partials) == (attn + enc, attn * STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_weights_on_the_mesh(ranks, twins, arch):
    """The reference's weights, carried over by ``core.convert`` and
    placed on (1, 4) by ``ServingEngine(mesh=)``: teacher-forced logits
    within 1e-4 of the reference's own ``apply`` (Whisper's with the same
    encoder frames), and ``make_serve_step(mesh=)``'s greedy tokens after
    the teacher prefill the argmax of the reference's first decode
    step."""
    import jax.numpy as jnp
    jm, params, japply, _ = twins[arch]
    cfg = case_config(arch, "")
    tok, lens, fed, side = tserve.teacher_inputs(cfg, batch=SLOTS,
                                                 steps=STEPS)
    kw = {} if side is None else {"encoder_frames": jnp.asarray(side)}
    cache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
    logits, cache, _ = japply(params, jnp.asarray(tok), mode="prefill",
                              cache=cache, prompt_lengths=jnp.asarray(lens),
                              **kw)
    want = [np.asarray(logits[:, -1])]
    for t in range(STEPS):
        logits, cache, _ = japply(params, jnp.asarray(fed[t]), mode="decode",
                                  cache=cache)
        want.append(np.asarray(logits[:, -1]))
    np.testing.assert_allclose(ranks[f"ref/{arch}/logits"], np.stack(want),
                               **REF_CLOSE)
    np.testing.assert_array_equal(ranks[f"ref/{arch}/serve_tokens"],
                                  want[1].argmax(-1))


# ------------------------------------------------ Mamba2's gated norm


class _Rank:
    """A stand-in ``TensorParallel`` for one of ``size`` ranks whose
    all-reduce adds the other ranks' parts (``others``) to its own."""

    def __init__(self, rank, size, others):
        self.rank, self.size, self.others = rank, size, others

    def all_reduce(self, x):
        return x + self.others


@pytest.mark.parametrize("size", [2, 4])
def test_gated_norm_reduces_over_the_ranks(size):
    """``gated_norm`` of each rank's channels of y and z (and its slice of
    the scale) with the f32 sum of squares all-reduced gives the rank's
    channels of the one-process ``rms_norm(y * silu(z), scale)`` (rtol /
    atol 1e-6); a per-rank RMSNorm without the all-reduce does not."""
    import torch.nn.functional as F
    from repro_torch.models.layers import rms_norm
    g = torch.Generator().manual_seed(size)
    width = 64
    y, z = (torch.randn(2, 3, width, generator=g) for _ in range(2))
    # channels of unequal scale, so each rank's own norm differs
    y = y * torch.linspace(0.2, 3.0, width)
    scale = torch.rand(width, generator=g) + 0.5
    want = rms_norm(y * F.silu(z), scale, 1e-5)
    n = width // size
    sq = [((y * F.silu(z))[..., r * n:(r + 1) * n] ** 2).sum(-1, keepdim=True)
          for r in range(size)]
    for r in range(size):
        cols = slice(r * n, (r + 1) * n)
        tp = _Rank(r, size, sum(sq) - sq[r])
        got = tssm.gated_norm(y[..., cols], z[..., cols], scale[cols], 1e-5,
                              tp, width)
        torch.testing.assert_close(got, want[..., cols], rtol=1e-6,
                                   atol=1e-6)
        alone = rms_norm(y[..., cols] * F.silu(z[..., cols]), scale[cols],
                         1e-5)
        assert (alone - want[..., cols]).abs().max() > 1e-2
    # off the mesh, or with every channel on the rank: the plain norm
    torch.testing.assert_close(tssm.gated_norm(y, z, scale, 1e-5), want,
                               rtol=0, atol=0)


def test_mamba2_layer_of_split_heads(ranks):
    """The zamba2 case with 2 Mamba2 heads of 128 channels on (1, 4): the
    tables split ``in_x`` through a head (64 channels a rank) and leave
    ``in_dt`` and the ``ssm`` state whole, so each rank runs every head
    on gathered x and z; its state equals every other rank's."""
    tag = _tag((1, 4), "zamba2-2.7b_h6")
    cfg = case_config("zamba2-2.7b", EXTRA[0][2])
    assert cfg.ssm.num_heads(cfg.d_model) == 2
    states = [ranks[f"{tag}/state/{r}"] for r in range(4)]
    assert states[0].shape[2] == 2
    for s in states[1:]:
        np.testing.assert_array_equal(s, states[0])
