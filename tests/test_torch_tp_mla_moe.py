"""Serving the MLA and MoE decoders on the model axis on the CPU: four
gloo processes under one ``torchrun --standalone`` place the smoke
minicpm3-4b (MLA with a q LoRA, tied embeddings), deepseek-v2-lite-16b
(MLA without one, a dense first layer, then MoE with a shared expert) and
olmoe-1b-7b (GQA with QK-norm, MoE) on ``("data", "model")`` meshes of
(2, 2) and (1, 4) and serve them, in float32 activations and caches; this
process holds what they wrote against the reference's tables, against
the port in one process and against the reference's own ``apply``.

The heads divide the model axis in every smoke case: each rank keeps its
heads of q, k_nope and v (a replicated ``w_q`` sliced), its 1 or 2 of
the 4 experts and its columns of the shared expert. The latent cache
splits by its sequence whatever the heads, so each MLA decode step
gathers every rank's absorbed queries, runs #6's partials (their plain
version here) on the rank's rows and merges all ranks' partials. Two more
cases on (1, 4): minicpm3-4b with 6 heads, whose ``w_uq``/``w_uk``/
``w_uv`` split through a head, so prefill goes through the
sequence-parallel hook; deepseek-v2-lite-16b at capacity factor 1.0,
where pairs are dropped (identically on every rank: the routing is
global). Logits within rtol/atol 1e-5 of one process, greedy tokens
equal; the reference's weights carried over by ``core.convert`` give the
reference's logits within 1e-4.

Also here, in this process: the plain partials of #6 over 1, 3 and 4
sequence shards, merged, against the unsharded plain version and the
reference's ``mla_decode_attention``; and the expert-parallel MoE layer
of 1, 2 and 4 ranks, simulated by summing each rank's partial, against
the reference's ``moe_apply``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.params import meta_model
from repro_torch.models.transformer import init_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b", "olmoe-1b-7b")
MESHES = ((2, 2), (1, 4))
# (tag, arch, config overrides as "key=value" words, mesh)
EXTRA = (("minicpm3-4b_h6", "minicpm3-4b", "num_heads=6 num_kv_heads=6",
          (1, 4)),
         ("deepseek-v2-lite-16b_cf1", "deepseek-v2-lite-16b",
          "capacity_factor=1.0", (1, 4)))
CASES = ([(m, a, a, "") for m in MESHES for a in ARCHS]
         + [(m, t, a, o) for t, a, o, m in EXTRA])
TWINS = ("deepseek-v2-lite-16b", "minicpm3-4b")
SLOTS, MAX_LEN, STEPS = 2, 64, 4
CLOSE = dict(rtol=1e-5, atol=1e-5)
REF_CLOSE = dict(rtol=1e-4, atol=1e-4)
N_REQ, MAX_NEW = 3, 4

# Shared by the ranks and this process: a smoke config in f32 with the
# overrides of a case.
CONFIG = r'''
def case_config(arch, overrides):
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch).replace(dtype="float32")
    kw = dict(w.split("=") for w in overrides.split())
    if "capacity_factor" in kw:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(kw.pop("capacity_factor"))))
    return cfg.replace(**{k: int(v) for k, v in kw.items()})
'''
exec(CONFIG)

# Each rank: every case from seed 0 (``init_model(mesh=)``), its
# placements, teacher-forced logits, the engine's greedy tokens, and the
# calls into the sequence-parallel hook and the decode kernels' partials;
# then the reference's weights (``<arch>.pt``) on (1, 4). Rank 0 writes
# one npz.
SCRIPT = CONFIG + r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_ranks, make_abstract_mesh, \
    to_device_mesh
from repro_torch.launch import serve
from repro_torch.launch.sharding import is_placed
from repro_torch.models import attention as A
from repro_torch.models.transformer import Transformer, init_model
from repro_torch.serving.engine import Request, ServingEngine

out, tmp = sys.argv[1], sys.argv[2]
SLOTS, MAX_LEN, STEPS, N_REQ, MAX_NEW = (int(a) for a in sys.argv[3:8])
cases = [c.split("|") for c in sys.argv[8].split(";")]
twins = sys.argv[9].split(",")
torch.set_num_threads(1)
init_ranks("cpu")
rank = dist.get_rank()
calls = {"seq_shard": 0, "gqa_partials": 0, "mla_partials": 0}
hook, gqa, mla = (A._seq_shard, ops.decode_attention,
                  ops.mla_decode_attention)


def seq_shard(q, k, v, tp):
    calls["seq_shard"] += 1
    return hook(q, k, v, tp)


def decode_attention(*a, partials=False, **kw):
    calls["gqa_partials"] += partials
    return gqa(*a, partials=partials, **kw)


def mla_decode_attention(*a, partials=False, **kw):
    calls["mla_partials"] += partials
    return mla(*a, partials=partials, **kw)


A._seq_shard = seq_shard
A.kops.decode_attention = decode_attention
A.kops.mla_decode_attention = mla_decode_attention


def requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(rid=i, tokens=rng.integers(3, cfg.vocab_size, size=int(
        rng.integers(8, 40))), max_new_tokens=MAX_NEW) for i in range(N_REQ)]


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
    model = init_model(cfg, seed=0, device="cpu", mesh=mesh_of(mesh))
    for name, p in model.named_parameters():
        assert is_placed(p), name
        res[f"{tag}/param/{name}"] = str(tuple(p.placements))
    for name, pl in placements(model.init_cache(SLOTS, MAX_LEN)).items():
        res[f"{tag}/cache/{name}"] = pl
    calls.update(seq_shard=0, gqa_partials=0, mla_partials=0)
    _, _, logits = serve.teacher_forced(model, cfg, batch=SLOTS,
                                        max_len=MAX_LEN, steps=STEPS)
    res[f"{tag}/logits"] = logits
    res[f"{tag}/calls"] = np.array([calls["seq_shard"],
                                    calls["gqa_partials"],
                                    calls["mla_partials"]])
    done = ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                         cache_dtype=torch.float32).run(requests(cfg))
    res[f"{tag}/tokens"] = np.array([r.generated for r in done])

# the reference's weights, placed on (1, 4) by ServingEngine(mesh=)
for arch in twins:
    cfg = case_config(arch, "")
    model = Transformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(f"{tmp}/{arch}.pt"))
    ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                  cache_dtype=torch.float32, mesh=mesh_of((1, 4)))
    _, _, logits = serve.teacher_forced(model, cfg, batch=SLOTS,
                                        max_len=MAX_LEN, steps=STEPS)
    res[f"ref/{arch}/logits"] = logits
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
    """Per arch of ``TWINS``: the reference's smoke model (key 0), its
    params, its jitted ``apply``, and the same weights as the port's state
    dict."""
    import jax
    from repro.configs import registry as jregistry
    from repro.models.transformer import Transformer as JTransformer
    from repro_torch.core.convert import model_params_from_numpy
    out = {}
    for arch in TWINS:
        jcfg = jregistry.get_smoke_config(arch).replace(dtype="float32")
        jm = JTransformer(jcfg)
        params = jm.init(jax.random.key(0))
        state = model_params_from_numpy(case_config(arch, ""),
                                        jax.tree.map(np.asarray, params))
        out[arch] = (jm, params, jax.jit(jm.apply, static_argnames=("mode",
                                                                    )), state)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, twins):
    """One ``torchrun --standalone`` of 4 gloo processes → its npz."""
    tmp = tmp_path_factory.mktemp("tp_mla_moe")
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
         ",".join(TWINS)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "[ranks] world 4, backend gloo" in run.stdout
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_process():
    """The port in one process: per case, teacher-forced logits, the
    engine's greedy tokens (the same seeds and requests as the ranks) and
    the pairs the MoE layers dropped."""
    from repro_torch.serving.engine import Request, ServingEngine
    out = {}
    route, dropped = tmoe.route, []

    def spy(*a, **kw):
        r = route(*a, **kw)
        dropped.append(int((~r.keep).sum()))
        return r
    tmoe.route = spy
    try:
        for _, tag, arch, overrides in CASES:
            if tag in out:
                continue
            cfg = case_config(arch, overrides)
            model = init_model(cfg, seed=0, device="cpu")
            dropped.clear()
            _, _, logits = tserve.teacher_forced(
                model, cfg, batch=SLOTS, max_len=MAX_LEN, steps=STEPS)
            rng = np.random.default_rng(0)
            reqs = [Request(rid=i, tokens=rng.integers(
                3, cfg.vocab_size, size=int(rng.integers(8, 40))),
                max_new_tokens=MAX_NEW) for i in range(N_REQ)]
            done = ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                                 cache_dtype=torch.float32).run(reqs)
            out[tag] = (logits, np.array([r.generated for r in done]),
                        sum(dropped))
    finally:
        tmoe.route = route
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
    mode="serve"))`` of the reference's tables, leaf for leaf: MLA's
    up-projections by their columns (through a head at 6 heads on 4),
    DeepSeek-V2-Lite's ``w_q`` replicated, the experts by E, the shared
    expert by its hidden columns, the router replicated."""
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
    last = f"blocks.{cfg.num_layers - 1}"
    if cfg.moe is not None:
        assert specs[f"{last}.moe.w_gate"] == shd.P("model", None, None)
        assert specs[f"{last}.moe.router"] == shd.P(None, None)
    if cfg.moe is not None and cfg.moe.num_shared_experts:
        assert specs[f"{last}.moe.shared.w_up"] == shd.P(None, "model")
        assert specs[f"{last}.moe.shared.w_down"] == shd.P("model", None)
    if cfg.attn_type == "mla":
        assert specs["blocks.0.attn.w_uk"] == shd.P(None, "model")
        if not cfg.mla.q_lora_rank:
            assert specs["blocks.0.attn.w_q"] == shd.P()
    if tag == "minicpm3-4b_h6":
        width = model.blocks[0].attn["w_uq"].shape[1] // mesh[1]
        assert width % cfg.mla.qk_head_dim


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_cache_placed_by_the_tables(ranks, mesh, tag, arch, overrides):
    """Every cache leaf's placements are ``cache_specs``': the latent
    ckv/krope by their sequence over ``model`` on both meshes, OLMoE's k/v
    by their heads; the batch over ``data``."""
    model = meta_model(case_config(arch, overrides))
    cache = model._cache_tree(SLOTS, MAX_LEN, torch.float32, "meta")
    want = {}
    _walk(cache, shd.cache_specs(cache, make_abstract_mesh(
        mesh, ("data", "model"))), want)
    got = {k.split("/cache/")[1]: str(v) for k, v in ranks.items()
           if k.startswith(f"{_tag(mesh, tag)}/cache/")}
    assert got == want
    group = "dense" if arch == "minicpm3-4b" else "moe"
    leaf = "k" if arch == "olmoe-1b-7b" else "ckv"
    assert got[f"{group}/{leaf}"] == ("(Shard(dim=1), Shard(dim=3))"
                                      if leaf == "k" else
                                      "(Shard(dim=1), Shard(dim=2))")


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
    """The engine's greedy tokens (3 requests over 2 slots) equal one
    process's."""
    got = ranks[f"{_tag(mesh, tag)}/tokens"]
    np.testing.assert_array_equal(got, one_process[tag][1])
    assert got.shape == (N_REQ, MAX_NEW)


@pytest.mark.parametrize("mesh,tag,arch,overrides", CASES)
def test_hook_and_partials_run_where_they_should(ranks, mesh, tag, arch,
                                                 overrides):
    """The teacher-forced run went through #6's partials once a layer a
    decode step on every MLA case (the latent cache is split by its
    sequence on both meshes), through the sequence-parallel hook once a
    layer at prefill only where the heads do not divide the axis, and
    never through #5's partials (OLMoE's KV heads divide it)."""
    seq, gqa, mla = ranks[f"{_tag(mesh, tag)}/calls"]
    cfg = case_config(arch, overrides)
    layers = cfg.num_layers
    is_mla = cfg.attn_type == "mla"
    assert mla == (layers * STEPS if is_mla else 0)
    assert gqa == 0
    assert seq == (layers if cfg.num_heads % mesh[1] else 0)


def test_capacity_case_drops_pairs(one_process):
    """The capacity-factor-1.0 case drops pairs (the smoke config's 2.0 =
    E/k drops none), so the mesh's equal logits cover dropped pairs."""
    assert one_process["deepseek-v2-lite-16b_cf1"][2] > 0
    assert one_process["deepseek-v2-lite-16b"][2] == 0


@pytest.mark.parametrize("arch", TWINS)
def test_reference_weights_on_the_mesh(ranks, twins, arch):
    """The reference's weights, carried over by ``core.convert`` and
    placed on (1, 4) by ``ServingEngine(mesh=)``: teacher-forced logits
    within 1e-4 of the reference's own ``apply``."""
    import jax.numpy as jnp
    jm, params, japply, _ = twins[arch]
    cfg = case_config(arch, "")
    tok, lens, fed, _ = tserve.teacher_inputs(cfg, batch=SLOTS, steps=STEPS)
    cache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
    logits, cache, _ = japply(params, jnp.asarray(tok), mode="prefill",
                              cache=cache, prompt_lengths=jnp.asarray(lens))
    want = [np.asarray(logits[:, -1])]
    for t in range(STEPS):
        logits, cache, _ = japply(params, jnp.asarray(fed[t]), mode="decode",
                                  cache=cache)
        want.append(np.asarray(logits[:, -1]))
    np.testing.assert_allclose(ranks[f"ref/{arch}/logits"], np.stack(want),
                               **REF_CLOSE)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_family_check(arch):
    """Every arch of the registry passes the family check, at smoke and
    full size: each serves on the model axis."""
    shd.check_tp_family(get_smoke_config(arch))
    shd.check_tp_family(get_config(arch))


# ------------------------------------------------ plain #6 partials


def _mla_case(seed, b=3, c=96, h=6, r=32, dr=16):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g) for s in
                 ((b, 1, h, r), (b, 1, h, dr), (b, c, r), (b, c, dr)))


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_mla_partials_of_shards_merge_to_the_reference(shards):
    """The plain ``mla_decode(..., partials=True)`` of each sequence shard,
    merged in rank order by ``merge_partials``, gives the unsharded plain
    version and the reference's ``mla_decode_attention`` (rtol 1e-5 /
    atol 1e-6) — with a sequence whose valid rows all lie in the first
    shard, so later shards have none (the empty part), and one with every
    row valid. A sequence with no valid row gives the mean of ckv through
    the unsharded call, as the reference does; its shards' empty parts
    merge to 0 (decode never has one)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    qa, qr, ckv, kr = _mla_case(shards)
    b, c = ckv.shape[:2]
    valid = torch.arange(c)[None] < torch.tensor([0, 20, c])[:, None]
    scale = 0.21
    whole = tdecode.mla_decode(qa, qr, ckv, kr, valid, scale=scale)
    jwant = np.asarray(jops.mla_decode_attention(
        *(jnp.asarray(x.numpy()) for x in (qa, qr, ckv, kr, valid)),
        scale=scale))
    np.testing.assert_allclose(whole.numpy(), jwant, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(whole[0, 0], ckv[0].mean(0).expand(6, 32),
                               rtol=1e-5, atol=1e-6)
    n = -(-c // shards)
    parts = [tdecode.mla_decode(qa, qr, ckv[:, i:i + n], kr[:, i:i + n],
                                valid[:, i:i + n], scale=scale,
                                partials=True) for i in range(0, c, n)]
    for m, l, acc in parts:
        assert m.shape == l.shape == (b, 6, 1) and acc.shape == (b, 6, 1, 32)
    if shards > 1:
        m, l, acc = parts[-1]       # sequence 1's rows all lie in shard 0
        assert torch.all(m[:2] == -1e30) and torch.all(l[:2] == 0)
        assert torch.all(acc[:2] == 0)
    m, l, acc = (torch.cat([p[i] for p in parts], dim=2) for i in range(3))
    got = tdecode.merge_partials(m, l, acc, torch.float32)
    np.testing.assert_allclose(got[1:].numpy(), jwant[1:], rtol=1e-5,
                               atol=1e-6)
    assert torch.all(got[0] == 0)
    assert tdecode.mla_decode.launches == tdecode.merge_partials.launches == 0


# ------------------------------------------------ the expert-parallel layer


class _Rank:
    """A stand-in ``TensorParallel`` for rank ``rank`` of ``size`` whose
    all-reduce returns this rank's own partial: the ranks' outputs,
    summed here, are the layer's."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    @staticmethod
    def all_reduce(x):
        return x


def _rank_shards(p, rank, size):
    """Rank ``rank``'s shards of an MoE layer's tree, as the tables split
    it: the experts by E, the shared expert's w_gate/w_up by columns and
    its w_down by rows; the router whole."""
    def part(w, dim):
        n = w.shape[dim] // size
        return w.narrow(dim, rank * n, n)
    out = {"router": p["router"]}
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = part(p[k], 0)
    if "shared" in p:
        sh = p["shared"]
        out["shared"] = {"w_gate": part(sh["w_gate"], 1),
                         "w_up": part(sh["w_up"], 1),
                         "w_down": part(sh["w_down"], 0)}
    return out


@pytest.mark.parametrize("cf", [1.0, 2.0])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_expert_parallel_layer_matches_the_reference(size, cf):
    """Each of R ranks runs its own experts (and its columns of the shared
    expert) on the global routing; their partials, summed, give the
    reference's ``moe_apply`` (rtol/atol 1e-5), which drops pairs at
    capacity factor 1.0 (2.0 = E/k drops none). A rank no kept pair
    reached adds exactly 0."""
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import moe as jmoe
    from repro_torch.configs.base import MoEConfig, ModelConfig
    mc = dict(num_experts=8, experts_per_token=4, d_ff=48,
              num_shared_experts=1, shared_d_ff=40, capacity_factor=cf)
    kw = dict(name="moe-ep", family="moe", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
              vocab_size=96, dtype="float32")
    jcfg = JModelConfig(**kw, moe=JMoEConfig(**mc))
    cfg = ModelConfig(**kw, moe=MoEConfig(**mc))
    g = torch.Generator().manual_seed(size)
    p = tmoe.moe_init(g, cfg)
    x = torch.randn(2, 16, 32, generator=g)
    jp = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else
              {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()})
          for k, v in p.items()}
    want, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x.numpy()))
    r = tmoe.route(p, cfg, x, tmoe.chunk_size(16))
    assert bool((~r.keep).any()) == (cf == 1.0)
    parts = [tmoe.moe_apply(_rank_shards(p, k, size), cfg, x,
                            tp=_Rank(k, size) if size > 1 else None)[0]
             for k in range(size)]
    np.testing.assert_allclose(sum(parts).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # a rank whose experts no kept pair reached: its expert part is 0
    none = tmoe.Routing(r.top_i, r.top_w, torch.zeros_like(r.keep), r.aux,
                        r.probs)
    zero = tmoe._experts(_rank_shards(p, 0, size), cfg, x, none)
    assert torch.equal(zero, torch.zeros_like(zero))
