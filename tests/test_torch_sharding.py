"""The port's rule tables (``repro_torch.launch.sharding``) held to the
reference's (``repro.launch.sharding``) on the abstract production
meshes, with no device and no process group: the twins of
``tests/test_sharding.py``, every arch × mode × mesh leaf for leaf,
``adapt_config`` and ``input_specs`` shape for shape, and the
sequence-parallel hook's default; the hook's placements are checked on
a world of one gloo rank."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import get_shape as jget_shape
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.launch.mesh import make_abstract_mesh as jmake_abstract_mesh
from repro.training.optim import adamw_init as jadamw_init
from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, get_shape
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (make_abstract_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import adapt_config, input_specs, params_shape
from repro_torch.models import attention as A
from repro_torch.models.params import reference_path
from repro_torch.training.optim import adamw_init
from jax.sharding import PartitionSpec as JP

P = shd.P
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(multi=False):
    return make_production_mesh(multi_pod=multi)


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return params_shape(registry.get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jspecs.params_shape(jregistry.get_config(arch))


def is_stacked(name):
    """Whether the reference stacks the leaf of port parameter ``name``
    over layers (every block group's; the hybrid's shared block is one
    block in both packages)."""
    return name.split(".")[0] in ("blocks", "enc_blocks")


def _ref_leaves(tree):
    """{reference path: leaf} of a reference tree."""
    return {jshd.path_str(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


# ----------------------------------------------------- twins of test_sharding


def test_attention_tp_fsdp_layout():
    specs = shd.param_specs(_port_model("glm4-9b"), _mesh(), mode="train")
    assert specs["blocks.0.attn.wq"] == P(("data",), "model")   # (d, H·hd)
    assert specs["blocks.0.attn.wo"] == P("model", ("data",))
    assert specs["embed"] == P("model", None)


def test_serve_mode_drops_fsdp():
    specs = shd.param_specs(_port_model("glm4-9b"), _mesh(), mode="serve")
    assert specs["blocks.0.attn.wq"] == P(None, "model")


def test_moe_expert_parallel():
    model = _port_model("olmoe-1b-7b")
    specs = shd.param_specs(model, _mesh(), mode="train")
    assert specs[f"blocks.{model.n_dense}.moe.w_gate"] == \
        P("model", ("data",), None)                              # (E, d, ff)


def test_nondivisible_vocab_falls_back():
    specs = shd.param_specs(_port_model("whisper-base"), _mesh(),
                            mode="train")                       # vocab 51865
    assert specs["embed"] == P(None, None)


def test_multipod_fsdp_spans_pod_and_data():
    specs = shd.param_specs(_port_model("deepseek-7b"), _mesh(multi=True),
                            mode="train")
    assert specs["blocks.0.attn.wq"] == P(("pod", "data"), "model")


def test_kv_cache_head_vs_sequence_sharding():
    shape = get_shape("decode_32k")
    # glm4: kv = 2 < 16 ⇒ sequence sharding
    cfg = adapt_config(registry.get_config("glm4-9b"), shape)
    specs = shd.cache_specs(input_specs(cfg, shape)["cache"], _mesh())
    assert specs["dense"]["k"] == P(None, ("data",), "model", None, None)
    # deepseek-7b: kv = 32 ⇒ head sharding
    cfg = adapt_config(registry.get_config("deepseek-7b"), shape)
    specs = shd.cache_specs(input_specs(cfg, shape)["cache"], _mesh())
    assert specs["dense"]["k"] == P(None, ("data",), None, "model", None)


def test_long500k_policy():
    shape = get_shape("long_500k")
    cfg = adapt_config(registry.get_config("deepseek-7b"), shape)
    assert cfg.sliding_window == 8192
    cfg = adapt_config(registry.get_config("deepseek-v2-lite-16b"), shape)
    assert cfg.sliding_window == 0
    cache = input_specs(cfg, shape)["cache"]
    assert cache["moe"]["ckv"].shape[2] == shape.seq_len
    assert cache["moe"]["ckv"].device.type == "meta"
    cfg = adapt_config(registry.get_config("rwkv6-1.6b"), shape)
    assert cfg.sliding_window == 0


def test_batch_specs_long500k_batch1_replicated():
    tok = torch.empty((1, 1), dtype=torch.int32, device="meta")
    assert shd.batch_specs(tok, _mesh()) == P(None, None)


def test_serve_step_dry_runs_on_host_mesh():
    """The serve step of the smoke Qwen2-VL on a (1, 1) host mesh: a spec
    for every parameter and cache leaf, and the dry run of its decode
    step counts work."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import lower_combo
    cfg = registry.get_smoke_config("qwen2-vl-7b")
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    model = params_shape(cfg)
    cache = model.init_cache(4, 64, torch.bfloat16, device="meta")
    pspec = shd.param_specs(model, mesh, mode="serve")
    assert set(pspec) == {n for n, _ in model.named_parameters()}
    cspec = shd.cache_specs(cache, mesh)
    leaves = jax.tree_util.tree_leaves(cache)
    cleaves = jax.tree_util.tree_leaves(
        cspec, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(cleaves) and all(
        isinstance(s, P) for s in cleaves)
    rec = lower_combo("qwen2-vl-7b", ShapeSpec("decode_32k", 64, 4,
                                               "decode"),
                      mesh=mesh, cfg=cfg, verbose=False)
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0


# ------------------------------------------------------- table for table


def _same(port_spec, ref_spec, what):
    assert tuple(port_spec) == tuple(ref_spec), \
        f"{what}: port {port_spec} != reference {ref_spec}"


@functools.lru_cache(maxsize=None)
def _caches(arch, name):
    """(the port's meta cache, the reference's abstract cache)."""
    shape, jshape = get_shape(name), jget_shape(name)
    cache = input_specs(adapt_config(registry.get_config(arch), shape),
                        shape)["cache"]
    jcache = jspecs.input_specs(
        jspecs.adapt_config(jregistry.get_config(arch), jshape),
        jshape)["cache"]
    return cache, jcache


def _cache_pairs(arch, mesh, jmesh):
    for name in ("decode_32k", "long_500k"):
        if jregistry.combo_is_skipped(arch, name):
            continue
        cache, jcache = _caches(arch, name)
        yield (name, shd.cache_specs(cache, mesh),
               jshd.cache_specs(jcache, jmesh))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", ["train", "train_zero3", "serve"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_rule_tables_match_reference(arch, mode, mesh_name):
    """Every parameter's spec is the reference's spec of its leaf (less
    the leading layer None of a stacked leaf); ``opt_specs`` follows
    them; in serve mode every cache leaf's spec of decode_32k and
    long_500k, and the train batch's, equal the reference's path for
    path."""
    shape_, axes = MESHES[mesh_name]
    mesh, jmesh = make_abstract_mesh(shape_, axes), jmake_abstract_mesh(
        shape_, axes)
    model = _port_model(arch)
    specs = shd.param_specs(model, mesh, mode=mode)
    jparams = _ref_params(arch)
    jspec = _ref_leaves(jshd.param_specs(jparams, jmesh, mode=mode))
    jleaf = _ref_leaves(jparams)
    seen = set()
    for name, p in model.named_parameters():
        path = reference_path(model, name)
        seen.add(path)
        ref = jspec[path].spec
        ref = tuple(ref) + (None,) * (len(jleaf[path].shape) - len(ref))
        if is_stacked(name):
            assert jleaf[path].shape[1:] == tuple(p.shape), name
            assert ref[0] is None, name
            ref = ref[1:]
        else:
            assert jleaf[path].shape == tuple(p.shape), name
        port = tuple(specs[name]) + (None,) * (p.dim() - len(specs[name]))
        _same(port, ref, f"{arch} {mode} {name}")
    assert seen == set(jleaf)
    opt = shd.opt_specs(adamw_init(dict(model.named_parameters())), specs)
    jopt = jshd.opt_specs(jax.eval_shape(jadamw_init, jparams),
                          jshd.param_specs(jparams, jmesh, mode=mode))
    _same(opt.count, jopt.count.spec, "count")
    assert opt.mu == specs and opt.nu == specs
    if mode != "serve":
        return
    for name, got, want in _cache_pairs(arch, mesh, jmesh):
        want = _ref_leaves(want)
        got = {jshd.path_str(p): s for p, s in
               jax.tree_util.tree_leaves_with_path(
                   got, is_leaf=lambda x: isinstance(x, P))}
        assert set(got) == set(want), name
        for path, s in got.items():
            _same(s, want[path].spec, f"{arch} {name} cache {path}")
    shape = get_shape("train_4k")
    batch = input_specs(registry.get_config(arch), shape)["batch"]
    jbatch = jspecs.input_specs(jregistry.get_config(arch),
                                jget_shape("train_4k"))["batch"]
    got = shd.batch_specs(batch, mesh)
    want = jshd.batch_specs(jbatch, jmesh)
    assert set(got) == set(want)
    for k in got:
        _same(got[k], want[k].spec, f"{arch} batch {k}")


_JDTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
            torch.float32: jnp.float32}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_adapt_config_and_input_specs_match_reference(arch):
    """For every shape: the adapted config's window and length, and each
    meta input's shape and dtype, leaf for leaf."""
    for name in sorted(INPUT_SHAPES):
        if registry.combo_is_skipped(arch, name):
            assert jregistry.combo_is_skipped(arch, name)
            continue
        shape, jshape = get_shape(name), jget_shape(name)
        cfg = adapt_config(registry.get_config(arch), shape)
        jcfg = jspecs.adapt_config(jregistry.get_config(arch), jshape)
        assert (cfg.sliding_window, cfg.max_seq_len) == \
            (jcfg.sliding_window, jcfg.max_seq_len), name
        got = jax.tree_util.tree_leaves_with_path(input_specs(cfg, shape))
        want = dict(jax.tree_util.tree_leaves_with_path(
            jspecs.input_specs(jcfg, jshape)))
        want = {jshd.path_str(p): v for p, v in want.items()}
        got = {jshd.path_str(p): v for p, v in got}
        assert set(got) == set(want), name
        for path, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[path].shape, (name, path)
            assert np.dtype(_JDTYPES[t.dtype]) == want[path].dtype, \
                (name, path)


def test_combo_skips_match_reference():
    assert registry.SKIPPED_COMBOS == jregistry.SKIPPED_COMBOS
    for arch in registry.ARCH_IDS:
        for name in INPUT_SHAPES:
            assert registry.combo_is_skipped(arch, name) == \
                jregistry.combo_is_skipped(arch, name)


def test_spec_class_equals_partition_spec_entrywise():
    """``P`` keeps entries as ``jax.sharding.PartitionSpec`` does: a
    one-axis tuple is that axis."""
    for entries in [(None, ("data",), "model"), (("pod", "data"), None),
                    ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P("a") == P(("a",)) and P("a") != P("b")
    assert hash(P(None, "model")) == hash(P(None, "model"))


def test_abstract_mesh_places_nothing():
    from repro_torch.launch.sharding import slab_devices
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.devices is None and mesh.size == 512
    with pytest.raises(ValueError, match="abstract"):
        slab_devices(mesh)
    with pytest.raises(RuntimeError, match="process group"):
        from repro_torch.launch.mesh import to_device_mesh
        to_device_mesh(make_abstract_mesh((1, 1), ("data", "model")), "cpu")


def test_to_placements_over_a_device_mesh():
    """A spec's DTensor placements: ``Shard(d)`` on each mesh dim its
    tensor dim names (two for ``("pod", "data")``), else
    ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:            # to_placements reads only the dim names
        mesh_dim_names = ("pod", "data", "model")
    got = shd.to_placements(P(("pod", "data"), "model"), FakeMesh())
    assert got == [Shard(0), Shard(0), Shard(1)]
    assert shd.to_placements(P(None, "model"), FakeMesh()) == \
        [Replicate(), Replicate(), Shard(1)]
    assert shd.to_placements(P(), FakeMesh()) == [Replicate()] * 3


# ------------------------------------------------- sequence-parallel hook


class _ModelRank:
    """A stand-in for a model's ``TensorParallel``: its model rank and
    axis size, and its sequence bounds (all the hook reads)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    seq_bounds = shd.TensorParallel.seq_bounds


@pytest.mark.parametrize("rank,size,s", [(0, 1, 4), (1, 4, 14), (3, 4, 9)],
                         ids=["world_of_one", "middle_rank", "empty_rank"])
def test_seq_parallel_hook_gives_the_rank_rows(rank, size, s):
    """The hook on plain tensors: q's rows [lo, hi) of this model rank
    (chunks of ceil(S / R), the last shorter or empty; a world of one
    keeps them all), k and v themselves; the ranks' rows, in rank order,
    are q's sequence."""
    g = torch.Generator().manual_seed(rank)
    q, k, v = (torch.randn(2, s, 4, 8, generator=g) for _ in range(3))
    qr, kr, vr = A._seq_shard(q, k, v, _ModelRank(rank, size))
    lo, hi = _ModelRank(rank, size).seq_bounds(s)
    assert kr is k and vr is v
    assert qr.shape == (2, hi - lo, 4, 8) and torch.equal(qr, q[:, lo:hi])
    rows = [A._seq_shard(q, k, v, _ModelRank(r, size))[0]
            for r in range(size)]
    assert torch.equal(torch.cat(rows, 1), q)
