"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its depth
variants against the reference's, the extrapolated counts against a
full-depth meta count, the meta count against the same step run for
real, the MoE layer's routed work, the argument bytes and the CLI."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jregistry
from repro.launch import dryrun as jdryrun
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.specs import params_shape

HOST = make_abstract_mesh((1, 1), ("data", "model"))
TRAIN = ShapeSpec("train_4k", 32, 2, "train")


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke steps run one intra-op thread: the tier-1 run shares the
    cores among its workers, where spinning thread pools cost more than
    they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_depth_variants_match_reference(arch):
    a, b, s = dryrun.depth_variants(registry.get_config(arch))
    ja, jb, js = jdryrun.depth_variants(jregistry.get_config(arch))
    assert s == js
    for got, want in ((a, ja), (b, jb)):
        assert (got.num_layers, got.num_encoder_layers, got.layer_pattern) \
            == (want.num_layers, want.num_encoder_layers,
                want.layer_pattern)


def _deeper(arch):
    """The smoke config with a depth the variants must extrapolate to."""
    cfg = registry.get_smoke_config(arch)
    if cfg.family == "hybrid":
        p = cfg.shared_attn_period
        return cfg.replace(num_layers=4 * p,
                           layer_pattern=("M" * (p - 1) + "A") * 4)
    fd = cfg.moe.first_dense_layers if cfg.moe else 0
    return cfg.replace(num_layers=fd + 5)


@pytest.mark.parametrize("arch", ["deepseek-7b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_extrapolated_counts_equal_full_depth(arch):
    """Two shallow variants extrapolate the flops and the bytes accessed
    of a deeper model exactly (dense, MoE and hybrid)."""
    cfg = _deeper(arch)
    rec = dryrun.lower_combo(arch, TRAIN, mesh=HOST, cfg=cfg,
                             verbose=False)
    assert rec["depth_extrapolation_scale"] > 1
    full = dryrun.count_step(cfg, TRAIN)
    assert rec["flops_per_device"] == full["flops"] > 0
    assert rec["bytes_accessed_per_device"] == full["bytes"] > 0


def test_meta_count_equals_the_step_run_on_the_cpu():
    """The meta count of the smoke train step is what FlopCounterMode
    counts around the same step run for real."""
    from repro_torch.models.transformer import init_model
    from repro_torch.training import TrainHParams, adamw_init
    from repro_torch.training.trainer import make_train_step
    cfg = registry.get_smoke_config("deepseek-7b")
    model = init_model(cfg, seed=0, device="cpu")
    opt = adamw_init(dict(model.named_parameters()))
    rng = np.random.default_rng(0)
    tok = rng.integers(3, cfg.vocab_size, (TRAIN.global_batch,
                                           TRAIN.seq_len)).astype(np.int32)
    step = make_train_step(cfg, TrainHParams(remat=True))
    with FlopCounterMode(display=False) as fc:
        step(model, opt, {"tokens": tok, "labels": tok}, 0)
    assert dryrun.count_step(cfg, TRAIN)["flops"] == fc.get_total_flops() > 0


def test_moe_flops_are_the_routed_work():
    """An OLMoE layer counts the router, 2·(T·k)·d·ff for each of its
    three expert products and the shared experts, not E/k times that."""
    from repro_torch.models import moe as moe_mod
    cfg = registry.get_config("olmoe-1b-7b")
    model = params_shape(cfg.replace(num_layers=1))
    p = model.blocks[0].moe
    b, s = 2, 256
    x = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    with FlopCounterMode(display=False) as fc:
        moe_mod.moe_apply(p, cfg, x)
    mc, t, d = cfg.moe, b * s, cfg.d_model
    want = (2 * t * d * mc.num_experts
            + 3 * 2 * (t * mc.experts_per_token) * d * mc.d_ff
            + (3 * 2 * t * d * mc.shared_d_ff if mc.num_shared_experts
               else 0))
    assert fc.get_total_flops() == want


def test_argument_bytes_are_the_leaves_bytes():
    """On a (1, 1) mesh the train step's argument bytes are its
    parameters', its AdamW state's and its batch's bytes."""
    from repro_torch.launch.specs import input_specs
    from repro_torch.training import adamw_init
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    rec = dryrun.lower_combo("olmoe-1b-7b", TRAIN, mesh=HOST, cfg=cfg,
                             verbose=False)
    model = params_shape(cfg)
    params = list(model.parameters())
    opt = adamw_init(dict(model.named_parameters()))
    batch = input_specs(cfg, TRAIN)["batch"]
    leaves = (params + [opt.count] + list(opt.mu.values())
              + list(opt.nu.values()) + list(batch.values()))
    want = sum(t.numel() * t.element_size() for t in leaves)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["fits"] and rec["roofline_s"] > 0
    assert rec["collective_bytes_per_device"]["all-gather"] == \
        2 * sum(p.numel() * p.element_size() for p in params)


def test_cli_writes_one_json_per_combo(tmp_path):
    out = str(tmp_path)
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--out", out])
    dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                 "--out", out])
    with open(os.path.join(out, "whisper-base_decode_32k_16x16.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0 and rec["bytes_min_per_device"] > 0
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    with open(os.path.join(out, "whisper-base_long_500k_16x16.json")) as f:
        assert json.load(f)["status"] == "skipped"
