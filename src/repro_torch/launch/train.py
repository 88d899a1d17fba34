"""Training launcher of the port: ``--arch <id>`` selects any of the
reference's ten archs, trained on the synthetic LM stream
(``data.text.lm_batches``) from random weights (seed 0), with the
reference's flags; the VLM and audio families get zero stub embeddings,
as in the reference's launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --steps 20 --batch 4 --seq 128 [--full] [--layers N] \\
      [--dtype float32] [--remat] [--ckpt out/ck] [--device cpu]

Runs on the CUDA device unless ``--device`` names another one. Without
``--full`` the arch's smoke config; ``--full`` takes the published
config on one card, which holds only what fits: f32 parameters,
gradients and two AdamW moments are 16 bytes a parameter (deepseek-7b in
full: ≈ 110 GB). ``--layers`` cuts the depth (the widths kept),
``--dtype`` sets the activations' dtype (the config's by default).
``--ckpt`` writes the parameters and the AdamW state in the reference's
checkpoint format (``training.checkpoint``), which the reference's
``restore`` reads.

Started alone it trains in one process, with no mesh. Under
``torchrun --nproc-per-node W`` (the world size in the environment)
with ``--model K`` it trains on a (W / K, K) ``("data", "model")``
mesh, the reference's ``param_specs(mode="train")``: the model placed
on the model axis (``init_model(mesh=, mode="train")``: heads, FFN
columns, experts, vocabulary over ``model``), then FSDP2 over ``data``
(``fsdp_shard``), then ``make_train_step(mesh=)``. ``--model`` 0 or 1
is the (W, 1) mesh of FSDP2 alone, the reference's
``make_host_mesh()``. The ranks join by ``launch.mesh.init_ranks``:
NCCL with a card a rank, gloo where ranks share a card or with
``--device cpu``. Each data rank takes its rows of the global batch
(``batch_specs``; the model ranks of a data rank the same rows); the
printed loss and accuracy are means over ``data``, printed by rank 0;
``--ckpt`` gathers every shard (``full_tensor``) and rank 0 writes:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch deepseek-7b --model 2 --steps 3 --batch 4 --seq 32 \
      --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.data.text import lm_batches
from repro_torch.launch.mesh import (init_ranks, make_abstract_mesh,
                                     to_device_mesh)
from repro_torch.launch.sharding import batch_specs, spec_axes
from repro_torch.models.transformer import init_model
from repro_torch.training import TrainHParams, adamw_init, make_train_step
from repro_torch.training import checkpoint as ckpt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: smoke)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="",
                    help="the activations' dtype (default: the config's)")
    ap.add_argument("--model", type=int, default=0,
                    help="model-axis size K under torchrun (default 1: "
                         "FSDP2 alone on a (world, 1) mesh)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(
        args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    world = int(os.environ.get("WORLD_SIZE", "0"))
    k = max(args.model, 1)
    mesh = dmesh = None
    rank, device = 0, args.device
    if world:
        if world % k:
            raise SystemExit(f"--model {k} does not divide the world "
                             f"{world}")
        device, _ = init_ranks(args.device)
        rank = int(os.environ["RANK"])
        mesh = make_abstract_mesh((world // k, k), ("data", "model"))
        dmesh = to_device_mesh(mesh, device.type)
    say = print if rank == 0 else (lambda *a, **kw: None)
    say(f"[train] arch={cfg.name} layers={cfg.num_layers} "
        f"d={cfg.d_model} vocab={cfg.vocab_size} dtype={cfg.dtype}"
        + (f" mesh=(data {world // k}, model {k}) fsdp"
           + (" x tp" if k > 1 else "") if world else ""))
    if dmesh is not None and k > 1:
        model = init_model(cfg, seed=0, device=device, mesh=dmesh,
                           mode="train")
    else:
        model = init_model(cfg, seed=0, device=device)
    if dmesh is not None:
        from repro_torch.training.trainer import fsdp_shard
        fsdp_shard(model, dmesh)
    opt = adamw_init(dict(model.named_parameters()))
    hp = TrainHParams(base_lr=args.lr, warmup=max(args.steps // 10, 1),
                      total_steps=args.steps, remat=args.remat)
    step_fn = make_train_step(cfg, hp, mesh=dmesh)

    it = lm_batches(cfg.vocab_size, args.batch, args.seq)
    for i in range(args.steps):
        batch = next(it)
        if cfg.family == "vlm":
            batch["vision_embeds"] = np.zeros(
                (args.batch, cfg.vision_tokens, cfg.d_model), np.float32)
        if cfg.family == "audio":
            batch["encoder_frames"] = np.zeros(
                (args.batch, cfg.encoder_seq_len, cfg.d_model), np.float32)
        if mesh is not None:
            batch = _rows(batch, mesh, rank // k)
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, batch, i)
        loss = float(metrics["loss"])        # waits for the step
        say(f"step {i:4d} loss {loss:.4f} "
            f"acc {float(metrics['accuracy']):.3f} "
            f"gnorm {float(metrics['grad_norm']):.4f} "
            f"({time.perf_counter() - t0:.2f}s)")
    if args.ckpt:
        params, opt = _gathered(model, opt)
        if rank == 0:
            ckpt.save(args.ckpt, ckpt.train_state(cfg, params, opt),
                      {"arch": args.arch, "step": args.steps})
            print(f"[train] checkpoint -> {args.ckpt}")
    if world:
        import torch.distributed as dist
        dist.destroy_process_group()


def _rows(batch: dict, mesh, rank: int) -> dict:
    """Data rank ``rank``'s rows of each leaf of the global batch, by the
    leaf's ``batch_specs`` placement on the (data, model) mesh (row-major:
    world rank r is data rank r // K)."""
    specs = batch_specs(batch, mesh)
    n = mesh.shape["data"]
    out = {}
    for k, v in batch.items():
        if "data" in spec_axes(specs[k], 0):
            per = v.shape[0] // n
            v = v[rank * per:(rank + 1) * per]
        out[k] = v
    return out


def _gathered(model, opt):
    """Parameters and AdamW state as full tensors: each DTensor shard
    gathered over both axes (``launch.sharding.gather_whole``, a
    collective every rank joins)."""
    from repro_torch.launch.sharding import gather_whole as full
    from repro_torch.training.optim import AdamWState
    params = {k: full(p.detach()) for k, p in model.named_parameters()}
    return params, AdamWState(opt.count, {k: full(v) for k, v in
                                          opt.mu.items()},
                              {k: full(v) for k, v in opt.nu.items()})


if __name__ == "__main__":
    main()
