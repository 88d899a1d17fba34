"""Training launcher of the port: ``--arch <id>`` selects any of the
reference's ten archs, trained on the synthetic LM stream
(``data.text.lm_batches``) from random weights (seed 0), with the
reference's flags; the VLM and audio families get zero stub embeddings,
as in the reference's launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --steps 20 --batch 4 --seq 128 [--full] [--remat] [--ckpt out/ck] \\
      [--device cpu]

Runs on the CUDA device unless ``--device`` names another one. Without
``--full`` the arch's smoke config; ``--full`` takes the published
config on one card, which holds only what fits: f32 parameters,
gradients and two AdamW moments are 16 bytes a parameter (deepseek-7b in
full: ≈ 110 GB). ``--ckpt`` writes the parameters and the AdamW state in
the reference's checkpoint format (``training.checkpoint``), which the
reference's ``restore`` reads.

Started alone it trains in one process, with no mesh. Under
``torchrun --nproc-per-node K`` (the world size in the environment) it
trains on a (K, 1) ``("data", "model")`` mesh, the reference's
``make_host_mesh()``, under FSDP2 (``fsdp_shard``, then
``make_train_step(mesh=)``): NCCL on the cards (rank r on
``cuda:<local rank>``), gloo with ``--device cpu``.
Each rank takes its rows of the global batch (``batch_specs``); the
printed loss and accuracy are means over the ranks, printed by rank 0;
``--ckpt`` gathers every shard (``full_tensor``) and rank 0 writes:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch deepseek-7b --steps 3 --batch 4 --seq 32 --device cpu
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
from repro_torch.launch.mesh import make_abstract_mesh, to_device_mesh
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(
        args.arch)
    world = int(os.environ.get("WORLD_SIZE", "0"))
    mesh = dmesh = None
    rank, device = 0, args.device
    if world:
        import torch.distributed as dist
        rank = int(os.environ["RANK"])
        cpu = args.device is not None and torch.device(
            args.device).type == "cpu"
        if not cpu:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        dist.init_process_group("gloo" if cpu else "nccl")
        mesh = make_abstract_mesh((world, 1), ("data", "model"))
        dmesh = to_device_mesh(mesh, "cpu" if cpu else "cuda")
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[train] arch={cfg.name} layers={cfg.num_layers} "
        f"d={cfg.d_model} vocab={cfg.vocab_size}"
        + (f" mesh=(data {world}, model 1) fsdp" if world else ""))
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
            batch = _rows(batch, mesh, rank)
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
    """This rank's rows of each leaf of the global batch, by the leaf's
    ``batch_specs`` placement on the (world, 1) mesh."""
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
    gathered (``full_tensor``, a collective every rank joins)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training.optim import AdamWState

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    params = {k: full(p.detach()) for k, p in model.named_parameters()}
    return params, AdamWState(opt.count, {k: full(v) for k, v in
                                          opt.mu.items()},
                              {k: full(v) for k, v in opt.nu.items()})


if __name__ == "__main__":
    main()
