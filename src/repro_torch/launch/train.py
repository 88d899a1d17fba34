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
full: ≈ 110 GB). One card needs no mesh. ``--ckpt`` writes the
parameters and the AdamW state in the reference's checkpoint format
(``training.checkpoint``), which the reference's ``restore`` reads.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.data.text import lm_batches
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
    print(f"[train] arch={cfg.name} layers={cfg.num_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab_size}")
    model = init_model(cfg, seed=0, device=args.device)
    opt = adamw_init(dict(model.named_parameters()))
    hp = TrainHParams(base_lr=args.lr, warmup=max(args.steps // 10, 1),
                      total_steps=args.steps, remat=args.remat)
    step_fn = make_train_step(cfg, hp)

    it = lm_batches(cfg.vocab_size, args.batch, args.seq)
    for i in range(args.steps):
        batch = next(it)
        if cfg.family == "vlm":
            batch["vision_embeds"] = np.zeros(
                (args.batch, cfg.vision_tokens, cfg.d_model), np.float32)
        if cfg.family == "audio":
            batch["encoder_frames"] = np.zeros(
                (args.batch, cfg.encoder_seq_len, cfg.d_model), np.float32)
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, batch, i)
        loss = float(metrics["loss"])        # waits for the step
        print(f"step {i:4d} loss {loss:.4f} "
              f"acc {float(metrics['accuracy']):.3f} "
              f"({time.perf_counter() - t0:.2f}s)")
    if args.ckpt:
        ckpt.save(args.ckpt, ckpt.train_state(cfg, model, opt),
                  {"arch": args.arch, "step": args.steps})
        print(f"[train] checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
