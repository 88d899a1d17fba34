"""Train the Venus MEM (dual-tower multimodal embedder) contrastively on
the PyTorch port.

SigLIP pairwise loss over synthetic (frame, caption) pairs from the
procedural world, AdamW + cosine schedule, checkpoints in the
reference's format. The default is the smoke MEM; ``--model small`` is
the ~100M-class tower. Runs on the CUDA device unless ``--device`` names
another:

  PYTHONPATH=src python examples/torch_train_mem.py --steps 60 \\
      [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import venus_mem  # noqa: E402
from repro_torch.core.convert import mem_params_to_numpy  # noqa: E402
from repro_torch.core.pipeline import (patch_projection,  # noqa: E402
                                       patchify)
from repro_torch.data.text import tokenize_batch  # noqa: E402
from repro_torch.data.video import VideoWorld, WorldConfig  # noqa: E402
from repro_torch.models.mem import MEM  # noqa: E402
from repro_torch.training import (TrainHParams, adamw_init,  # noqa: E402
                                  make_mem_train_step)
from repro_torch.training import checkpoint as ckpt  # noqa: E402


def make_batch(world, rng, batch, mem_cfg, proj):
    """Distinct-scene (frame, caption) pairs for the pairwise loss."""
    scenes = rng.choice(len(world.scenes), size=batch, replace=False)
    frames, texts = [], []
    for s in scenes:
        sc = world.scenes[s]
        f = int(rng.integers(sc.w_start, sc.w_end))     # evidence frame
        frames.append(world.frames[f])
        texts.append(f"{sc.text} {' '.join(sc.objects)}")
    patches = patchify(torch.from_numpy(np.stack(frames)).to(proj.device),
                       8, proj)
    toks, mask = tokenize_batch(texts, mem_cfg.text.vocab_size, 16)
    return {"patches": patches, "tokens": toks, "mask": mask}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model", choices=["smoke", "small", "large"],
                    default="smoke")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    mem_cfg = {"smoke": venus_mem.smoke_config,
               "small": venus_mem.small_config,
               "large": venus_mem.config}[args.model]()
    world = VideoWorld(WorldConfig(n_scenes=16, seed=2))
    mem = MEM.init(mem_cfg, seed=0, device=args.device)
    opt = adamw_init(dict(mem.named_parameters()))
    step_fn = make_mem_train_step(mem, TrainHParams(
        base_lr=3e-4, warmup=max(args.steps // 10, 1),
        total_steps=args.steps, remat=False))
    proj = torch.from_numpy(patch_projection(
        8, mem_cfg.vision.d_model)).to(mem.device)

    rng = np.random.default_rng(0)
    for i in range(args.steps):
        batch = make_batch(world, rng, args.batch, mem_cfg, proj)
        t0 = time.perf_counter()
        mem, opt, metrics = step_fn(mem, opt, batch, i)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['contrastive_acc']):.3f} "
                  f"({time.perf_counter() - t0:.2f}s)")
    if args.ckpt:
        ckpt.save(args.ckpt, {"params": mem_params_to_numpy(mem)},
                  {"model": mem_cfg.name, "steps": args.steps})
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
