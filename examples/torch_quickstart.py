"""Quickstart on the PyTorch port: the full Venus loop.

Streams a procedural video into the Venus ingestion pipeline (scene
segmentation → clustering → MEM embedding → memory), then answers
natural-language queries through the declarative query-plan API: every
query is a ``QuerySpec`` (here AKR vs greedy Top-K per question), the
planner fuses compatible specs into execution groups, and ONE scan per
group answers everything. Runs on the CUDA device unless ``--device``
names another:

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.venus_mem import smoke_config  # noqa: E402
from repro_torch.core.aux_models import DetectorStub, OCRStub  # noqa: E402
from repro_torch.core.pipeline import (MEMEmbedder, QuerySpec,  # noqa: E402
                                       VenusConfig, VenusSystem,
                                       patch_projection, patchify)
from repro_torch.data.text import tokenize_batch  # noqa: E402
from repro_torch.data.video import VideoWorld, WorldConfig  # noqa: E402
from repro_torch.models.mem import MEM  # noqa: E402
from repro_torch.training import (TrainHParams, adamw_init,  # noqa: E402
                                  make_mem_train_step)


def _pretrain_mem(mem, mem_cfg, world, steps=80, batch=8):
    opt = adamw_init(dict(mem.named_parameters()))
    step_fn = make_mem_train_step(mem, TrainHParams(
        base_lr=1e-3, warmup=5, total_steps=steps, remat=False))
    proj = torch.from_numpy(patch_projection(
        8, mem_cfg.vision.d_model)).to(mem.device)
    rng = np.random.default_rng(0)
    acc = 0.0
    for i in range(steps):
        scenes = rng.choice(len(world.scenes), size=batch, replace=False)
        frames, texts = [], []
        for s in scenes:
            sc = world.scenes[s]
            f = int(rng.integers(sc.w_start, sc.w_end))
            frames.append(world.frames[f])
            texts.append(f"find {sc.text} {' '.join(sc.objects)}")
        patches = patchify(torch.from_numpy(np.stack(frames)).to(
            mem.device), 8, proj)
        toks, mask = tokenize_batch(texts, mem_cfg.text.vocab_size, 16)
        b = {"patches": patches, "tokens": toks, "mask": mask}
        mem, opt, m = step_fn(mem, opt, b, i)
        acc = float(m["contrastive_acc"])
    mem.requires_grad_(False)
    print(f"MEM pretrained {steps} steps; contrastive acc {acc:.2f}")
    return mem


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # 1. a synthetic camera: 8 scenes with ground-truth events
    world = VideoWorld(WorldConfig(n_scenes=8, seed=42))
    print(f"stream: {world.total_frames} frames, {len(world.scenes)} "
          f"scenes, events "
          f"{[s.event for s in world.scenes]}")

    # 2. a tiny MEM, briefly trained contrastively on (frame, caption)
    #    pairs so the joint embedding space is meaningful
    mem_cfg = smoke_config()
    mem = MEM.init(mem_cfg, seed=0, device=args.device)
    mem = _pretrain_mem(mem, mem_cfg, world, steps=80)
    embedder = MEMEmbedder(mem)
    system = VenusSystem(
        VenusConfig(), embedder, embed_dim=mem_cfg.embed_dim,
        aux_models=[OCRStub(), DetectorStub()],
        annotation_fn=world.annotations, device=args.device)

    # 3. ingestion stage: stream chunks like a camera would deliver them
    for i in range(0, world.total_frames, 50):
        system.ingest(world.frames[i:i + 50])
    system.flush()
    s = system.stats
    print(f"ingested: {s['partitions']} partitions, {s['clusters']} "
          f"clusters; embedded only {s['frames_embedded']}/"
          f"{s['frames_seen']} frames "
          f"({100 * s['frames_embedded'] / s['frames_seen']:.1f}%)")

    # 4. querying stage: ONE declarative plan answers every question
    #    twice — Venus AKR (adaptive budget) vs the greedy Top-K
    #    baseline — fused into two execution groups (one scan each)
    queries = world.make_queries(3, seed=1)
    specs = [QuerySpec(sid=0, text=q.text, strategy="akr")
             for q in queries]
    specs += [QuerySpec(sid=0, text=q.text, strategy="topk", budget=8)
              for q in queries]
    plan = system.plan(specs)
    print("\n" + plan.describe())
    results = system.execute(plan)
    for i, q in enumerate(queries):
        res, topk = results[i], results[len(queries) + i]
        scenes = sorted({int(world.scene_of_frame[f])
                         for f in res.frame_ids})
        tk_scenes = sorted({int(world.scene_of_frame[f])
                            for f in topk.frame_ids})
        print(f"\nquery: '{q.text}' (relevant scenes "
              f"{q.relevant_scenes})")
        print(f"  venus/AKR: {res.n_drawn} draws -> "
              f"{len(res.frame_ids)} frames from scenes {scenes} "
              f"(mass {res.mass:.2f})")
        print(f"  top-k:     8 frames from scenes {tk_scenes}")
        print("  timings: " + ", ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in res.timings.items()))


if __name__ == "__main__":
    main()
