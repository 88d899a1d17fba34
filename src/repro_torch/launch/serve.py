"""Serving launcher of the port: batched requests through the
continuous-batching engine for any ``--arch`` of the reference's ten
(the dense, VLM and MoE decoders, zamba2-2.7b, rwkv6-1.6b and
whisper-base), with random weights from a seed; an audio request carries
encoder frames drawn from the seed, as in the reference's launcher.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
      --requests 8 --slots 4 --max-new 16 [--full] [--device cpu] \\
      [--param-dtype bfloat16]

Under ``torchrun`` with ``--model K`` any of the ten serves on a (world
/ K, K) ``("data", "model")`` mesh, placed by the reference's tables
(attention, Mamba2 and RWKV6 heads, FFN columns, the experts, the
vocabulary and the learned positions over ``model``; the KV cache by its
heads, or by its sequence where they do not divide K; the recurrent
states by head): one card a rank where there are enough (NCCL), else
every rank on the cards there are (gloo). Every rank serves the same
requests; rank 0 prints.

  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch glm4-9b --model 4 [--device cpu]

``--layers N`` cuts the depth to N layers (the config's widths kept).

``--dump PATH`` also writes (rank 0) an npz of the served tokens and of
teacher-forced logits: a batch of ``--slots`` prompts (with the VLM's
vision embeddings or Whisper's encoder frames, drawn from the seed)
prefilled, then ``TEACHER_STEPS`` decode steps fed fixed tokens, so two
runs (one process and a mesh) compare step for step.

Runs on the CUDA device unless ``--device`` names another one. A prompt
longer than ``--max-len`` (vision tokens included) fills the cache with
its ring-consistent tail, as in the reference. Weights are f32 as in the
reference unless ``--param-dtype bfloat16`` stores them in bf16 (the same
bits at every product, which casts them to bf16). Prints each request's
TTFT, then the median prefill and the median seconds per decode step.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import Request, ServingEngine

# the decode steps of ``--dump``'s teacher-forced logits
TEACHER_STEPS = 4


def teacher_inputs(cfg, *, batch: int, steps: int, seed: int = 1):
    """The inputs of ``teacher_forced``, drawn from ``seed`` (numpy): the
    prompts (B, S) right-padded, their lengths (vision tokens not
    counted), the fed tokens (steps, B, 1) and the family's side input:
    for the VLM vision embeddings (B, vision_tokens, d), for the audio
    family encoder frames (B, encoder_seq_len, d), else None."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 32, size=batch)
    tok = np.zeros((batch, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    fed = rng.integers(3, cfg.vocab_size, size=(steps, batch, 1)).astype(
        np.int32)
    side = None
    if cfg.family in ("vlm", "audio"):
        n = (cfg.vision_tokens if cfg.family == "vlm"
             else cfg.encoder_seq_len)
        side = rng.normal(0, 0.02, (batch, n, cfg.d_model)).astype(
            np.float32)
    return tok, lens, fed, side


def teacher_forced(model, cfg, *, batch: int, max_len: int, steps: int,
                   seed: int = 1):
    """Prefill logits (B, V) of ``batch`` prompts of 8–31 tokens (right-
    padded to the longest), then the logits of ``steps`` decode steps fed
    tokens drawn from ``seed`` (``teacher_inputs``), the cache in the
    activation dtype → (prompt lengths, fed tokens, logits (1 + steps, B,
    V) as float32 numpy). The same on one process and on a mesh."""
    tok, lens, fed, side = teacher_inputs(cfg, batch=batch, steps=steps,
                                          seed=seed)
    dev = model.device
    vlm = cfg.family == "vlm"
    nv = side.shape[1] if vlm else 0
    kw = {} if side is None else {
        "vision_embeds" if vlm else "encoder_frames":
            torch.from_numpy(side).to(dev)}
    cache = model.init_cache(batch, max_len, getattr(torch, cfg.dtype))
    logits, cache, _ = model.apply(
        torch.from_numpy(tok).to(dev), cache=cache, mode="prefill",
        prompt_lengths=torch.from_numpy((lens + nv).astype(np.int32)).to(
            dev), **kw)
    out = [logits[:, -1].float().cpu().numpy()]
    for t in range(steps):
        logits, cache, _ = model.apply(torch.from_numpy(fed[t]).to(dev),
                                       cache=cache, mode="decode")
        out.append(logits[:, -1].float().cpu().numpy())
    return lens, fed, np.stack(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-vl-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--param-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--model", type=int, default=0,
                    help="model-axis size K under torchrun (default: the "
                         "world, on a (1, world) mesh)")
    ap.add_argument("--dump", default="",
                    help="write the tokens and teacher-forced logits here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(
        args.arch)
    cfg = cfg.replace(param_dtype=args.param_dtype)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    world = int(os.environ.get("WORLD_SIZE", "0"))
    dmesh, rank, device = None, 0, args.device
    if world:
        from repro_torch.launch.mesh import (init_ranks, make_abstract_mesh,
                                             to_device_mesh)
        dev, _ = init_ranks(args.device)
        device, rank = dev, int(os.environ["RANK"])
        k = args.model or world
        if world % k:
            raise SystemExit(f"--model {k} does not divide the world "
                             f"{world}")
        dmesh = to_device_mesh(
            make_abstract_mesh((world // k, k), ("data", "model")),
            dev.type)
    say = print if rank == 0 else (lambda *a, **kw: None)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=device, mesh=dmesh)
    say(f"[serve] {cfg.name}: "
        + ("" if dmesh is None else f"mesh (data {dmesh.size(0)}, model "
           f"{dmesh.size(1)}), ")
        + f"{cfg.num_layers} layers, built in "
          f"{time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(model, batch_slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        r = Request(rid=i,
                    tokens=rng.integers(3, cfg.vocab_size,
                                        size=int(rng.integers(8, 64))),
                    max_new_tokens=args.max_new)
        if cfg.family == "vlm":
            r.vision_embeds = rng.normal(
                0, 0.02, (cfg.vision_tokens, cfg.d_model)).astype(
                    np.float32)
        if cfg.family == "audio":
            r.encoder_frames = rng.normal(
                0, 0.02, (cfg.encoder_seq_len, cfg.d_model)).astype(
                    np.float32)
        reqs.append(r)

    t0 = time.perf_counter()
    done = eng.run(reqs)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in done)
    for r in done:
        ttft = (r.first_token_at - r.submitted_at) * 1e3
        say(f"req {r.rid}: prompt {len(r.tokens):3d} tok, "
            f"generated {len(r.generated):3d}, ttft {ttft:.0f} ms")
    say(f"[serve] {cfg.name} on {model.device}: {len(done)} requests, "
        f"{total_new} tokens in {wall:.2f}s "
        f"({total_new / wall:.1f} tok/s aggregate)")
    t = eng.timings
    if t["decode"]:
        say(f"[serve] prefill median {statistics.median(t['prefill']):.6f}"
            f" s, decode median {statistics.median(t['decode']):.6f} "
            f"s/step over {len(t['decode'])} steps")
    if args.dump:
        del eng
        lens, fed, logits = teacher_forced(
            model, cfg, batch=args.slots, max_len=args.max_len,
            steps=TEACHER_STEPS)
        if rank == 0:
            tokens = np.full((len(done), args.max_new), -1, np.int64)
            for i, r in enumerate(done):
                tokens[i, :len(r.generated)] = r.generated
            np.savez(args.dump, tokens=tokens, logits=logits, lens=lens,
                     fed=fed)
            say(f"[serve] wrote {args.dump}")
    if world:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
