"""Serving launcher of the port: batched requests through the
continuous-batching engine for any ``--arch`` of the reference's ten
(the dense, VLM and MoE decoders, zamba2-2.7b, rwkv6-1.6b and
whisper-base), with random weights from a seed; an audio request carries
encoder frames drawn from the seed, as in the reference's launcher.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
      --requests 8 --slots 4 --max-new 16 [--full] [--device cpu] \\
      [--param-dtype bfloat16]

Runs on the CUDA device unless ``--device`` names another one. A prompt
longer than ``--max-len`` (vision tokens included) fills the cache with
its ring-consistent tail, as in the reference. Weights are f32 as in the
reference unless ``--param-dtype bfloat16`` stores them in bf16 (the same
bits at every product, which casts them to bf16). Prints each request's
TTFT, then the median prefill and the median seconds per decode step.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-vl-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--param-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke_config(
        args.arch)
    cfg = cfg.replace(param_dtype=args.param_dtype)
    model = init_model(cfg, seed=0, device=args.device)
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
        print(f"req {r.rid}: prompt {len(r.tokens):3d} tok, "
              f"generated {len(r.generated):3d}, ttft {ttft:.0f} ms")
    print(f"[serve] {cfg.name} on {model.device}: {len(done)} requests, "
          f"{total_new} tokens in {wall:.2f}s "
          f"({total_new / wall:.1f} tok/s aggregate)")
    t = eng.timings
    if t["decode"]:
        print(f"[serve] prefill median {statistics.median(t['prefill']):.6f}"
              f" s, decode median {statistics.median(t['decode']):.6f} "
              f"s/step over {len(t['decode'])} steps")


if __name__ == "__main__":
    main()
