"""Serve a small model with batched requests on the PyTorch port.

Runs the paper's step ⑦ as a serving workload: the continuous-batching
engine hosts the (reduced) Qwen2-VL backbone behind ``VenusService``.
Each request is a ``StreamQuery`` (any registered retrieval strategy);
one service tick compiles all of them into one query plan, the planner
fuses compatible specs into execution groups (one scan each), and the
retrieved keyframes become the VLM's vision inputs (patch-embedding
stubs). The scans read the session manager's grow-in-place
``MemoryArena``: the service's ``stack_rebuilds`` counter must read 0.
Runs on the CUDA device unless ``--device`` names another:

  PYTHONPATH=src python examples/torch_serve_batch.py --requests 6 \\
      [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core.pipeline import VenusConfig, VenusSystem  # noqa: E402
from repro_torch.data.video import (OracleEmbedder, VideoWorld,  # noqa: E402
                                    WorldConfig)
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.venus_service import (StreamQuery,  # noqa: E402
                                               VenusService)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # --- edge side: Venus ingests the stream ------------------------------
    # sliding-window eviction keeps the device index bounded however long
    # the stream runs
    world = VideoWorld(WorldConfig(n_scenes=10, seed=4))
    oracle = OracleEmbedder(world, dim=64)
    venus = VenusSystem(VenusConfig(eviction="sliding_window"),
                        oracle, embed_dim=64, device=args.device)
    for i in range(0, world.total_frames, 64):
        venus.ingest(world.frames[i:i + 64])
    venus.flush()

    # --- cloud side: smoke Qwen2-VL behind the serving engine -------------
    cfg = get_smoke_config("qwen2-vl-7b")
    model = init_model(cfg, seed=0, device=args.device)
    eng = ServingEngine(model, batch_slots=args.slots, max_len=512)
    svc = VenusService(venus.manager, eng, max_frames=4)

    # one StreamQuery per request; AKR alternates with the greedy Top-K
    # baseline so the tick's plan has a strategy mix to fuse
    rng = np.random.default_rng(0)
    queries = []
    for i, q in enumerate(world.make_queries(args.requests, seed=7)):
        strategy, budget = (("akr", None) if i % 2 == 0 else ("topk", 4))
        queries.append(StreamQuery(
            rid=i, sid=venus.sid, text=q.text,
            prompt_tokens=rng.integers(3, cfg.vocab_size, size=24),
            query_emb=oracle.embed_query(q),
            strategy=strategy, budget=budget,
            max_new_tokens=args.max_new))

    plan = svc.plan(queries)
    print(plan.describe())

    t0 = time.perf_counter()
    done = svc.answer(queries)
    wall = time.perf_counter() - t0
    tok = sum(len(r.generated) for r in done)
    for r in done:
        print(f"req {r.rid}: {len(r.generated)} tokens, "
              f"ttft {(r.first_token_at - r.submitted_at) * 1e3:.0f} ms")
    stats = svc.io_stats()
    print(f"[serve_batch] {tok} tokens / {wall:.2f}s "
          f"= {tok / wall:.1f} tok/s with continuous batching; "
          f"{plan.n_scans} scans for {len(queries)} requests; "
          f"{stats['stack_rebuilds']} stack rebuilds (arena: appends "
          f"in place)")

    # --- lifecycle: the stream ends; its arena slot is recycled -----------
    final = svc.close_stream(venus.sid)
    replacement = svc.create_stream()     # reuses the freed slot
    stats = svc.io_stats()
    print(f"[serve_batch] closed stream after {final['frames_seen']} "
          f"frames; slot recycled for stream {replacement} "
          f"(releases={stats['arena_slot_releases']}, "
          f"reuses={stats['arena_slot_reuses']}, "
          f"grows={stats['arena_grows']} — no growth on churn)")


if __name__ == "__main__":
    main()
