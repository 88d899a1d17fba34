"""End-to-end online video QA on the PyTorch port: queries arrive DURING
the stream.

The camera streams continuously; queries land at arbitrary timestamps
and can only use what has been ingested so far. Each query's response
latency is decomposed like the paper's Fig. 12 — the edge compute
measured here, the upload and the cloud VLM modelled
(``repro_torch.core.costmodel``) — beside its answer coverage against
the ground truth. Runs on the CUDA device unless ``--device`` names
another:

  PYTHONPATH=src python examples/torch_online_video_qa.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.costmodel import venus_query_latency  # noqa: E402
from repro_torch.core.pipeline import VenusConfig, VenusSystem  # noqa: E402
from repro_torch.data.video import (OracleEmbedder, VideoWorld,  # noqa: E402
                                    WorldConfig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    world = VideoWorld(WorldConfig(n_scenes=12, seed=11))
    oracle = OracleEmbedder(world, dim=64)
    system = VenusSystem(VenusConfig(), oracle, embed_dim=64,
                         device=args.device)

    chunk = 25                       # 1 "second" of 25 FPS video
    query_times = {8: 0, 20: 1, 35: 2}   # second -> query id
    queries = world.make_queries(3, seed=5)

    for sec, i in enumerate(range(0, world.total_frames, chunk)):
        system.ingest(world.frames[i:i + chunk])
        if sec in query_times:
            q = queries[query_times[sec]]
            res = system.query(q.text, query_emb=oracle.embed_query(q))
            lat = venus_query_latency(
                measured_edge_s=res.timings,
                n_frames_uploaded=len(res.frame_ids))
            seen = {int(world.scene_of_frame[f]) for f in res.frame_ids}
            rel = [s for s in q.relevant_scenes
                   if world.scenes[s].end <= (i + chunk)]
            cov = (len(set(rel) & seen) / len(rel)) if rel else float("nan")
            print(f"t={sec:3d}s  query '{q.text}'")
            print(f"   -> {len(res.frame_ids)} frames "
                  f"(AKR drew {res.n_drawn}), coverage so far: {cov:.2f}")
            print(f"   -> {lat}")
    system.flush()
    print(f"\nfinal memory: {system.memory.size} indexed vectors for "
          f"{world.total_frames} frames")


if __name__ == "__main__":
    main()
