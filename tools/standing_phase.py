"""The standing phase of ``chip_smoke.py`` alone: standing queries and
the spill tier through the entry points, then the edge slabs.

It builds the kernels, makes the main phase's 16 worlds of 224² and
MEM at venus-mem-large (bf16, seed 0), ingests once to take an index
row of each session for the embedding specs (as the main phase does),
then runs ``chip_smoke.phase_standing``. Needs an H100 and the CUDA
toolkit. From the repo root:

    python3 tools/standing_phase.py

Prints the phase's lines (about 80 s of command, most of it the first
ingest and the builds); exits non-zero where a check fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                     "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("standing_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.venus_mem import config as mem_config
    from repro_torch.core.pipeline import MEMEmbedder
    from repro_torch.core.session import VenusConfig
    from repro_torch.kernels import build
    from repro_torch.models.mem import MEM
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build_all()
    worlds = cs.make_worlds(cs.S, 224)
    embedder = cs.TimedEmbedder(MEMEmbedder(
        MEM.init(mem_config(), seed=0, device="cuda")))
    mgr, _, _ = cs.ingest_streams(worlds, VenusConfig(), embedder, cs.D,
                                  "cuda")
    first_pass = [mgr[s].memory._emb[mgr[s].memory.size // 2].copy()
                  for s in range(cs.S)]
    del mgr
    t0 = time.perf_counter()
    cs.phase_standing(embedder, worlds, first_pass, card)
    print(f"standing_phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
