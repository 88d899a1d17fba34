"""``chip_smoke.py``'s phase ``tp_serve`` on chosen cases only, each
held: ``ARCH[:LAYERS]`` runs that arch's ``TP_CASES`` mesh and cache
rows, cut to LAYERS layers, one process of the same seed first, then the
ranks under ``torchrun`` on this card; every check of the phase runs,
and a failed one is printed instead of raised, so every case reports.
Prints the phase's lines and one JSON line of its results.

Needs a card (the decode kernel is built first). From the repo root:

    python3 tools/tp_depth.py zamba2-2.7b:12 zamba2-2.7b:24 rwkv6-1.6b:4
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_depth: no card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    build.load("decode_attention.cu")
    rows = {c[0]: c for c in chip_smoke.TP_CASES}
    cases = []
    for spec in argv:
        arch, _, layers = spec.partition(":")
        _, k, max_len, _, _ = rows[arch]
        cases.append((arch, k, max_len, int(layers) if layers else None,
                      True))
    chip_smoke.TP_CASES = tuple(cases)
    failed = []

    def report(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"check failed: {msg}", flush=True)
    chip_smoke.check = report
    res = chip_smoke.phase_tp_serve(card)
    print(json.dumps(dict(card=card, failed=failed, cases={
        t: {k: r[k] for k in ("layers", "rel_l2", "state_max_rel_l2",
                              "mesh_s", "one_process_s")}
        for t, r in res.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
