"""Kernel #5's split phase alone (``gqa_decode(..., partials=True)``) on
one rank's shard of a cache split by its sequence: GLM-4-9B's widths on a
(1, 4) model axis (32 query heads, 2 KV heads of 128, bf16), 2 sequences
and 512 cache rows a rank (2,048 in all). Two masks: the first rank's,
with the first 56 and 30 rows valid (two served prompts of 55 and 29
tokens after one decode step), and the other ranks', with none. Each is
launched ``--reps`` times under the profiler; the line gives the device
µs a launch of its first kernel, and the bytes such a launch must move
over the card's memory rate. Each result is held, merged, against the
plain version's.

Needs an H100 and the CUDA toolkit. From the repo root:

    python3 tools/decode_partials_us.py [--tree DIR] [--reps 200]

``--tree DIR`` imports ``repro_torch`` from ``DIR/src`` (another
checkout, unpacked with ``git archive``), so two commits compare in one
run on one card. Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(os.path.abspath(args.tree), "src")]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("decode_partials_us: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, h, hkv, d = 2, 512, 32, 2, 128
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, c, hkv, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, c, hkv, d), generator=gen, device=dev).bfloat16()
    kw = dict(scale=d ** -0.5, q_per_kv=h // hkv)
    rows = torch.arange(c, device=dev)[None]
    out = dict(card=card, tree=os.path.abspath(args.tree), shape=dict(
        B=b, C=c, H=h, Hkv=hkv, D=d), reps=args.reps)
    for name, n in (("first_rank", (56, 30)), ("empty_rank", (0, 0))):
        valid = rows < torch.tensor(n, device=dev)[:, None]
        got = dk.gqa_decode(q, k, v, valid, partials=True, **kw)
        want = ref.decode_partials_ref(q, k, v, valid, **kw)
        torch.testing.assert_close(
            ref.merge_partials_ref(*got, torch.float32),
            ref.merge_partials_ref(*want, torch.float32),
            rtol=2 ** -7, atol=1e-6)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                dk.gqa_decode(q, k, v, valid, partials=True, **kw)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and ("k_gqa_split" in e.name or "k_partial" in e.name)]
        if len(us) != args.reps:
            print(f"decode_partials_us: {len(us)} kernel events for "
                  f"{args.reps} launches", file=sys.stderr)
            return 1
        # the mask; q, the valid rows of k and v where there are any; the
        # partials written
        parts = sum(x.numel() * x.element_size() for x in got)
        need = (valid.numel() + (q.numel() * 2 if sum(n) else 0)
                + 2 * sum(n) * hkv * d * 2 + parts)
        out[name] = dict(valid_rows=list(n), device_us=sum(us) / len(us),
                         bound_us=need / HBM_BYTES_PER_S * 1e6,
                         route=dk.gqa_route(torch.bfloat16, h // hkv, d))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
