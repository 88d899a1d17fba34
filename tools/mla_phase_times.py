"""Where ``k_mla`` (the bf16 MLA decode kernel) spends its device time.

Times the kernel with one phase left out at a time. Each variant is
``csrc/mla_decode.cu`` with one textual edit (``VARIANTS``), built with the
port's nvcc flags into ``_build/mla_variants/`` (one nvcc per variant, all
at once); the wrapper ``decode_attention.mla_decode`` is then pointed at
the variant's library and timed at ``chip_smoke.py``'s MLA shape (B = 4, C
= 2048, H = 40, R = 256, Dr = 32, bf16) with the table's masks and the
serve-like masks (9-76 valid rows a slot). A variant's output is wrong on
purpose; only its time is read. The phases overlap, so the gaps to the
full kernel do not add up to its time.

Needs an H100 and the CUDA toolkit. From the repo root:

    python3 tools/mla_phase_times.py

Prints one line a variant and writes ``chiprun_out/mla_phase_times.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# name -> (what is left out, anchor in mla_decode.cu, its replacement)
VARIANTS = {
    "full": ("nothing", None, None),
    "no_merge": (
        "the k_merge launch (k_mla alone)",
        "  return dec::launch_merge<bf16>(a.H, B, splits, a.R, a.part_m, "
        "a.part_l,\n                                 a.part_acc, out, st);",
        "  (void)out;\n  return cudaSuccess;"),
    "empty_block": (
        "all of k_mla's work: its launch and k_merge stay",
        '  asm volatile("griddepcontrol.launch_dependents;\\n" ::);\n',
        '  asm volatile("griddepcontrol.launch_dependents;\\n" ::);\n'
        "  if (a.C > 0) return;\n"),
    "no_walk": (
        "the walk over the tiles: the mask scan, the first copies and the "
        "partial stay",
        "  for (int i = 0; i < n; ++i) {",
        "  for (int i = 0; i < n * 0; ++i) {"),
    "no_scores": (
        "the score product q.[ckv, krope]^T",
        "    for (int kk = k_lo; kk < k_hi; ++kk) {",
        "    for (int kk = k_lo; kk < k_lo; ++kk) {"),
    "no_value": (
        "the value product p.ckv",
        "    for (int kk = 0; kk < kRows / 16; ++kk) {",
        "    for (int kk = 0; kk < 0; ++kk) {"),
    "one_p_term": (
        "two of p's three bf16 terms in the value product",
        "          for (int t = 0; t < 3; ++t)\n#pragma unroll\n"
        "            for (int mt = 0; mt < kMT; ++mt) {\n              mma(",
        "          for (int t = 0; t < 1; ++t)\n#pragma unroll\n"
        "            for (int mt = 0; mt < kMT; ++mt) {\n              mma("),
}


def build_variants(out_dir: str) -> dict:
    """Write and compile every variant in parallel → name: library path."""
    from repro_torch.kernels import build
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(build.CSRC, "decode_common.cuh"), out_dir)
    with open(os.path.join(build.CSRC, "mla_decode.cu")) as f:
        src = f.read()
    procs = {}
    for name, (_, anchor, repl) in VARIANTS.items():
        text = src
        if anchor is not None:
            if src.count(anchor) != 1:
                raise RuntimeError(f"{name}: anchor found "
                                   f"{src.count(anchor)} times")
            text = src.replace(anchor, repl)
        cu = os.path.join(out_dir, f"mla_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libmla_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as dk
    libs = build_variants(os.path.join(ROOT, "src", "repro_torch", "_build",
                                       "mla_variants"))
    dev = torch.device("cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    b, c, h, r, dr, bf = cs.DEC_B, cs.DEC_C, 40, 256, 32, torch.bfloat16
    qa = torch.randn((b, 1, h, r), generator=gen, device=dev).to(bf)
    qr = torch.randn((b, 1, h, dr), generator=gen, device=dev).to(bf)
    ckv = torch.randn((b, c, r), generator=gen, device=dev).to(bf)
    kr = torch.randn((b, c, dr), generator=gen, device=dev).to(bf)
    masks = {"table": cs.decode_valid(dev),
             "serve": torch.arange(c, device=dev)[None, :]
             < torch.tensor([9, 30, 52, 76], device=dev)[:, None]}
    scale = (64 + dr) ** -0.5
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = {}
    # each variant twice, in the order A..G, G..A, so a drift of the
    # card's clock over the run falls on every variant alike
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for name in order:
        fn = ctypes.CDLL(libs[name]).mla_split_bf16
        fn.argtypes, fn.restype = dk._MLA_SPLIT_ARGS, ctypes.c_int
        dk._FNS[("mla_split", bf)] = fn
        row = rows.setdefault(name, dict(leaves_out=VARIANTS[name][0]))
        for mname, valid in masks.items():
            run = lambda: dk.mla_decode(qa, qr, ckv, kr, valid, scale=scale)
            row.setdefault(f"{mname}_device_us", []).append(
                1e3 * cs.device_ms(run, reps=50))
            row.setdefault(f"{mname}_kernel_us", []).append(
                cs.kernel_us(run))
    dk._FNS.pop(("mla_split", bf))
    for name, row in rows.items():
        print(f"{name:12s} table {row['table_device_us']} us  serve "
              f"{row['serve_device_us']} us  per kernel (table) "
              f"{row['table_kernel_us'][0]}  leaves out: {row['leaves_out']}",
              flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "mla_phase_times.json"), "w") as f:
        json.dump(dict(card=card, shape=dict(B=b, C=c, H=h, R=r, Dr=dr),
                       variants=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
