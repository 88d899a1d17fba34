"""The decode kernels' split phase alone (``partials=True``) on one
rank's shard of a cache split by its sequence:

* #5 (``gqa_decode``): GLM-4-9B's widths on a (1, 4) model axis (32
  query heads, 2 KV heads of 128, bf16), 2 sequences and 512 cache rows a
  rank (2,048 in all). Two masks: the first rank's, with the first 56
  and 30 rows valid (two served prompts of 55 and 29 tokens after one
  decode step), and the other ranks', with none.
* #6 (``mla_decode``): DeepSeek-V2-Lite's widths on a (1, 4) model axis
  (16 heads, R = 512, Dr = 64, bf16, ``k_mla``), 2 sequences and 16 of
  the 64 latent cache rows a rank. Two masks: the first rank's (the same
  prompts fill all 16 of its rows) and an empty rank's. Each is timed on
  this tree's ``mla_decode.cu`` ("after") and on a build of it with the
  empty-part repair undone ("before": a split with no valid row reads
  the whole sequence's mask first, and with none valid walks its tiles
  for the mean of ckv), in the order after, before, before, after.

Each mask is launched ``--reps`` times under the profiler; the line
gives the device µs a launch of the first kernel, and the bytes such a
launch must move over the card's memory rate (#6: with the operations
over their peak rates, the larger). Each result is held, merged, against
the plain version's (the "before" build's empty rank gives the mean of
ckv there, not the empty part, and is timed only).

Needs an H100 and the CUDA toolkit. From the repo root:

    python3 tools/decode_partials_us.py [--tree DIR] [--reps 200]

``--tree DIR`` imports ``repro_torch`` from ``DIR/src`` (another
checkout, unpacked with ``git archive``), so two commits compare in one
run on one card; a tree whose ``mla_decode`` has no ``partials`` times
#5 alone. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside tensor cores
BF16_TENSOR_FLOP_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores
# the empty-part repair of k_mla, undone: (anchor, replacement)
MLA_BEFORE = (("    int any = a.empty_parts;\n"
               "    for (int r0 = tid; !a.empty_parts && r0 < a.C; "
               "r0 += 8 * kThreads) {",
               "    int any = 0;\n"
               "    for (int r0 = tid; r0 < a.C; r0 += 8 * kThreads) {"),)


def device_us(run, reps: int, names) -> list:
    """Device µs of each launch of a kernel named in ``names`` over
    ``reps`` calls of ``run`` under the profiler. The trace starts with
    64 short sleep kernels: a trace may lose its first device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and any(n in e.name for n in names)]


def build_before(tree: str) -> str:
    """``mla_decode.cu`` of ``tree`` with ``MLA_BEFORE``'s edits, built
    with the port's nvcc flags → the library's path."""
    from repro_torch.kernels import build
    out = os.path.join(tree, "src", "repro_torch", "_build", "mla_before")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(build.CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC, f), out)
    with open(os.path.join(build.CSRC, "mla_decode.cu")) as f:
        src = f.read()
    for anchor, repl in MLA_BEFORE:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor found {src.count(anchor)} times: "
                               f"{anchor!r}")
        src = src.replace(anchor, repl)
    cu, lib = (os.path.join(out, n) for n in ("mla_before.cu",
                                              "libmla_before.so"))
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                   check=True, capture_output=True)
    return lib


def time_mla(dk, ref, reps: int, tree: str) -> dict:
    """#6's partials on DeepSeek-V2-Lite's rank shard, after and before
    the empty-part repair (see the module's doc)."""
    import ctypes
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, c, h, r, dr = 2, 16, 16, 512, 64
    qa, qr, ckv, kr = (torch.randn(s, generator=gen, device=dev).bfloat16()
                       for s in ((b, 1, h, r), (b, 1, h, dr), (b, c, r),
                                 (b, c, dr)))
    scale = (128 + dr) ** -0.5
    bf = torch.bfloat16
    after = dk._kernel_fn("mla_split", bf, dk._MLA_SPLIT_ARGS,
                          dk._MLA_SOURCE)
    before = ctypes.CDLL(build_before(tree)).mla_split_bf16
    before.argtypes, before.restype = dk._MLA_SPLIT_ARGS, ctypes.c_int
    rows = torch.arange(c, device=dev)[None]
    out = dict(shape=dict(B=b, C=c, H=h, R=r, Dr=dr, rank_of=64),
               route=dk.mla_route(bf, h, r, dr))
    for name, n in (("first_rank", (16, 16)), ("empty_rank", (0, 0))):
        valid = rows < torch.tensor(n, device=dev)[:, None]

        def run():
            return dk.mla_decode(qa, qr, ckv, kr, valid, scale=scale,
                                 partials=True)
        want = ref.mla_decode_partials_ref(qa, qr, ckv, kr, valid,
                                           scale=scale)
        times = {"after": [], "before": []}
        for label in ("after", "before", "before", "after"):
            dk._FNS[("mla_split", bf)] = after if label == "after" else before
            got = run()
            if label == "after" or sum(n):
                torch.testing.assert_close(
                    ref.merge_partials_ref(*got, torch.float32),
                    ref.merge_partials_ref(*want, torch.float32),
                    rtol=2 ** -7, atol=1e-6)
            us = device_us(run, reps, ("k_mla",))
            if len(us) != reps:
                raise RuntimeError(f"{len(us)} k_mla events for {reps} "
                                   f"launches")
            times[label].append(sum(us) / len(us))
        dk._FNS[("mla_split", bf)] = after
        parts = sum(x.numel() * x.element_size() for x in got)
        nrows = sum(n)
        need = (valid.numel() + ((qa.numel() + qr.numel()) * 2 if nrows
                                 else 0)
                + nrows * (r + dr) * 2 + parts)
        # scores q.[ckv, krope] on the tensor cores; the value product
        # p.ckv with f32 p at the f32 rate, as chip_smoke's bound counts it
        ops_s = (2.0 * h * nrows * r / FP32_FLOP_PER_S
                 + 2.0 * h * nrows * (r + dr) / BF16_TENSOR_FLOP_PER_S)
        out[name] = dict(valid_rows=list(n), device_us=times,
                         bound_us=max(need / HBM_BYTES_PER_S, ops_s) * 1e6,
                         bound_by=("bytes" if need / HBM_BYTES_PER_S
                                   >= ops_s else "operations"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(os.path.abspath(args.tree), "src")]
    import torch
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
        us = device_us(lambda: dk.gqa_decode(q, k, v, valid, partials=True,
                                             **kw),
                       args.reps, ("k_gqa_split", "k_partial"))
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
    if hasattr(dk.mla_decode, "partial_launches"):
        out["mla"] = time_mla(dk, ref, args.reps, os.path.abspath(args.tree))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
