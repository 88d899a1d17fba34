"""The fused retrieval kernel (#1, ``csrc/fused_retrieve.cu``): where its
device time goes, in the tree it is run against.

1. At the table's shape (S=16, Q=8, N=8192, d=768, T=32, K=8; session 0
   full, the others holding N/2..N valid rows, drawn as ``chip_smoke.py``'s
   fused phase draws them) in f32 and int8: each kernel's device µs per
   launch by the profiler (a PDL'd kernel's span starts while the kernel
   before it runs, so the spans overlap; ``covered_us`` counts each instant
   once), and the wrapper's device ms per call (CUDA events around calls
   queued behind a sleep kernel). The dense stack scan (#3,
   ``similarity_scan_stack``) on the same inputs, the same way.
2. ``--main``: the main phase of ``chip_smoke.py`` (16 streams of 224²
   frames ingested through the MEM embedder at venus-mem-large, bf16), then
   its four query groups (one fused launch each) under the profiler: #1's
   device µs per launch there, on the first pass as the main phase runs it
   and on a second pass.
3. SASS (always): every kernel of ``fused_retrieve.cu`` and
   ``similarity_scan.cu`` that waits on ``griddepcontrol.wait`` (ACQBULK)
   issues no global load or copy (LDG, LDGSTS, generic LD) ahead of it, or
   it could read what the kernel before it is still writing. The SASS goes
   to ``chiprun_out/fused_sass_<label>.txt``.

Needs an H100 and the CUDA toolkit. From the repo root:

    python3 tools/fused_times.py [--tree DIR] [--label NAME] [--main]

``--tree`` runs another checkout's package and ``chip_smoke.py`` (an
unpacked ``git archive`` of the parent commit, say) with this script, so
two versions are read the same way. Prints one line a reading and writes
``chiprun_out/fused_times_<label>.json``; exits 1 where a load precedes
the wait.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
S, N, D, Q, T, K = 16, 8192, 768, 8, 32, 8
TAU = 0.1
# #1's kernels (every version's) by name
FUSED_KERNELS = re.compile(r"\bk_(stats|chunk|fold|draws|scores|finish)\b")


def device_ms(fn, reps: int = 20) -> float:
    """Device ms a call: the calls queued behind a sleep kernel, CUDA
    events around them."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def covered_us(events) -> float:
    """Device µs the events' intervals cover, each instant once."""
    covered, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            covered += b - max(a, end)
            end = b
    return covered


def traced(fn, calls: int, pick=None, tries: int = 3, warm: bool = True):
    """The device events of ``calls`` calls of ``fn`` (those whose name
    ``pick`` matches, if given), by the profiler, after one call outside
    the trace where ``warm``; None where ``tries`` traces hold no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
        torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kern:
            return [e for e in kern if pick is None or pick.search(e.name)]
    return None


def per_kernel(events, calls: int) -> dict:
    """µs a call of each kernel (by its ``k_*`` name), their launches a
    call, and the µs a call they cover together."""
    from collections import defaultdict
    tot, n = defaultdict(float), defaultdict(int)
    for e in events:
        m = re.search(r"\bk_\w+", e.name)
        name = m.group(0) if m else e.name[:60]
        tot[name] += e.time_range.elapsed_us()
        n[name] += 1
    return dict(us={k: tot[k] / calls for k in sorted(tot)},
                launches={k: n[k] / calls for k in sorted(n)},
                covered_us=covered_us(events) / calls)


def table_inputs():
    """The fused phase's inputs at the table's shape (its generator and
    order of draws); targets uniform on the 2^20 grid."""
    import torch
    from repro_torch.core.memory import quantise_rows
    from repro_torch.kernels.draws import draw_targets
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    query = torch.randn((S, Q, D), generator=gen, device=dev)
    index32 = torch.randn((S, N, D), generator=gen, device=dev)
    index8 = torch.from_numpy(quantise_rows(index32.cpu().numpy())[0]).to(dev)
    sizes = torch.randint(N // 2, N + 1, (S,), generator=gen, device=dev,
                          dtype=torch.int32)
    sizes[0] = N
    targets = draw_targets(torch.randint(0, 1 << 20, (S, Q, T),
                                         generator=gen, device=dev))
    return query, index32, index8, sizes, targets


def table(out: dict) -> None:
    import torch
    from repro_torch.kernels import similarity
    query, index32, index8, sizes, targets = table_inputs()
    rows = int(sizes.sum())
    for name, index in (("f32", index32), ("int8", index8)):
        fused = lambda: similarity.fused_retrieve_scan_stack(
            query, index, sizes, targets, tau=TAU, n_topk=K)
        stack = lambda: similarity.similarity_scan_stack(query, index, sizes,
                                                         tau=TAU)
        row = {}
        for what, fn in (("fused", fused), ("stack", stack)):
            pick = FUSED_KERNELS if what == "fused" else re.compile(r"\bk_")
            ev = traced(fn, 20, pick)
            row[what] = dict(device_ms=[device_ms(fn), device_ms(fn)],
                             kernels=None if ev is None
                             else per_kernel(ev, 20))
            k = row[what]["kernels"]
            print(f"{name} {what}: device "
                  + " / ".join(f"{t:.4f}" for t in row[what]["device_ms"])
                  + " ms a call; "
                  + ("no device events in the trace" if k is None else
                     "  ".join(f"{n} {u:.2f} us" for n, u in k["us"].items())
                     + f"  (covered {k['covered_us']:.2f} us)"), flush=True)
        row["elt"] = index.element_size()
        row["valid_rows"] = rows
        out[name] = row
        torch.cuda.synchronize()


def main_phase(out: dict) -> None:
    """The main phase's ingest, then its query groups under the profiler
    (first pass, as chip_smoke.py's main phase runs them, then again)."""
    import torch
    import chip_smoke
    from repro_torch.configs.venus_mem import config as mem_config
    from repro_torch.core.pipeline import MEMEmbedder
    from repro_torch.core.session import VenusConfig
    from repro_torch.kernels import similarity
    from repro_torch.models.mem import MEM
    worlds = chip_smoke.make_worlds(S, 224)
    mem = MEM.init(mem_config(), seed=0, device="cuda")
    mgr, _, _ = chip_smoke.ingest_streams(worlds, VenusConfig(),
                                          MEMEmbedder(mem), D, "cuda")
    passes = []
    for _ in range(2):
        before = similarity.fused_retrieve_scan_stack.launches
        ev = traced(lambda: chip_smoke.run_queries(mgr, S, D), 1,
                    FUSED_KERNELS, tries=1, warm=False)
        n = similarity.fused_retrieve_scan_stack.launches - before
        if ev is None:
            passes.append(dict(launches=n, kernels=None))
            print(f"main pass {len(passes)}: no device events in the trace",
                  flush=True)
            continue
        k = per_kernel(ev, n)
        passes.append(dict(launches=n, kernels=k,
                           device_us=k["covered_us"] * n))
        print(f"main pass {len(passes)}: {n} launches, "
              f"{k['covered_us']:.2f} device us a launch "
              f"({k['covered_us'] * n:.2f} us in all): "
              + "  ".join(f"{m} {u:.2f}" for m, u in k["us"].items()),
              flush=True)
    out["main"] = dict(rows=[mgr[s].memory.size for s in range(S)],
                       passes=passes)


def sass_order(lib_path: str, label: str) -> dict:
    """Each kernel of the library: the line of its first ACQBULK and of
    every global load or copy before it."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(OUT, f"fused_sass_{label}.txt"), "a") as f:
        f.write(text)
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    load = re.compile(r"\b(LDG|LDGSTS|LD)\b")
    res = {}
    for name, body in funcs.items():
        acq = next((i for i, l in enumerate(body) if "ACQBULK" in l), None)
        early = [body[i].strip() for i in range(acq or 0)
                 if load.search(body[i])]
        res[name] = dict(waits=acq is not None, loads_before_wait=early)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--main", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.makedirs(OUT, exist_ok=True)
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}  tree {tree}", flush=True)
    out = dict(card=card, tree=tree, label=args.label)
    libs = build.build_all()
    table(out)
    if args.main:
        main_phase(out)
    open(os.path.join(OUT, f"fused_sass_{args.label}.txt"), "w").close()
    sass = {}
    for src in ("fused_retrieve.cu", "similarity_scan.cu"):
        for name, r in sass_order(libs[src], args.label).items():
            sass[f"{src}:{name}"] = r
            print(f"SASS {src} {name}: "
                  + ("no griddepcontrol.wait" if not r["waits"] else
                     "ok" if not r["loads_before_wait"] else
                     f"LOADS BEFORE THE WAIT {r['loads_before_wait']}"),
                  flush=True)
    out["sass"] = sass
    with open(os.path.join(OUT, f"fused_times_{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0 if all(not r["loads_before_wait"] for r in sass.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
