"""The scene-score kernel (#2, ``csrc/scene_score.cu``): what its division
gains, and the order of ``k_scene_sum``'s loads.

1. ``divide``: ``k_scene`` as it is (``div_fast``: the compiler's IEEE
   fast path without its range check and branch) against the same source
   with IEEE ``/`` for every pixel (``hsl<true>``), at 65 frames of 224²,
   warm (the same frames every call) and cold (4 copies in turn, 156 MB),
   in turns (A, B, B, A, A, B), each checked against the plain version.
   Then ``div_fast`` against ``/`` bit for bit: every float in [0, 6]
   divided by 6, and 2^30 random pairs with exponents within ±60.
2. ``k_scene_sum``'s SASS (always): no global load ahead of its
   ``griddepcontrol.wait`` (ACQBULK), or it could read partials that
   ``k_scene`` is still writing. The library's SASS goes to
   ``chiprun_out/scene_sass.txt``.

Needs an H100 and the CUDA toolkit. From the repo root:

    python3 tools/scene_times.py [divide]

Prints one line a reading and writes ``chiprun_out/scene_times.json``;
exits 1 where a load precedes the wait.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# the source with IEEE division for every pixel: (anchor, replacement)
IEEE = [("        hsl<false>(rgb[3 * k], rgb[3 * k + 1], rgb[3 * k + 2], "
         "fh[4 * i + k],", "        hsl<true>(rgb[3 * k], rgb[3 * k + 1], "
         "rgb[3 * k + 2], fh[4 * i + k],"),
        ("    if (!(lo >= 0.f && hi <= 1.0f && tiny >= 0x1p-60f)) {",
         "    if (false) {")]

_DIV_CHECK = r"""
__global__ void k_div6_check(unsigned hi, unsigned long long* bad) {
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u <= hi;
       u += gridDim.x * blockDim.x) {
    const float y = __uint_as_float(u);
    const float f = div_fast(y, 6.0f, 0x1.555556p-3f), e = y / 6.0f;
    if (__float_as_uint(f) != __float_as_uint(e))
      atomicAdd(bad + (y == 0.f || y >= 0x1p-60f ? 1 : 0), 1ull);
  }
}

__global__ void k_div_check(const unsigned* a, const unsigned* b, int n,
                            unsigned long long* bad) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(a[i]), y = __uint_as_float(b[i]);
    const float f = div_fast(x, y, rcp_approx(y)), e = x / y;
    if (__float_as_uint(f) != __float_as_uint(e)) atomicAdd(bad, 1ull);
  }
}
}  // namespace

extern "C" int scene_div_check(const unsigned* a, const unsigned* b, int n,
                               unsigned six_hi, unsigned long long* bad) {
  k_div_check<<<1024, 256>>>(a, b, n, bad);
  if (six_hi) k_div6_check<<<4096, 256>>>(six_hi, bad + 1);   // 2 counts
  return cudaGetLastError();
}
namespace {
"""


def device_ms(fn, reps: int = 40) -> float:
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


def build_edited(name: str, edits) -> str:
    """``scene_score.cu`` with each anchor (found exactly once) replaced,
    built with the port's nvcc flags → the library's path."""
    from repro_torch.kernels import build
    out_dir = os.path.join(build.BUILD_DIR, "scene_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC, "scene_score.cu")) as f:
        text = f.read()
    for anchor, repl in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor found {text.count(anchor)} "
                               f"times")
        text = text.replace(anchor, repl)
    cu = os.path.join(out_dir, f"scene_{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"libscene_{name}.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                   check=True, capture_output=True, text=True)
    return lib


def sass_order(lib_path: str) -> dict:
    """k_scene_sum's SASS: the line numbers of its global loads and of its
    first ACQBULK (griddepcontrol.wait)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    with open(os.path.join(ROOT, "chiprun_out", "scene_sass.txt"), "w") as f:
        f.write(out)
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "k_scene_sum" in line
        elif inside:
            body.append(line)
    acq = next((i for i, l in enumerate(body) if "ACQBULK" in l), None)
    loads = [i for i, l in enumerate(body) if "LDG" in l]
    return dict(acqbulk=acq, loads=loads,
                ok=acq is not None and all(i > acq for i in loads),
                load_lines=[body[i].strip() for i in loads])


def divide(out: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.core.scene import DEFAULT_WEIGHTS
    from repro_torch.data.video import VideoWorld, WorldConfig
    from repro_torch.kernels import ref, scene_score

    frames = torch.from_numpy(np.ascontiguousarray(VideoWorld(WorldConfig(
        n_scenes=3, resolution=224, seed=0)).frames[:65])).cuda()
    copies = [frames] + [frames.clone() for _ in range(3)]
    want = ref.scene_score_ref(frames, DEFAULT_WEIGHTS)
    scene_score._kernel_fn()
    fns = {"div_fast": scene_score._FN[0]}
    fn = ctypes.CDLL(build_edited("ieee", IEEE)).scene_score_f32
    fn.argtypes, fn.restype = scene_score._ARGTYPES, ctypes.c_int
    fns["ieee"] = fn
    turn = [0]

    def cold():
        turn[0] += 1
        return scene_score.scene_score(copies[turn[0] % 4], DEFAULT_WEIGHTS)
    rows = {name: dict(warm_us=[], cold_us=[]) for name in fns}
    try:
        for name in ("div_fast", "ieee", "ieee", "div_fast", "div_fast",
                     "ieee"):
            scene_score._FN[0] = fns[name]
            got = scene_score.scene_score(frames, DEFAULT_WEIGHTS)
            torch.cuda.synchronize()
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-7), name
            # div_fast gives the same bits as /, so both give the same phi
            first = rows[name].setdefault("phi", got)
            assert torch.equal(got, first) and torch.equal(
                got, rows.get("div_fast", {}).get("phi", got)), name
            rows[name]["warm_us"].append(1e3 * device_ms(
                lambda: scene_score.scene_score(frames, DEFAULT_WEIGHTS)))
            rows[name]["cold_us"].append(1e3 * device_ms(cold))
    finally:
        scene_score._FN[0] = fns["div_fast"]
    for row in rows.values():
        del row["phi"]
    out["divide_times"] = rows
    for name, row in rows.items():
        print(f"k_scene with {name}: warm {row['warm_us']} us  cold "
              f"{row['cold_us']} us", flush=True)

    # the same bits as IEEE division, where the kernel keeps div_fast
    check = ctypes.CDLL(build_edited("div_check", [(
        "}  // namespace\n", _DIV_CHECK + "}  // namespace\n")]))
    check = check.scene_div_check
    check.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_uint,
                                              ctypes.c_void_p]
    bad = torch.zeros(3, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    n, batches = 1 << 26, 16

    def operands():
        # sign, an exponent within +-60, a random mantissa
        e = torch.randint(127 - 60, 127 + 61, (n,), generator=gen,
                          device="cuda")
        m = torch.randint(0, 1 << 23, (n,), generator=gen, device="cuda")
        sg = torch.randint(0, 2, (n,), generator=gen, device="cuda")
        v = (sg << 31) | (e << 23) | m
        return (v - ((v >> 31) << 32)).to(torch.int32)   # the same bits
    for k in range(batches):
        x, y = operands(), operands()
        six = 0x40C00000 if k == 0 else 0                 # the bits of 6.0
        rc = check(x.data_ptr(), y.data_ptr(), n, six, bad.data_ptr())
        assert rc == 0, rc
    torch.cuda.synchronize()
    out["divide_bits"] = dict(random_pairs=n * batches,
                              random_mismatches=int(bad[0]),
                              six_values=0x40C00000 + 1,
                              six_mismatches_below_2_60=int(bad[1]),
                              six_mismatches_in_range=int(bad[2]))
    print(f"div_fast: {int(bad[0])} of {n * batches} random pairs differ "
          f"from IEEE division; floats in [0, 6] divided by 6: "
          f"{int(bad[2])} differ at 0 or >= 2^-60, {int(bad[1])} below "
          f"2^-60 (where the kernel divides with /)", flush=True)


def main(parts) -> int:
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = dict(card=card)
    if "divide" in parts:
        divide(out)
    out["sass"] = sass_order(build.build_all()["scene_score.cu"])
    print(f"k_scene_sum SASS: ACQBULK at {out['sass']['acqbulk']}, global "
          f"loads at {out['sass']['loads']}: "
          f"{'ok' if out['sass']['ok'] else 'A LOAD PRECEDES THE WAIT'}",
          flush=True)
    with open(os.path.join(ROOT, "chiprun_out", "scene_times.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0 if out["sass"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(set(sys.argv[1:])))
