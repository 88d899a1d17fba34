#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Venus on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, all started together) and the Triton
             scene-score kernel;
2. fused   — the fused retrieval kernel against its plain PyTorch version
             at S=16, N=8192, d=768, Q=8, T=32, K=8: f32, int8 (from
             ``quantise_rows``) and wrapping (S, 2) ring windows. Integers
             equal; floats allclose (rtol 1e-5, atol 1e-6); draw targets
             kept ≥ 1e-6 from every CDF value;
3. scene   — the scene-score kernel against its plain version on 65
             frames of 224×224 (rtol 1e-5, atol 1e-7);
4. main    — the main path through the user entry points: a
             ``SessionManager`` at venus-mem-large width (d=768, capacity
             8192) ingests 16 224² streams in ticks of 64 frames, then
             answers 8 queries per session under akr, sampling and topk
             (one fused launch each); every kernel must have launched in
             this run. Then the same streams through an int8 arena;
5. parity  — a small input through the card and through the plain
             versions on the CPU: the same partitions, clusters and
             reservoirs, and identical frame ids when both query the
             same memory.

Prints the card's name and power limit, one line per phase, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, fp32 outside tensor cores
S, N, D, Q, T, K = 16, 8192, 768, 8, 32, 8
TAU = 0.1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bytes_moved: float, flops: float):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def margin_targets(probs, gen, n_targets: int, margin: float = 1e-6):
    """(S,Q,T) targets on the 2^20 grid, each ≥ ``margin`` away from every
    value of the lane's canonical CDF (so float drift between kernel and
    plain version cannot move a draw)."""
    import torch
    from repro_torch.kernels.draws import blockwise_cdf, draw_targets
    cdf = blockwise_cdf(probs)                               # (S,Q,N)
    cand = draw_targets(torch.randint(
        0, 1 << 20, probs.shape[:2] + (8 * n_targets,), generator=gen,
        device=probs.device))
    idx = torch.searchsorted(cdf.contiguous(), cand.contiguous())
    hi = torch.gather(cdf, -1, idx.clamp(max=cdf.shape[-1] - 1))
    lo = torch.gather(cdf, -1, (idx - 1).clamp(min=0))
    gap = torch.minimum(torch.where(idx < cdf.shape[-1], hi - cand,
                                    torch.full_like(cand, 1.0)),
                        torch.where(idx > 0, cand - lo,
                                    torch.full_like(cand, 1.0)))
    ok = gap.abs() >= margin
    check(bool((ok.sum(-1) >= n_targets).all()),
          "not enough targets clear of the CDF")
    order = torch.argsort((~ok).to(torch.int8), dim=-1, stable=True)
    t = torch.gather(cand, -1, order[..., :n_targets])
    g = torch.gather(gap.abs(), -1, order[..., :n_targets])
    check(float(g.min()) >= margin, "target margin")
    return t, float(g.min())


def phase_fused(gen):
    import torch
    from repro_torch.core.memory import quantise_rows
    from repro_torch.kernels import ops, ref, similarity
    dev = torch.device("cuda")
    query = torch.randn((S, Q, D), generator=gen, device=dev)
    index32 = torch.randn((S, N, D), generator=gen, device=dev)
    index8 = torch.from_numpy(quantise_rows(index32.cpu().numpy())[0]).to(dev)
    sizes = torch.randint(N // 2, N + 1, (S,), generator=gen, device=dev,
                          dtype=torch.int32)
    sizes[0] = N
    starts = torch.randint(0, N, (S,), generator=gen, device=dev,
                           dtype=torch.int32)
    wins = torch.stack([starts, sizes], dim=1)
    check(bool(((starts + sizes) > N).any()), "a window wraps")
    cases = [("f32", index32, sizes), ("int8", index8, sizes),
             ("f32_windows", index32, wins)]
    out = {}
    for name, index, valid in cases:
        _, probs = ref.similarity_stack_ref(query, index, tau=TAU,
                                            valid=valid)
        targets, margin = margin_targets(probs, gen, T)
        del probs
        run_k = lambda: similarity.fused_retrieve_scan_stack(
            query, index, valid, targets, tau=TAU, n_topk=K)
        run_p = lambda: ref.fused_retrieve_stack_ref(
            query, index, valid, targets, tau=TAU, n_topk=K)
        got, want = ops.finalize(run_k(), N), ops.finalize(run_p(), N)
        torch.cuda.synchronize()
        for f in ("draws", "topk_i"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"fused {name}: {f} differ in "
                  f"{int((getattr(got, f) != getattr(want, f)).sum())} "
                  f"places")
        err = 0.0
        for f in ("drawn_p", "topk_v", "m", "l", "p_max"):
            a, b = getattr(got, f), getattr(want, f)
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                  f"fused {name}: {f} max abs err "
                  f"{float((a - b).abs().max())}")
            if f != "l":     # l sums N terms: judged relative, above
                err = max(err, float((a - b).abs().max()))
        ms = cuda_ms(run_k, reps=10, warmup=2)
        plain = cuda_ms(run_p, reps=2)
        elt = index.element_size()
        nbytes = (S * N * D * elt + S * Q * D * 4 + valid.numel() * 4
                  + S * Q * T * 4 + S * Q * (2 * T + 2 * K + 3) * 4)
        flops = 2.0 * S * Q * N * D + 3.0 * S * N * D
        b, by = bound_ms(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                         max_abs_err=err, margin=margin)
        print(f"phase fused[{name}]: ok  kernel {ms:.4f} ms  plain "
              f"{plain:.4f} ms  bound {b:.4f} ms ({by})  max_abs_err "
              f"{err:.3e}  target margin {margin:.2e}", flush=True)
    return out


def make_worlds(n: int, resolution: int):
    from repro_torch.data.video import VideoWorld, WorldConfig
    return [VideoWorld(WorldConfig(n_scenes=3, resolution=resolution,
                                   seed=s)) for s in range(n)]


def phase_scene(frames_np):
    import torch
    from repro_torch.core.scene import DEFAULT_WEIGHTS
    from repro_torch.kernels import ref, scene_score
    frames = torch.from_numpy(frames_np).cuda()
    run_k = lambda: scene_score.scene_score(frames, DEFAULT_WEIGHTS)
    run_p = lambda: ref.scene_score_ref(frames, DEFAULT_WEIGHTS)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          "scene: shape / finite")
    check(float(got[0]) == 0.0, f"scene: phi_0 = {float(got[0])}")
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-7),
          f"scene: max abs err {float((got - want).abs().max())}")
    err = float((got - want).abs().max())
    ms = cuda_ms(run_k, reps=20, warmup=2)
    plain = cuda_ms(run_p, reps=3)
    t, h, w, _ = frames.shape
    b, by = bound_ms(t * h * w * 3 * 4 + t * 4, 40.0 * t * h * w)
    print(f"phase scene: ok  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
          f"bound {b:.4f} ms ({by})  max_abs_err {err:.3e}", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                max_abs_err=err)


def ingest_streams(worlds, cfg, embedder, dim, device, *, chunk=64):
    """Each world is its own session, fed in ticks of ``chunk`` frames;
    returns (manager, host-clock seconds of each tick)."""
    import torch
    from repro_torch.core.session import SessionManager
    mgr = SessionManager(cfg, embedder, embed_dim=dim, device=device)
    for sid in range(len(worlds)):
        mgr.create_session(sid)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ticks, stages = [], {"segment": 0.0, "cluster": 0.0, "embed_insert": 0.0}
    longest = max(w.total_frames for w in worlds)
    for i in range(0, longest, chunk):
        chunks = {sid: w.frames[i:i + chunk] for sid, w in enumerate(worlds)
                  if i < w.total_frames}
        sync()
        t0 = time.perf_counter()
        got = mgr.ingest_tick(chunks)
        sync()
        ticks.append(time.perf_counter() - t0)
        for k in stages:
            stages[k] += got[k]
    mgr.flush()
    sync()
    return mgr, ticks, stages


def run_queries(mgr, n_sessions: int, dim: int):
    """8 queries per session under akr, sampling and topk: three
    ``query_batch_cross`` calls, one execution group (one fused launch)
    each. Returns (per-strategy results, host-clock seconds of each)."""
    import numpy as np
    rng = np.random.default_rng(5)
    sids = [s for s in range(n_sessions) for _ in range(8)]
    qe = rng.standard_normal((len(sids), dim)).astype(np.float32)
    qe /= np.linalg.norm(qe, axis=-1, keepdims=True)
    results, qtimes = {}, {}
    for strat, kw in (("akr", {}),
                      ("sampling", dict(budget=16, use_akr=False)),
                      ("topk", dict(budget=8, strategy="topk"))):
        t0 = time.perf_counter()
        results[strat] = mgr.query_batch_cross(sids, query_embs=qe, **kw)
        qtimes[strat] = time.perf_counter() - t0
    return results, qtimes


def run_main_path(worlds, cfg, embedder, dim, card, label):
    mgr, ticks, stages = ingest_streams(worlds, cfg, embedder, dim, "cuda")
    results, qtimes = run_queries(mgr, len(worlds), dim)
    print(f"phase {label}: ingest ticks (s) {[round(x, 6) for x in ticks]}"
          f"  by stage (s) { {k: round(v, 6) for k, v in stages.items()} }"
          f"  queries (s) { {k: round(v, 6) for k, v in qtimes.items()} }"
          f"  [{card}]", flush=True)
    return mgr, results, dict(ticks=ticks, stages=stages, queries=qtimes)


def phase_parity():
    """The same small input through the card and through the plain
    versions on the CPU. Ingest: identical partitions, clusters and
    reservoirs; index frames identical except where a two-member
    cluster's members are equidistant from its centroid (an exact tie
    that rounding breaks, differently on each device); embeddings of the
    same frame allclose. Query: both routes over the card's memory give
    identical frame ids."""
    import numpy as np
    import torch
    from repro_torch.core.convert import arena_from_numpy
    from repro_torch.core.session import VenusConfig
    from repro_torch.data.video import PixelEmbedder
    from repro_torch.kernels import prng
    small = make_worlds(2, 64)
    cfg = VenusConfig(memory_capacity=512)
    card_mgr, _, _ = ingest_streams(small, cfg, PixelEmbedder(dim=64), 64,
                                    "cuda")
    cpu_mgr, _, _ = ingest_streams(small, cfg, PixelEmbedder(dim=64), 64,
                                   "cpu")
    a, b = card_mgr.arena, cpu_mgr.arena
    check(np.array_equal(a.sizes, b.sizes), "parity: rows per session")
    for f in ("members", "member_count"):
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
              f"parity: {f}")
    same = a.index_frame.cpu() == b.index_frame
    check(bool((same | (b.member_count == 2)).all()),
          "parity: index frames differ outside two-member ties")
    check(torch.allclose(a.emb.cpu()[same], b.emb[same], rtol=1e-5,
                         atol=1e-6), "parity: embeddings")
    arrays = dict(emb=a.emb.cpu().numpy(), members=a.members.cpu().numpy(),
                  member_count=a.member_count.cpu().numpy(),
                  index_frame=a.index_frame.cpu().numpy(), sizes=a.sizes,
                  heads=a.heads, keys=np.stack([prng.key(cfg.seed)] * 2))
    on_card, _ = run_queries(card_mgr, 2, 64)
    twin = arena_from_numpy(cfg, PixelEmbedder(dim=64), device="cpu",
                            **arrays)
    on_cpu, _ = run_queries(twin, 2, 64)
    for strat in on_card:
        for x, y in zip(on_card[strat], on_cpu[strat]):
            check(x.frame_ids.tolist() == y.frame_ids.tolist()
                  and x.n_drawn == y.n_drawn,
                  f"parity {strat}: card {x.frame_ids} vs cpu {y.frame_ids}")
    ties = int((~same).sum())
    print(f"phase parity: ok  ingest equal ({ties} two-member index-frame "
          f"ties broken differently)  card == cpu frame ids for akr, "
          f"sampling, topk", flush=True)


def check_results(mgr, worlds, results, label):
    for strat, res in results.items():
        check(len(res) == 8 * len(worlds), f"{label}: {strat} result count")
        for j, r in enumerate(res):
            sid = j // 8
            seen = mgr[sid].stats["frames_seen"]
            f = r.frame_ids
            check(len(f) > 0, f"{label}: {strat} query {j} returned nothing")
            check(bool(((f >= 0) & (f < seen)).all()),
                  f"{label}: {strat} frame ids outside [0, {seen})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.session import VenusConfig
    from repro_torch.data.video import PixelEmbedder
    from repro_torch.kernels import build, ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # 1. build: nvcc for every CUDA source (in parallel), Triton at the
    #    first scene-score launch
    t0 = time.perf_counter()
    build.build_all()
    t_nvcc = time.perf_counter() - t0
    for src, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas[{src}]: {line.strip()}")
    t0 = time.perf_counter()
    worlds = make_worlds(S, 224)
    t_worlds = time.perf_counter() - t0
    frames65 = worlds[0].frames[:65]
    t0 = time.perf_counter()
    from repro_torch.core.scene import DEFAULT_WEIGHTS
    from repro_torch.kernels import scene_score
    scene_score.scene_score(torch.from_numpy(frames65).cuda(),
                            DEFAULT_WEIGHTS)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"phase build: ok  nvcc {t_nvcc:.2f} s  triton first launch "
          f"{t_triton:.2f} s  (worlds generated in {t_worlds:.2f} s)",
          flush=True)

    # 2-3. each kernel against its plain version
    fused = phase_fused(gen)
    scene = phase_scene(frames65)

    # 4. the main path, with every launch counter read around it
    cfg = VenusConfig()
    ops.reset_kernel_launches()
    ops.reset_scan_counts()
    mgr, results, times = run_main_path(worlds, cfg, PixelEmbedder(dim=D),
                                        D, card, "main")
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    counts = ops.scan_counts()
    check(launches["fused_retrieve"] == 3,
          f"one fused launch per group: {launches}")
    check(launches["scene_score"] > 0, f"scene score launched: {launches}")
    check(counts["fused_draw_launches"] == 3, f"scan counts {counts}")
    check(mgr.io_stats["stack_rebuilds"] == 0, "stack_rebuilds == 0")
    check(mgr.arena.emb.shape == (S, cfg.memory_capacity, D),
          f"arena shape {tuple(mgr.arena.emb.shape)}")
    check_results(mgr, worlds, results, "main")
    rows = [mgr[s].memory.size for s in range(S)]
    print(f"phase main: ok  launches {launches}  stack_rebuilds 0  "
          f"rows per session {rows}", flush=True)
    del mgr

    ops.reset_kernel_launches()
    mgr8, res8, _ = run_main_path(
        worlds, VenusConfig(index_dtype="int8"), PixelEmbedder(dim=D), D,
        card, "main_int8")
    l8 = ops.kernel_launches()
    check(l8["fused_retrieve"] == 3 and l8["scene_score"] > 0,
          f"int8 launches {l8}")
    check(mgr8.io_stats["stack_rebuilds"] == 0, "int8 stack_rebuilds")
    check_results(mgr8, worlds, res8, "main_int8")
    print(f"phase main_int8: ok  launches {l8}", flush=True)
    del mgr8

    # 5. a small input through the card and through the plain versions
    phase_parity()

    kernels = [dict(
        name="fused_retrieve", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_retrieve.cu",
        replaces="src/repro/kernels/similarity.py:422",
        launches=launches["fused_retrieve"],
        max_abs_err=max(v["max_abs_err"] for v in fused.values()),
        ms=fused["f32"]["ms"], plain_ms=fused["f32"]["plain_ms"],
        bound_ms=fused["f32"]["bound_ms"], bound_by=fused["f32"]["bound_by"],
        library_ms=None, int8_ms=fused["int8"]["ms"],
        int8_bound_ms=fused["int8"]["bound_ms"],
        windows_ms=fused["f32_windows"]["ms"]),
        dict(name="scene_score", route="triton",
             source="src/repro_torch/kernels/scene_score.py",
             replaces="src/repro/kernels/scene_score.py:75",
             launches=launches["scene_score"],
             max_abs_err=scene["max_abs_err"], ms=scene["ms"],
             plain_ms=scene["plain_ms"], bound_ms=scene["bound_ms"],
             bound_by=scene["bound_by"], library_ms=None)]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, fused=fused, scene=scene,
                       main=times), f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
