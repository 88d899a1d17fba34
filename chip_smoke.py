#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Venus on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build      — compile the CUDA kernels from ``src/repro_torch/kernels/
                csrc`` (one nvcc per source, all started together) and the
                Triton scene-score kernel;
2. fused      — the fused retrieval kernel against its plain PyTorch
                version at S=16, N=8192, d=768, Q=8, T=32, K=8: f32, int8
                (from ``quantise_rows``) and wrapping (S, 2) ring windows.
                Integers equal; floats allclose (rtol 1e-5, atol 1e-6);
                draw targets kept ≥ 1e-6 from every CDF value;
3. similarity — the dense scan kernel (stack form) against its plain
                version at the same shapes, f32, int8 and windows, each
                with an all-invalid session: sims, m, l and the epilogue's
                probabilities allclose (rtol 1e-5, atol 1e-6), l = N and
                probs = 1/N for the empty session, and m, l bit-equal to
                the fused kernel's on the same inputs; then its 2-D form
                at Q=8, N=8192;
4. scene      — the scene-score kernel against its plain version on 65
                frames of 224×224 (rtol 1e-5, atol 1e-7);
5. main       — the main path through the user entry points: a
                ``SessionManager`` embedding with ``MEMEmbedder`` at
                venus-mem-large (bf16, random weights from a seed; d=768,
                capacity 8192) ingests 16 224² streams in ticks of 64
                frames, then answers 8 queries per session under akr,
                sampling and topk, and 8 text queries per session through
                the MEM text tower (one fused launch per group); every
                kernel must have launched in this run;
6. dense      — on the main manager: one group each of uniform, bolt,
                mdf and aks, and akr, sampling and topk with fused=False
                (one dense scan each), then ``memory.search`` once per
                session; the same akr/sampling/topk specs through the fused
                path give the share of equal frame ids (reported, not a
                gate);
7. main_int8  — the same streams through an int8 arena (``PixelEmbedder``
                for time);
8. mem        — MEM at smoke width in float32, card against the CPU with
                the same weights (allclose rtol 1e-4, atol 1e-5); at full
                width the card's bf16 embeddings of 4 frames and 4 texts
                against its float32 ones (cosine ≥ 0.9999);
9. parity     — a small input through the card and through the plain
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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: a sleep kernel holds the stream until every
    call is enqueued, so the launches run back to back and the host's
    time between them (the wrapper's Python) is not counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)       # ~50 ms at the H100's clock
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
        sims, m, l = ref.similarity_scan_stack_ref(query, index, valid,
                                                   tau=TAU)
        probs = ref.scan_probs(sims, m, l,
                               ref.as_valid_mask(valid, N)[:, None, :], TAU)
        del sims
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
        dev_ms = device_ms(run_k)
        plain = cuda_ms(run_p, reps=2)
        elt = index.element_size()
        nbytes = (S * N * D * elt + S * Q * D * 4 + valid.numel() * 4
                  + S * Q * T * 4 + S * Q * (2 * T + 2 * K + 3) * 4)
        flops = 2.0 * S * Q * N * D + 3.0 * S * N * D
        b, by = bound_ms(nbytes, flops)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, max_abs_err=err,
                         margin=margin)
        print(f"phase fused[{name}]: ok  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms)  plain "
              f"{plain:.4f} ms  bound {b:.4f} ms ({by})  max_abs_err "
              f"{err:.3e}  target margin {margin:.2e}", flush=True)
    return out


def _scan_check(name, got, want, valid, sessions_empty=()):
    """Kernel triple vs plain triple (+ the epilogue's probs of each):
    allclose at rtol 1e-5 / atol 1e-6; empty sessions give l = N and
    probs = 1/N. Returns the max abs error (l, a sum of N terms, is
    judged relative only)."""
    import torch
    from repro_torch.kernels import ref
    n = got[0].shape[-1]
    pk = ref.scan_probs(*got, valid, TAU)
    pp = ref.scan_probs(*want, valid, TAU)
    err = 0.0
    for f, a, b in (("sims", got[0], want[0]), ("m", got[1], want[1]),
                    ("l", got[2], want[2]), ("probs", pk, pp)):
        check(bool(torch.isfinite(a).all()), f"{name}: {f} not finite")
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
              f"{name}: {f} max abs err {float((a - b).abs().max())}")
        if f != "l":
            err = max(err, float((a - b).abs().max()))
    for si in sessions_empty:
        check(bool((got[2][si] == n).all()), f"{name}: empty l != N")
        check(torch.allclose(pk[si], torch.full_like(pk[si], 1.0 / n),
                             rtol=1e-6, atol=0), f"{name}: empty probs")
    return err


def phase_similarity(gen):
    """Kernel #3 (stack form) and #4 (2-D form) against their plain
    versions, and #3's m, l against the fused kernel's."""
    import torch
    from repro_torch.core.memory import quantise_rows
    from repro_torch.kernels import ref, similarity
    dev = torch.device("cuda")
    query = torch.randn((S, Q, D), generator=gen, device=dev)
    index32 = torch.randn((S, N, D), generator=gen, device=dev)
    index8 = torch.from_numpy(quantise_rows(index32.cpu().numpy())[0]).to(dev)
    sizes = torch.randint(N // 2, N + 1, (S,), generator=gen, device=dev,
                          dtype=torch.int32)
    sizes[0], sizes[1] = N, 0                      # session 1: all invalid
    starts = torch.randint(0, N, (S,), generator=gen, device=dev,
                           dtype=torch.int32)
    wins = torch.stack([starts, sizes], dim=1)
    check(bool(((starts + sizes) > N).any()), "a window wraps")
    cases = [("f32", index32, sizes), ("int8", index8, sizes),
             ("f32_windows", index32, wins)]
    out = {}
    for name, index, valid in cases:
        run_k = lambda: similarity.similarity_scan_stack(query, index, valid,
                                                         tau=TAU)
        run_p = lambda: ref.similarity_scan_stack_ref(query, index, valid,
                                                      tau=TAU)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        vmask = ref.as_valid_mask(valid, N)[:, None, :]
        err = _scan_check(f"similarity {name}", got, want, vmask, (1,))
        # the order of the stats: bit-equal to the fused kernel's m and l
        fr = similarity.fused_retrieve_scan_stack(
            query, index, valid, torch.zeros((S, Q, 1), device=dev),
            tau=TAU, n_topk=1)
        check(torch.equal(got[1], fr.m) and torch.equal(got[2], fr.l),
              f"similarity {name}: m, l differ from the fused kernel's")
        ms = cuda_ms(run_k, reps=50, warmup=3)
        dev_ms = device_ms(run_k)
        plain = cuda_ms(run_p, reps=3)
        # yardstick: one bmm over operands normalised beforehand (sims only)
        qn = similarity.unit_queries(query)
        xn = similarity.unit_queries(index)
        lib = cuda_ms(lambda: torch.bmm(qn, xn.transpose(1, 2)), reps=50,
                      warmup=3)
        del qn, xn
        elt = index.element_size()
        nbytes = (S * N * D * elt + S * Q * D * 4
                  + valid.numel() * valid.element_size()
                  + S * Q * N * 4 + 2 * S * Q * 4)
        b, by = bound_ms(nbytes, 2.0 * S * Q * N * D + 3.0 * S * N * D)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, library_ms=lib,
                         max_abs_err=err)
        print(f"phase similarity[{name}]: ok  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms)  plain "
              f"{plain:.4f} ms  bound {b:.4f} ms ({by})  bmm (sims only) "
              f"{lib:.4f} ms  max_abs_err {err:.3e}  m, l == fused",
              flush=True)
    # kernel #4: the 2-D form over one session's rows
    q2, x2 = query[0], index32[0]
    v2 = torch.arange(N, device=dev) < 6000
    run_k = lambda: similarity.similarity_scan(q2, x2, v2, tau=TAU)
    run_p = lambda: ref.similarity_scan_ref(q2, x2, v2, tau=TAU)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    err = _scan_check("similarity 2-D", got, want, v2[None, :])
    ms = cuda_ms(run_k, reps=50, warmup=3)
    dev_ms = device_ms(run_k)
    plain = cuda_ms(run_p, reps=5)
    qn, xn = similarity.unit_queries(q2), similarity.unit_queries(x2)
    lib = cuda_ms(lambda: torch.mm(qn, xn.t()), reps=50, warmup=3)
    b, by = bound_ms(N * D * 4 + Q * D * 4 + N + Q * N * 4 + 2 * Q * 4,
                     2.0 * Q * N * D + 3.0 * N * D)
    out["2d"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=lib, max_abs_err=err)
    print(f"phase similarity[2d]: ok  kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms)  plain "
          f"{plain:.4f} ms  bound {b:.4f} ms ({by})  mm (sims only) "
          f"{lib:.4f} ms  max_abs_err {err:.3e}", flush=True)
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
    dev_ms = device_ms(run_k)
    plain = cuda_ms(run_p, reps=3)
    t, h, w, _ = frames.shape
    b, by = bound_ms(t * h * w * 3 * 4 + t * 4, 40.0 * t * h * w)
    print(f"phase scene: ok  kernel {ms:.4f} ms (device {dev_ms:.4f} ms)"
          f"  plain {plain:.4f} ms  bound {b:.4f} ms ({by})  max_abs_err "
          f"{err:.3e}", flush=True)
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                bound_by=by, max_abs_err=err)


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


def unit_queries_np(n: int, dim: int, seed: int):
    import numpy as np
    qe = np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)
    return qe / np.linalg.norm(qe, axis=-1, keepdims=True)


def run_queries(mgr, n_sessions: int, dim: int):
    """8 queries per session under akr, sampling and topk, and 8 text
    queries per session (akr, embedded by the manager's embedder): four
    ``query_batch_cross`` calls, one execution group (one fused launch)
    each. Returns (per-group results, host-clock seconds of each)."""
    sids = [s for s in range(n_sessions) for _ in range(8)]
    qe = unit_queries_np(len(sids), dim, 5)
    texts = [f"what happens on camera {s} around event {j % 8}"
             for j, s in enumerate(sids)]
    results, qtimes = {}, {}
    for strat, kw in (("akr", dict(query_embs=qe)),
                      ("sampling", dict(query_embs=qe, budget=16,
                                        use_akr=False)),
                      ("topk", dict(query_embs=qe, budget=8,
                                    strategy="topk")),
                      ("text", dict(texts=texts))):
        t0 = time.perf_counter()
        results[strat] = mgr.query_batch_cross(sids, **kw)
        qtimes[strat] = time.perf_counter() - t0
    return results, qtimes


class TimedEmbedder:
    """Wraps an embedder and adds up the host-clock seconds and frames of
    its ``embed_frames`` calls (each ends in a device→host copy, so the
    device work is inside)."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0
        self.frames = 0

    def embed_frames(self, frames, aux_texts=None, frame_ids=None):
        t0 = time.perf_counter()
        out = self.inner.embed_frames(frames, aux_texts, frame_ids=frame_ids)
        self.seconds += time.perf_counter() - t0
        self.frames += len(out)
        return out

    def embed_queries(self, texts):
        return self.inner.embed_queries(texts)


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


DENSE_GROUPS = (("uniform", 16), ("bolt", 16), ("mdf", 16), ("aks", 16),
                ("akr", None), ("sampling", 16), ("topk", 8))


def phase_dense(mgr, worlds, card):
    """The dense query path on the main manager: one group per strategy
    through ``execute(plan, fused=False)`` (uniform, BOLT, MDF and AKS
    take the dense scan whatever the flag), then ``memory.search`` once
    per session, with the launch counts read around exactly that. Then
    the akr/sampling/topk specs again through the fused path (outside the
    count): the share of queries with equal frame ids."""
    import torch
    from repro_torch.core.queryplan import QuerySpec
    from repro_torch.kernels import ops
    sids = [s for s in range(len(worlds)) for _ in range(8)]
    qe = unit_queries_np(len(sids), D, 6)
    # explicit seeds: the fused comparison below sees the same keys
    specs = {name: [QuerySpec(sid=s, embedding=qe[j], strategy=name,
                              budget=b, seed=1000 + j)
                    for j, s in enumerate(sids)]
             for name, b in DENSE_GROUPS}
    secs, results = {}, {}
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    ops.reset_scan_counts()
    for name, _ in DENSE_GROUPS:
        t0 = time.perf_counter()
        results[name] = mgr.execute(mgr.plan(specs[name]), fused=False)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    searched = [mgr[sid].memory.search(qe[8 * sid:8 * sid + 8], tau=TAU)
                for sid in range(len(worlds))]
    torch.cuda.synchronize()
    secs["search"] = time.perf_counter() - t0
    launches = ops.kernel_launches()
    counts = ops.scan_counts()
    n_groups, n_sess = len(DENSE_GROUPS), len(worlds)
    check(launches["similarity_scan_stack"] == n_groups,
          f"one dense scan per group: {launches}")
    check(launches["similarity_scan"] == n_sess,
          f"one 2-D scan per search: {launches}")
    check(launches["fused_retrieve"] == 0, f"no fused launch: {launches}")
    check(counts["dense_score_launches"] == n_groups + n_sess
          and counts["fused_draw_launches"] == 0, f"scan counts {counts}")
    check(mgr.io_stats["stack_rebuilds"] == 0, "dense stack_rebuilds == 0")
    check_results(mgr, worlds, results, "dense")
    cap = mgr.cfg.memory_capacity
    for sid, (sims, probs) in enumerate(searched):
        check(sims.shape == probs.shape == (8, cap)
              and bool(torch.isfinite(probs).all()), f"search {sid} shape")
        check(torch.allclose(probs.sum(-1), torch.ones(8, device="cuda"),
                             atol=1e-4), f"search {sid}: probs sum to 1")
    same = {}
    for name in ("akr", "sampling", "topk"):
        fused = mgr.execute(mgr.plan(specs[name]))
        same[name] = sum(a.frame_ids.tolist() == b.frame_ids.tolist()
                         for a, b in zip(fused, results[name])) / len(fused)
    print(f"phase dense: ok  launches {launches}  seconds "
          f"{ {k: round(v, 6) for k, v in secs.items()} }  share of queries "
          f"with the fused path's frame ids {same}  [{card}]", flush=True)
    return dict(launches=launches, seconds=secs, same_as_fused=same)


def _mem_with_dtype(cfg, dtype: str):
    import dataclasses
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype=dtype),
        vision=dataclasses.replace(cfg.vision, dtype=dtype))


def _cosine(a, b):
    import numpy as np
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def phase_mem(mem, frames_np):
    """MEM on the card: at smoke width in float32 against the port on the
    CPU with the same weights; at full width the bf16 embeddings against
    float32 ones of the same weights, both on the card."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs.venus_mem import smoke_config
    from repro_torch.core.pipeline import MEMEmbedder
    from repro_torch.models.mem import MEM
    texts = ["a person opens the door", "red car", "",
             "two dogs run across the wet grass"]
    small = MEM.init(_mem_with_dtype(smoke_config(), "float32"), seed=1,
                     device="cpu")
    on_cpu = MEMEmbedder(small)
    on_card = MEMEmbedder(copy.deepcopy(small).to("cuda"))
    small_frames = frames_np[:3, :64, :64]
    err = 0.0
    for what, a, b in (
            ("frames", on_card.embed_frames(small_frames),
             on_cpu.embed_frames(small_frames)),
            ("texts", on_card.embed_queries(texts),
             on_cpu.embed_queries(texts))):
        check(np.allclose(a, b, rtol=1e-4, atol=1e-5),
              f"mem smoke {what}: max abs err {np.abs(a - b).max()}")
        err = max(err, float(np.abs(a - b).max()))
    full32 = MEM.init(_mem_with_dtype(mem.cfg, "float32"), device="cuda")
    full32.load_state_dict(mem.state_dict())
    frames = torch.from_numpy(frames_np[:4])
    cos = {}
    for what, run in (("frames", lambda e: e.embed_frames(frames)),
                      ("texts", lambda e: e.embed_queries(texts))):
        a, b = run(MEMEmbedder(mem)), run(MEMEmbedder(full32))
        check(a.shape == b.shape and np.isfinite(a).all(),
              f"mem full {what}: shape / finite")
        cos[what] = float(_cosine(a, b).min())
        check(cos[what] >= 0.9999, f"mem full {what}: bf16 vs f32 cosine "
              f"{cos[what]}")
    del full32
    print(f"phase mem: ok  smoke f32 card vs cpu max abs err {err:.3e}  "
          f"venus-mem-large bf16 vs f32 min cosine {cos}", flush=True)
    return dict(smoke_max_abs_err=err, full_min_cosine=cos)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.venus_mem import config as mem_config
    from repro_torch.core.pipeline import MEMEmbedder
    from repro_torch.core.session import VenusConfig
    from repro_torch.data.video import PixelEmbedder
    from repro_torch.kernels import build, ops
    from repro_torch.models.mem import MEM

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

    # 2-4. each kernel against its plain version
    fused = phase_fused(gen)
    sim = phase_similarity(gen)
    scene = phase_scene(frames65)

    # 5. the main path, with every launch counter read around it
    cfg = VenusConfig()
    t0 = time.perf_counter()
    mem = MEM.init(mem_config(), seed=0, device="cuda")
    embedder = TimedEmbedder(MEMEmbedder(mem))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ops.reset_kernel_launches()
    ops.reset_scan_counts()
    mgr, results, times = run_main_path(worlds, cfg, embedder, D, card,
                                        "main")
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    counts = ops.scan_counts()
    check(launches["fused_retrieve"] == 4,
          f"one fused launch per group: {launches}")
    check(launches["scene_score"] > 0, f"scene score launched: {launches}")
    check(counts["fused_draw_launches"] == 4, f"scan counts {counts}")
    check(mgr.io_stats["stack_rebuilds"] == 0, "stack_rebuilds == 0")
    check(mgr.arena.emb.shape == (S, cfg.memory_capacity, D),
          f"arena shape {tuple(mgr.arena.emb.shape)}")
    check_results(mgr, worlds, results, "main")
    n_emb = sum(mgr[s].stats["frames_embedded"] for s in range(S))
    check(embedder.frames == n_emb, f"embedded {embedder.frames} != {n_emb}")
    rows = [mgr[s].memory.size for s in range(S)]
    times["embed"] = dict(seconds=embedder.seconds, frames=n_emb,
                          frames_per_s=n_emb / embedder.seconds,
                          init_seconds=t_init)
    print(f"phase main: ok  launches {launches}  stack_rebuilds 0  "
          f"rows per session {rows}  MEM embed (venus-mem-large, bf16) "
          f"{embedder.seconds:.3f} s for {n_emb} frames = "
          f"{n_emb / embedder.seconds:.1f} frames/s (init {t_init:.2f} s) "
          f"[{card}]", flush=True)

    # 6. the dense query path on the main manager
    dense = phase_dense(mgr, worlds, card)
    del mgr

    # 7. the int8 arena
    ops.reset_kernel_launches()
    mgr8, res8, _ = run_main_path(
        worlds, VenusConfig(index_dtype="int8"), PixelEmbedder(dim=D), D,
        card, "main_int8")
    l8 = ops.kernel_launches()
    check(l8["fused_retrieve"] == 4 and l8["scene_score"] > 0,
          f"int8 launches {l8}")
    check(mgr8.io_stats["stack_rebuilds"] == 0, "int8 stack_rebuilds")
    check_results(mgr8, worlds, res8, "main_int8")
    print(f"phase main_int8: ok  launches {l8}", flush=True)
    del mgr8

    # 8. MEM card vs CPU, and bf16 vs f32
    mem_out = phase_mem(mem, worlds[1].frames[:4])
    del mem, embedder

    # 9. a small input through the card and through the plain versions
    phase_parity()

    dl = dense["launches"]

    def scan_row(name, replaces, r, n_launch):
        return dict(name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/similarity_scan.cu",
                    replaces=replaces, launches=n_launch,
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    device_ms=r["device_ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    library_note="torch.bmm/mm over operands normalised "
                                 "beforehand: sims only")
    stack_row = scan_row("similarity_scan_stack",
                         "src/repro/kernels/similarity.py:244", sim["f32"],
                         dl["similarity_scan_stack"])
    stack_row.update(
        max_abs_err=max(sim[c]["max_abs_err"]
                        for c in ("f32", "int8", "f32_windows")),
        int8_ms=sim["int8"]["ms"], int8_device_ms=sim["int8"]["device_ms"],
        int8_bound_ms=sim["int8"]["bound_ms"],
        int8_library_ms=sim["int8"]["library_ms"],
        windows_ms=sim["f32_windows"]["ms"])
    kernels = [dict(
        name="fused_retrieve", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_retrieve.cu",
        replaces="src/repro/kernels/similarity.py:422",
        launches=launches["fused_retrieve"],
        max_abs_err=max(v["max_abs_err"] for v in fused.values()),
        ms=fused["f32"]["ms"], device_ms=fused["f32"]["device_ms"],
        plain_ms=fused["f32"]["plain_ms"],
        bound_ms=fused["f32"]["bound_ms"], bound_by=fused["f32"]["bound_by"],
        library_ms=None, int8_ms=fused["int8"]["ms"],
        int8_device_ms=fused["int8"]["device_ms"],
        int8_bound_ms=fused["int8"]["bound_ms"],
        windows_ms=fused["f32_windows"]["ms"]),
        stack_row,
        scan_row("similarity_scan", "src/repro/kernels/similarity.py:148",
                 sim["2d"], dl["similarity_scan"]),
        dict(name="scene_score", route="triton",
             source="src/repro_torch/kernels/scene_score.py",
             replaces="src/repro/kernels/scene_score.py:75",
             launches=launches["scene_score"],
             max_abs_err=scene["max_abs_err"], ms=scene["ms"],
             device_ms=scene["device_ms"],
             plain_ms=scene["plain_ms"], bound_ms=scene["bound_ms"],
             bound_by=scene["bound_by"], library_ms=None)]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, fused=fused,
                       similarity=sim, scene=scene, main=times, dense=dense,
                       mem=mem_out), f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
