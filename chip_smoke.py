#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Venus on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero), run in the order 1–4, 10, 5, 6, 11,
12, 7–9:

1. build      — compile the CUDA kernels from ``src/repro_torch/kernels/
                csrc`` (one nvcc per source, all started together);
2. fused      — the fused retrieval kernel against its plain PyTorch
                version at S=16, N=8192, d=768, Q=8, T=32, K=8: f32, int8
                (from ``quantise_rows``) and wrapping (S, 2) ring windows;
                then the edge cases of ``scan_edge_cases`` (S=4, N=1000:
                d=6 and d=770, and d=768 from an unaligned index view, f32
                and int8). Integers equal; floats allclose (rtol 1e-5,
                atol 1e-6); draw targets kept ≥ 1e-6 from every CDF value;
3. similarity — the dense scan kernel (stack form) against its plain
                version at the same shapes, f32, int8 and windows, and the
                fused phase's edge cases, each
                with an all-invalid session: sims, m, l and the epilogue's
                probabilities allclose (rtol 1e-5, atol 1e-6), l = N and
                probs = 1/N for the empty session, and m, l bit-equal to
                the fused kernel's on the same inputs; then the 2-D form's
                own kernels at Q=8, N=8192 (6,000 valid rows; timed
                beside torch.mm), int8, Q=20, N=300 and an all-invalid
                mask (l = N), each checked to have launched;
4. scene      — the scene-score kernel (``csrc/scene_score.cu``) against
                its plain version (rtol 1e-5, atol 1e-7, φ_0 == 0 exactly)
                on 65 frames of 224×224 (timed warm and cold), random
                frames with a grey block and two identical frames, T = 1,
                T = 2, 37×53 and an unaligned base (4-byte copies), 65
                frames of 448², with ``prev`` as the segmenter calls it,
                frames that take the exact divisions, and rows of 2,100
                to 4,150 pixels (32 pixels a thread, 3 and 2 ring
                stages, 16- and 4-byte copies); each case checked to
                have launched the kernel on the plan it names;
5. main       — the main path through the user entry points: a
                ``SessionManager`` embedding with ``MEMEmbedder`` at
                venus-mem-large (bf16, random weights from a seed; d=768,
                capacity 8192) ingests 16 224² streams in ticks of 64
                frames, then answers 8 queries per session under akr,
                sampling and topk, and 8 text queries per session through
                the MEM text tower (one fused launch per group); every
                kernel must have launched in this run; the ingest runs
                under the profiler (device activity only), which gives
                #2's device time over its launches there (each must show
                in the trace); then tick 1's segment stage replayed with
                the device synchronised between upload, #2 and the φ
                read back;
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
                same memory;
10. decode    — the two decode-attention kernels against their plain
                versions at the serving shapes (B=4 slots, C=2048 cache
                rows, bf16 and f32; per-slot ragged masks with one slot of
                a single valid row and one with none): GQA at Qwen2-VL-7B
                (H=28, Hkv=4, D=128; also softcap 30 and q_per_kv=1; in
                bf16 also masks with holes of whole tiles and a last-row
                mask, C=2000, and G=16 at H=32, Hkv=2; and the shapes
                k_gqa_split leaves to k_partial: bf16 G=32 at H=32,
                Hkv=1, bf16 D=72, f32 D=6, and H=128, Hkv=1, D=512,
                which it takes 64 heads to a block); MLA at MiniCPM3-4B
                (H=40, R=256, Dr=32: bf16 on k_mla with the table's masks,
                holes, C=2000 and the serve phase's 9-76 rows a slot, f32
                on k_partial), DeepSeek-V2-Lite (H=16, R=512, Dr=64),
                DeepSeek-V3's 128 heads and R=30 (k_partial), checked
                only. Each case checks by the wrapper's route count that
                its route's kernel launched, and records each kernel's
                device µs per launch by the profiler; the bf16 MLA case
                also times k_partial on the same inputs (A, B, B, A), and
                the host's mirror of k_mla's shared memory is held to the
                source's layout at every routed shape. bf16 within one bf16 ulp
                (rtol 2^-7, atol 1e-6), f32 at rtol 1e-5 / atol 1e-6.
                Alone: ``python3 -c "import torch, chip_smoke;
                chip_smoke.phase_decode(torch.Generator('cuda')
                .manual_seed(0))"``;
11. serve     — ``VenusService`` over the main phase's manager (MEM
                embedder, 16 streams) with a ``ServingEngine`` on
                Qwen2-VL-7B at full width (bf16 weights and activations,
                4 slots, max_len 2048): 8 ``StreamQuery``s, 12 new tokens
                each; gqa_decode launches == 28 × decode steps; one decode
                step's logits through the kernel against the same step
                through the plain version (relative L2 error ≤ 2^-5);
12. serve_mla — the engine on MiniCPM3-4B at full width (bf16): 8 text
                requests of 8–64 tokens, 12 new tokens each;
                mla_decode launches == 62 × decode steps, every one on
                k_mla (``mla_decode.route_launches``); #6's device µs a
                launch in the step by the profiler; the same logits
                check.

Prints the card's name and power limit, one line per phase, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Every kernel's launch count is read around the phase that drives its path
(main: fused retrieval and scene score; dense: the dense scans; serve and
serve_mla: the decode kernels).
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
BF16_TENSOR_FLOP_PER_S = 989e12    # H100 SXM, bf16 on the tensor cores
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


def bound_ms(bytes_moved: float, flops: float, tensor_flops: float = 0.0):
    """The least time for the work: bytes at the memory rate, or the
    operations at their peak rates — ``flops`` at the f32 rate,
    ``tensor_flops`` (products of bf16 operands, which the tensor cores
    compute exactly with f32 accumulation) at the bf16 tensor-core rate."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = (flops / FP32_FLOP_PER_S
          + tensor_flops / BF16_TENSOR_FLOP_PER_S) * 1e3
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


EDGE_S, EDGE_N = 4, 1000           # the scans' edge cases: shapes


def scan_edge_cases(gen):
    """The stack and fused scans' edge cases at S=4, Q=8, N=1000 (a ragged
    last chunk; session 1 all invalid): d = 6 and d = 770 (not multiples
    of 4) in f32 and int8, and d = 768 from an index view whose base is
    one element past an aligned address (4 bytes of f32, 1 of int8), so
    both kernels take their one-element-a-load path. → [(name, query,
    index, valid)]."""
    import torch
    from repro_torch.core.memory import quantise_rows
    dev = torch.device("cuda")
    sizes = torch.tensor([EDGE_N, 0, 613, EDGE_N], dtype=torch.int32,
                         device=dev)
    out = []
    for d in (6, 770, 768):
        query = torch.randn((EDGE_S, Q, d), generator=gen, device=dev)
        x32 = torch.randn((EDGE_S, EDGE_N, d), generator=gen, device=dev)
        x8 = torch.from_numpy(quantise_rows(x32.cpu().numpy())[0]).to(dev)
        if d == 768:                  # the same rows at an unaligned base
            n = x32.numel()
            b32 = torch.empty(n + 1, device=dev)
            b8 = torch.empty(n + 1, dtype=torch.int8, device=dev)
            x32 = b32[1:].view(x32.shape).copy_(x32)
            x8 = b8[1:].view(x8.shape).copy_(x8)
            check(x32.data_ptr() % 16 == 4 and x8.data_ptr() % 4 == 1,
                  "unaligned index views")
            tag = "unaligned"
        else:
            tag = f"d{d}"
        out += [(f"{tag}_f32", query, x32, sizes),
                (f"{tag}_int8", query, x8, sizes)]
    return out


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
    cases = [("f32", query, index32, sizes), ("int8", query, index8, sizes),
             ("f32_windows", query, index32, wins)] + scan_edge_cases(gen)
    out = {}
    for name, query, index, valid in cases:
        n = index.shape[1]
        sims, m, l = ref.similarity_scan_stack_ref(query, index, valid,
                                                   tau=TAU)
        probs = ref.scan_probs(sims, m, l,
                               ref.as_valid_mask(valid, n)[:, None, :], TAU)
        del sims
        targets, margin = margin_targets(probs, gen, T)
        del probs
        run_k = lambda: similarity.fused_retrieve_scan_stack(
            query, index, valid, targets, tau=TAU, n_topk=K)
        run_p = lambda: ref.fused_retrieve_stack_ref(
            query, index, valid, targets, tau=TAU, n_topk=K)
        got, want = ops.finalize(run_k(), n), ops.finalize(run_p(), n)
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
        if n != N:           # an edge case: checked only
            out[name] = dict(max_abs_err=err, margin=margin,
                             d=index.shape[2])
            print(f"phase fused[{name}]: ok  d={index.shape[2]} N={n}  "
                  f"max_abs_err {err:.3e}  target margin {margin:.2e}",
                  flush=True)
            continue
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
    cases = [("f32", query, index32, sizes), ("int8", query, index8, sizes),
             ("f32_windows", query, index32, wins)] + scan_edge_cases(gen)
    out = {}
    for name, q, index, valid in cases:
        n = index.shape[1]
        run_k = lambda: similarity.similarity_scan_stack(q, index, valid,
                                                         tau=TAU)
        run_p = lambda: ref.similarity_scan_stack_ref(q, index, valid,
                                                      tau=TAU)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        vmask = ref.as_valid_mask(valid, n)[:, None, :]
        err = _scan_check(f"similarity {name}", got, want, vmask, (1,))
        # the order of the stats: bit-equal to the fused kernel's m and l
        fr = similarity.fused_retrieve_scan_stack(
            q, index, valid, torch.zeros(q.shape[:2] + (1,), device=dev),
            tau=TAU, n_topk=1)
        check(torch.equal(got[1], fr.m) and torch.equal(got[2], fr.l),
              f"similarity {name}: m, l differ from the fused kernel's")
        if n != N:           # an edge case: checked only
            out[name] = dict(max_abs_err=err, d=index.shape[2])
            print(f"phase similarity[{name}]: ok  d={index.shape[2]} N={n}  "
                  f"max_abs_err {err:.3e}  m, l == fused", flush=True)
            continue
        ms = cuda_ms(run_k, reps=50, warmup=3)
        dev_ms = device_ms(run_k)
        plain = cuda_ms(run_p, reps=3)
        # yardstick: one bmm over operands normalised beforehand (sims only)
        qn = similarity.unit_queries(query)
        xn = similarity.unit_queries(index)
        run_l = lambda: torch.bmm(qn, xn.transpose(1, 2))
        lib = cuda_ms(run_l, reps=50, warmup=3)
        lib_dev = device_ms(run_l)
        del qn, xn
        elt = index.element_size()
        nbytes = (S * N * D * elt + S * Q * D * 4
                  + valid.numel() * valid.element_size()
                  + S * Q * N * 4 + 2 * S * Q * 4)
        b, by = bound_ms(nbytes, 2.0 * S * Q * N * D + 3.0 * S * N * D)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, library_ms=lib,
                         library_device_ms=lib_dev, max_abs_err=err)
        print(f"phase similarity[{name}]: ok  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms)  plain "
              f"{plain:.4f} ms  bound {b:.4f} ms ({by})  bmm (sims only) "
              f"{lib:.4f} ms (device {lib_dev:.4f} ms)  max_abs_err "
              f"{err:.3e}  m, l == fused", flush=True)
    out.update(phase_similarity_2d(gen, query[0], index32[0], index8[0]))
    return out


def phase_similarity_2d(gen, q2, x32, x8):
    """Kernel #4, the 2-D form, against its plain version: Q=8 over one
    session's N=8192 rows with 6,000 valid (timed, with torch.mm over
    normalised operands as the yardstick), then int8 rows, Q=20, N=300
    and an all-invalid mask. Each case checks that the wrapper launched
    its kernel."""
    import torch
    from repro_torch.kernels import ref, similarity
    dev = q2.device
    v2 = torch.arange(N, device=dev) < 6000
    q20 = torch.randn((20, D), generator=gen, device=dev)
    x300 = torch.randn((300, D), generator=gen, device=dev)
    v300 = torch.rand((300,), generator=gen, device=dev) < 0.6
    out = {}
    for name, q, x, v in (("2d", q2, x32, v2), ("2d_int8", q2, x8, v2),
                          ("2d_q20", q20, x32, v2),
                          ("2d_n300", q2, x300, v300),
                          ("2d_all_invalid", q2, x32, torch.zeros_like(v2))):
        run_k = lambda: similarity.similarity_scan(q, x, v, tau=TAU)
        run_p = lambda: ref.similarity_scan_ref(q, x, v, tau=TAU)
        before = similarity.similarity_scan.launches
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        check(similarity.similarity_scan.launches == before + 1,
              f"similarity {name}: the kernel did not launch")
        empty = () if bool(v.any()) else (0,)
        err = _scan_check(f"similarity {name}", tuple(t[None] for t in got),
                          tuple(t[None] for t in want), v[None, None, :],
                          empty)
        row = dict(max_abs_err=err, q=q.shape[0], n=x.shape[0])
        if name in ("2d", "2d_int8"):
            qn, xn = similarity.unit_queries(q), similarity.unit_queries(x)
            run_l = lambda: torch.mm(qn, xn.t())
            nq, n = q.shape[0], x.shape[0]
            b, by = bound_ms(n * D * x.element_size() + nq * D * 4 + n
                             + nq * n * 4 + 2 * nq * 4,
                             2.0 * nq * n * D + 3.0 * n * D)
            row["kernel_us"] = kernel_us(run_k)
            print("  per launch (device us): " + ("not measured (no device "
                  "events in the trace)" if row["kernel_us"] is None else
                  "  ".join(f"{k} {t:.2f}"
                            for k, t in row["kernel_us"].items())),
                  flush=True)
            row.update(ms=cuda_ms(run_k, reps=50, warmup=3),
                       device_ms=device_ms(run_k),
                       plain_ms=cuda_ms(run_p, reps=5),
                       library_ms=cuda_ms(run_l, reps=50, warmup=3),
                       library_device_ms=device_ms(run_l), bound_ms=b,
                       bound_by=by)
            del qn, xn
        out[name] = row
        print(f"phase similarity[{name}]: ok  Q={row['q']} N={row['n']}  "
              + ("" if "ms" not in row else
                 f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}"
                 f" ms)  plain {row['plain_ms']:.4f} ms  bound "
                 f"{row['bound_ms']:.4f} ms ({row['bound_by']})  mm (sims "
                 f"only) {row['library_ms']:.4f} ms (device "
                 f"{row['library_device_ms']:.4f} ms)  ")
              + f"max_abs_err {err:.3e}", flush=True)
    return out


def make_worlds(n: int, resolution: int):
    from repro_torch.data.video import VideoWorld, WorldConfig
    return [VideoWorld(WorldConfig(n_scenes=3, resolution=resolution,
                                   seed=s)) for s in range(n)]


def scene_cases(frames_np):
    """The scene kernel's cases → [(name, frames, prev, (pix, stages,
    copy) of its plan)]: the table's 65 VideoWorld frames of 224² (timed);
    random frames with a grey block (c = 0) and two identical frames; T =
    1 and T = 2; 37 × 53 (W % 4 != 0: 4-byte copies); 65 frames of 448²;
    the table's frames from a base 4 bytes past a 16-byte boundary (4-byte
    copies); the table's last 64 frames with its first as ``prev``, as the
    segmenter calls it; frames that take the kernel's exact divisions (a
    block of channels below 1e-25 apart, a frame with values up to 2); and
    rows wider than 2,045 pixels, which take 32 pixels a thread: 33 frames
    of 40 rows of 2,100 and 2,102 (3 ring stages), of 2,732 and 2,734
    (bands of 2 rows in 2 stages), each with 16- and 4-byte copies, and
    the widest row a plan takes, 4,150."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(18)
    table = torch.from_numpy(frames_np).to(dev)
    rand = torch.rand((8, 224, 224, 3), generator=gen, device=dev)
    rand[2, :16, :16] = 0.5                        # grey block: c == 0
    rand[3] = rand[2]                              # identical frames
    exact = torch.rand((6, 224, 224, 3), generator=gen, device=dev)
    exact[1, :8, :8] *= 1e-25                      # c, num below 2^-60
    exact[4] *= 2.0                                # outside [0, 1]
    buf = torch.empty(table.numel() + 1, device=dev)
    unaligned = buf[1:].view(table.shape).copy_(table)
    check(unaligned.data_ptr() % 16 == 4, "scene: unaligned view")
    eight = (8, 3, 16)
    cases = [("table", table, None, eight), ("random", rand, None, eight),
             ("t1", rand[:1], None, eight), ("t2", rand[:2], None, eight),
             ("h37_w53", torch.rand((9, 37, 53, 3), generator=gen,
                                    device=dev), None, (8, 3, 4)),
             ("448", torch.rand((65, 448, 448, 3), generator=gen,
                                device=dev), None, eight),
             ("unaligned", unaligned, None, (8, 3, 4)),
             ("prev", table[1:], table[0], eight),
             ("exact_division", exact, None, eight)]
    for t, h, w, route in ((33, 40, 2100, (32, 3, 16)),
                           (33, 40, 2102, (32, 3, 4)),
                           (33, 40, 2732, (32, 2, 16)),
                           (33, 40, 2734, (32, 2, 4)),
                           (3, 4, 4150, (32, 2, 4))):
        cases.append((f"w{w}", torch.rand((t, h, w, 3), generator=gen,
                                          device=dev), None, route))
    return cases


def phase_scene(frames_np):
    """Kernel #2 against its plain version in every case of
    ``scene_cases`` (rtol 1e-5, atol 1e-7, φ_0 == 0 exactly without
    ``prev``), each checked to have launched the kernel, its plan's shared
    memory held to the source's count; the table's frames timed warm (the
    same frames every call) and cold (4 copies in turn, 156 MB, more than
    the 50 MB L2), beside the plain version and the bound."""
    import torch
    from repro_torch.core.scene import DEFAULT_WEIGHTS
    from repro_torch.kernels import ref, scene_score
    from repro_torch.kernels.device import sm_count
    out, got_of = {}, {}
    for name, frames, prev, route in scene_cases(frames_np):
        run_k = lambda: scene_score.scene_score(frames, DEFAULT_WEIGHTS,
                                                prev)
        run_p = lambda: ref.scene_score_ref(frames, DEFAULT_WEIGHTS, prev)
        before = scene_score.scene_score.launches
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        check(scene_score.scene_score.launches == before + 1,
              f"scene {name}: the kernel did not launch")
        t, h, w, _ = frames.shape
        aligned = frames.data_ptr() % 16 == 0 and (
            prev is None or prev.data_ptr() % 16 == 0)
        plan = scene_score.scene_plan(t + (prev is not None), h, w,
                                      sm_count(frames.device), aligned)
        check(plan.smem == scene_score.kernel_smem_bytes(
            plan.rb, w, plan.stages, plan.fc),
            f"scene {name}: the plan's shared memory is not the source's")
        check((plan.pix, plan.stages, plan.copy) == route,
              f"scene {name}: plan {plan}, not (pix, stages, copy) {route}")
        check(got.shape == want.shape == (t,)
              and bool(torch.isfinite(got).all()),
              f"scene {name}: shape / finite")
        if prev is None:
            check(float(got[0]) == 0.0, f"scene {name}: phi_0 = "
                                        f"{float(got[0])}")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-7),
              f"scene {name}: max abs err {float((got - want).abs().max())}")
        err = float((got - want).abs().max())
        got_of[name] = got
        row = dict(t=t, h=h, w=w, plan=plan._asdict(), max_abs_err=err)
        if name == "table":
            copies = [frames] + [frames.clone() for _ in range(3)]
            calls = [0]

            def run_cold():
                calls[0] += 1
                return scene_score.scene_score(copies[calls[0] % 4],
                                               DEFAULT_WEIGHTS)
            b, by = bound_ms(t * h * w * 3 * 4 + t * 4, 40.0 * t * h * w)
            row.update(ms=cuda_ms(run_k, reps=20, warmup=2),
                       device_ms=device_ms(run_k),
                       cold_device_ms=device_ms(run_cold, reps=40),
                       plain_ms=cuda_ms(run_p, reps=3), bound_ms=b,
                       bound_by=by, kernel_us=kernel_us(run_k))
            del copies
            print(f"phase scene[{name}]: ok  kernel {row['ms']:.4f} ms "
                  f"(device {row['device_ms']:.4f} ms warm, "
                  f"{row['cold_device_ms']:.4f} ms cold)  plain "
                  f"{row['plain_ms']:.4f} ms  bound {b:.4f} ms ({by})  "
                  f"max_abs_err {err:.3e}  plan {tuple(plan)}", flush=True)
            _print_kernel_us(row["kernel_us"])
        else:
            print(f"phase scene[{name}]: ok  T={t} {h}x{w}"
                  f"{' with prev' if prev is not None else ''}  max_abs_err "
                  f"{err:.3e}  plan {tuple(plan)}", flush=True)
        out[name] = row
    # the same plan gives the same bits: prev against the clip's first
    # frame, and 4-byte copies against 16-byte ones
    check(torch.equal(got_of["prev"], got_of["table"][1:]),
          "scene: prev is not the table's frames 1..64 bit for bit")
    check(torch.equal(got_of["unaligned"], got_of["table"]),
          "scene: the unaligned view differs from the table's frames")
    return out


def ingest_streams(worlds, cfg, embedder, dim, device, *, chunk=64):
    """Each world is its own session, fed in ticks of ``chunk`` frames;
    returns (manager, host-clock seconds of each tick)."""
    import torch
    from repro_torch.core.session import SessionManager
    mgr = SessionManager(cfg, embedder, embed_dim=dim, device=device)
    for sid in range(len(worlds)):
        mgr.create_session(sid)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ticks, seg_ticks = [], []
    stages = {"segment": 0.0, "cluster": 0.0, "embed_insert": 0.0}
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
        seg_ticks.append(got["segment"])
    mgr.flush()
    sync()
    stages["segment_ticks"] = seg_ticks
    return mgr, ticks, stages


def segment_split(worlds, tick: int = 1, chunk: int = 64):
    """Where one tick's segment stage goes: the stage's device work on the
    main phase's tick ``tick`` (each world's chunk of 64 frames, scored
    against the frame before it, as ``segment_stage`` does), replayed
    session by session with the device synchronised between the steps:
    the pageable upload (``torch.from_numpy(chunk).to('cuda')``), #2's
    launch and run, and the φ read back (``.cpu()``), host-clock seconds
    summed over the sessions."""
    import numpy as np
    import torch
    from repro_torch.core.scene import DEFAULT_WEIGHTS
    from repro_torch.kernels import scene_score
    lo = tick * chunk
    work = [(np.asarray(w.frames[lo:lo + chunk], np.float32),
             torch.from_numpy(w.frames[lo - 1]).cuda())
            for w in worlds if w.total_frames >= lo + chunk]
    split = dict(sessions=len(work), upload_s=0.0, kernel_s=0.0,
                 readback_s=0.0)
    torch.cuda.synchronize()
    for frames, prev in work:
        t0 = time.perf_counter()
        dev = torch.from_numpy(frames).to("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        phi = scene_score.scene_score(dev, DEFAULT_WEIGHTS, prev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phi.cpu().numpy()
        t3 = time.perf_counter()
        split["upload_s"] += t1 - t0
        split["kernel_s"] += t2 - t1
        split["readback_s"] += t3 - t2
    return split


def scene_in_trace(prof, launches: int):
    """#2 in a traced ingest: the device time its kernels cover (k_scene
    and k_scene_sum, the union of their intervals, so a PDL'd sum that
    starts early counts once) over its ``launches`` launches, and the
    device time of every kernel of the ingest. None where the trace holds
    no device event at all (the profiler now and then returns such a
    trace); else fails unless it holds one k_scene and one k_scene_sum
    for each launch."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None
    sums = [e for e in kern if "k_scene_sum" in e.name]
    bands = [e for e in kern if "k_scene<" in e.name]
    check(launches > 0 and len(sums) == len(bands) == launches,
          f"main trace: {len(bands)} k_scene and {len(sums)} k_scene_sum "
          f"for {launches} scene_score launches")
    us = _covered_us(sums + bands)
    busy = _covered_us(kern)
    return dict(launches=launches, device_us=us,
                device_us_per_launch=us / launches, ingest_device_us=busy,
                share_of_ingest_device=us / busy)


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


def run_main_path(worlds, cfg, embedder, dim, card, label, trace=False):
    """Ingest, then the queries. ``trace``: the ingest runs under the
    profiler (device activity only), which reads #2 there
    (``scene_in_trace``, None for an empty trace); its host clocks then
    carry the tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import scene_score
    before = scene_score.scene_score.launches
    times = {}
    if trace:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mgr, ticks, stages = ingest_streams(worlds, cfg, embedder, dim,
                                                "cuda")
            torch.cuda.synchronize()
        times["scene_trace"] = scene_in_trace(
            prof, scene_score.scene_score.launches - before)
    else:
        mgr, ticks, stages = ingest_streams(worlds, cfg, embedder, dim,
                                            "cuda")
    results, qtimes = run_queries(mgr, len(worlds), dim)
    print(f"phase {label}: ingest ticks (s) {[round(x, 6) for x in ticks]}"
          f"  by stage (s) { {k: round(stages[k], 6) for k in
                             ('segment', 'cluster', 'embed_insert')} }"
          f"  queries (s) { {k: round(v, 6) for k, v in qtimes.items()} }"
          f"  [{card}]", flush=True)
    times.update(ticks=ticks, stages=stages, queries=qtimes)
    return mgr, results, times


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


BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)     # one bf16 ulp
F32_TOL = dict(rtol=1e-5, atol=1e-6)
DEC_B, DEC_C = 4, 2048                      # serving slots, cache rows


def decode_valid(dev, c: int = DEC_C):
    """(4, c) ragged per-slot masks: all rows, a single row, none (the
    mean-of-values case), 1500 rows."""
    import torch
    lens = torch.tensor([c, 1, 0, 1500], device=dev)
    return torch.arange(c, device=dev)[None, :] < lens[:, None]


def decode_valid_holes(dev):
    """(4, 2048) masks with holes: two runs of valid rows with whole empty
    64-row tiles between them, only the last row, none, and a run in the
    middle."""
    import torch
    valid = torch.zeros((DEC_B, DEC_C), dtype=torch.bool, device=dev)
    valid[0, 5:300] = True
    valid[0, 1100:1250] = True
    valid[1, DEC_C - 1] = True
    valid[3, 700:1500] = True
    return valid


def kernel_us(fn, reps: int = 20, tries: int = 3) -> dict | None:
    """Mean device microseconds per call of each kernel that ``fn``
    launches, by the profiler's trace of ``reps`` calls (the port's own
    kernels by their ``k_*`` name, others by their first 60 characters).
    A measurement only: a trace with no device events is taken again, up
    to ``tries`` times, and then gives None."""
    import re
    from collections import defaultdict
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        tot = defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"\bk_\w+", e.name)
                tot[m.group(0) if m else e.name[:60]] += \
                    e.time_range.elapsed_us()
        if tot:
            return {k: v / reps for k, v in sorted(tot.items())}
    return None


def needed_rows(valid) -> int:
    """Cache rows the masked softmax needs: the valid ones, and every row
    of an all-invalid slot (its output is the mean of all values)."""
    import torch
    per = valid.sum(-1)
    return int(torch.where(per == 0, valid.shape[-1], per).sum())


def _kernel_check(name, got, want, tol, empty_slot, empty_mean):
    import torch
    a, b = got.float(), want.float()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: dtype/shape")
    check(bool(torch.isfinite(a).all()), f"{name}: not finite")
    check(torch.allclose(a, b, **tol),
          f"{name}: max abs err {float((a - b).abs().max())}")
    if empty_slot is not None:
        check(torch.allclose(a[empty_slot, 0], empty_mean.float(),
                             rtol=1e-2, atol=1e-3),
              f"{name}: all-invalid slot is not the mean of the values")
    return float((a - b).abs().max())


def _opt_ms(wall, dev) -> str:
    return "n/a" if wall is None else f"{wall:.4f} ms (device {dev:.4f} ms)"


def phase_decode(gen):
    """Kernels #5 and #6 against their plain versions at the serving
    shapes, with their times, bounds and SDPA yardsticks."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    valid = decode_valid(dev)
    out = {}
    b = DEC_B
    # GQA at Qwen2-VL-7B: H=28, Hkv=4, D=128; then the bf16 kernel's edges:
    # masks with holes, C = 2000 (a ragged last tile), G = 16; and the
    # serve phase's masks (1,060-1,110 written rows a slot)
    holes = decode_valid_holes(dev)
    serve = (torch.arange(DEC_C, device=dev)[None, :]
             < torch.tensor([1060, 1075, 1090, 1110], device=dev)[:, None])
    split, part = "k_gqa_split", "k_partial"
    bf, f32 = torch.bfloat16, torch.float32
    for name, h, hkv, d, softcap, dt, cv, route in (
            ("bf16", 28, 4, 128, 0.0, bf, valid, split),
            ("bf16_softcap30", 28, 4, 128, 30.0, bf, valid, split),
            ("bf16_mha", 28, 28, 128, 0.0, bf, valid, split),
            ("f32", 28, 4, 128, 0.0, f32, valid, part),
            ("bf16_holes", 28, 4, 128, 0.0, bf, holes, split),
            ("bf16_c2000", 28, 4, 128, 0.0, bf, decode_valid(dev, 2000),
             split),
            ("bf16_g16", 32, 2, 128, 0.0, bf, valid, split),
            ("bf16_serve", 28, 4, 128, 0.0, bf, serve, split),
            # shapes the split kernel leaves to k_partial (checked only)
            ("bf16_g32", 32, 1, 128, 0.0, bf, valid, part),
            ("bf16_d72", 28, 4, 72, 0.0, bf, valid, part),
            ("f32_d6", 28, 4, 6, 0.0, f32, valid, part),
            # 128 heads of 512: k_partial takes them 64 to a block
            ("bf16_g128_d512", 128, 1, 512, 0.0, bf, valid, part)):
        c = cv.shape[-1]
        rows = needed_rows(cv)
        q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, c, hkv, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, c, hkv, d), generator=gen, device=dev).to(dt)
        kw = dict(scale=d ** -0.5, softcap=softcap, q_per_kv=h // hkv)
        run_k = lambda: dk.gqa_decode(q, k, v, cv, **kw)
        run_p = lambda: ref.decode_attention_ref(q, k, v, cv, **kw)
        before = dict(dk.gqa_decode.route_launches)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        ran = [r for r, n in dk.gqa_decode.route_launches.items()
               if n != before[r]]
        check(ran == [route], f"gqa {name}: ran {ran}, not {route}")
        empty = None if bool(cv[2].any()) else 2   # the serve masks: none
        mean_v = v[2].float().mean(0).repeat_interleave(h // hkv, 0)
        err = _kernel_check(f"gqa {name}", got, want,
                            F32_TOL if dt == torch.float32 else BF16_TOL,
                            empty, mean_v)
        if name in ("bf16_g32", "bf16_d72", "f32_d6", "bf16_g128_d512"):
            out[f"gqa_{name}"] = dict(max_abs_err=err, route=route)
            print(f"phase decode[gqa {name}]: ok  {route}  H={h} Hkv={hkv} "
                  f"D={d}  max_abs_err {err:.3e}", flush=True)
            del q, k, v
            continue
        per_kernel = kernel_us(run_k)
        ms = cuda_ms(run_k, reps=50, warmup=3)
        dev_ms = device_ms(run_k, reps=50)
        plain = cuda_ms(run_p, reps=10, warmup=1)
        lib = lib_dev = None
        if softcap == 0.0:
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            mask = cv[:, None, None, :]
            run_l = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                enable_gqa=True)
            lib = cuda_ms(run_l, reps=50, warmup=3)
            lib_dev = device_ms(run_l, reps=50)
        elt = q.element_size()
        nbytes = (2 * b * h * d * elt + 2 * rows * hkv * d * elt
                  + cv.numel())
        # q.k in the model dtype (bf16: tensor cores); p.v has f32 p
        bf = dt == torch.bfloat16
        bnd, by = bound_ms(nbytes, (2.0 if bf else 4.0) * rows * h * d,
                           2.0 * rows * h * d if bf else 0.0)
        bnd_full, _ = bound_ms(
            2 * b * h * d * elt + 2 * b * c * hkv * d * elt + cv.numel(),
            (2.0 if bf else 4.0) * b * c * h * d,
            2.0 * b * c * h * d if bf else 0.0)
        out[f"gqa_{name}"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                  bound_ms=bnd, bound_by=by,
                                  bound_full_cache_ms=bnd_full,
                                  library_ms=lib, library_device_ms=lib_dev,
                                  max_abs_err=err, rows_needed=rows,
                                  route=route, kernel_us=per_kernel)
        print(f"phase decode[gqa {name}]: ok  {route}  kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms)  plain {plain:.4f} ms  bound "
              f"{bnd:.4f} ms ({by}; {rows} of {b * c} rows needed; full "
              f"cache {bnd_full:.4f} ms)  sdpa {_opt_ms(lib, lib_dev)}  "
              f"max_abs_err {err:.3e}", flush=True)
        _print_kernel_us(per_kernel)
        del q, k, v
    out.update(phase_decode_mla(gen, valid, holes))
    return out


def _print_kernel_us(per_kernel) -> None:
    print("  per launch (device us): " + ("not measured (no device events "
          "in the trace)" if per_kernel is None else "  ".join(
              f"{k} {v:.2f}" for k, v in per_kernel.items())), flush=True)


def _check_mla_smem(dk) -> int:
    """The host's ``mla_smem_bytes`` (which picks the ring's stages)
    against the source's ``layout`` at every shape ``mla_route`` sends to
    ``k_mla``: H up to 160, R and Dr up to 512 and 64, C up to 2^20.
    Returns the number of shapes checked."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    fn = build.load("mla_decode.cu").mla_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    n = 0
    for h in (1, 16, 40, 64, 128, 160):
        for r in range(16, 513, 16):
            for dr in (16, 32, 48, 64):
                if dk.mla_route(torch.bfloat16, h, r, dr) != "k_mla":
                    continue
                hg = dk.mla_heads(h, r)
                for c in (1, 2048, 100_000, 1 << 20):
                    _, per = dk.mla_split_plan(DEC_B, c, h, r, 132)
                    st = dk.mla_stages(hg, r, dr, per)
                    got = fn(hg, r, dr, st, per)
                    check(got == dk.mla_smem_bytes(hg, r, dr, st, per),
                          f"mla smem at hg={hg} R={r} Dr={dr} stages={st} "
                          f"tiles={per}: source {got}, host "
                          f"{dk.mla_smem_bytes(hg, r, dr, st, per)}")
                    n += 1
    print(f"phase decode[mla smem]: ok  host formula = source layout at "
          f"{n} routed shapes", flush=True)
    return n


def phase_decode_mla(gen, valid, holes):
    """Kernel #6 against its plain version: MiniCPM3-4B's widths (H=40,
    R=256, Dr=32) at the table's masks (bf16 on ``k_mla``, f32 on
    ``k_partial``), with holes, C=2000, the serve phase's masks (9-76
    written rows a slot), DeepSeek-V2-Lite's (H=16, R=512, Dr=64) and,
    checked only, DeepSeek-V3's (H=128) and R=30 (``k_partial``). Each
    case checks its route by ``mla_decode.route_launches``. The bf16 case
    also times ``k_partial`` on the same inputs (A, B, B, A). First the
    host's ``mla_smem_bytes`` is held to the source's ``layout`` at every
    shape the route sends to ``k_mla``, with the wrapper's plan."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    from repro_torch.kernels.device import sm_count
    dev = torch.device("cuda")
    b = DEC_B
    serve = (torch.arange(DEC_C, device=dev)[None, :]
             < torch.tensor([9, 30, 52, 76], device=dev)[:, None])
    bf, f32 = torch.bfloat16, torch.float32
    new, part = "k_mla", "k_partial"
    out = {"mla_smem_shapes": _check_mla_smem(dk)}
    for name, dt, h, r, dr, nope, cv, route, timed in (
            ("bf16", bf, 40, 256, 32, 64, valid, new, True),
            ("f32", f32, 40, 256, 32, 64, valid, part, True),
            ("bf16_holes", bf, 40, 256, 32, 64, holes, new, True),
            ("bf16_c2000", bf, 40, 256, 32, 64, decode_valid(dev, 2000), new,
             True),
            ("bf16_serve", bf, 40, 256, 32, 64, serve, new, True),
            ("bf16_dsv2", bf, 16, 512, 64, 128, valid, new, True),
            ("bf16_dsv3", bf, 128, 512, 64, 128, valid, new, False),
            ("bf16_r30", bf, 40, 30, 32, 64, valid, part, False)):
        c = cv.shape[-1]
        rows = needed_rows(cv)
        scale = (nope + dr) ** -0.5
        qa = torch.randn((b, 1, h, r), generator=gen, device=dev).to(dt)
        qr = torch.randn((b, 1, h, dr), generator=gen, device=dev).to(dt)
        ckv = torch.randn((b, c, r), generator=gen, device=dev).to(dt)
        kr = torch.randn((b, c, dr), generator=gen, device=dev).to(dt)
        run_k = lambda: dk.mla_decode(qa, qr, ckv, kr, cv, scale=scale)
        run_p = lambda: ref.mla_decode_attention_ref(qa, qr, ckv, kr, cv,
                                                     scale=scale)
        check(dk.mla_route(dt, h, r, dr) == route,
              f"mla {name}: mla_route is {dk.mla_route(dt, h, r, dr)}")
        before = dict(dk.mla_decode.route_launches)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        ran = [k for k, n in dk.mla_decode.route_launches.items()
               if n != before[k]]
        check(ran == [route], f"mla {name}: ran {ran}, not {route}")
        empty = None if bool(cv[2].any()) else 2
        mean_c = ckv[2].float().mean(0)[None].expand(h, r)
        err = _kernel_check(f"mla {name}", got, want,
                            F32_TOL if dt == f32 else BF16_TOL, empty,
                            mean_c)
        head = f"phase decode[mla {name}]: ok  {route}  H={h} R={r} Dr={dr}"
        if not timed:
            out[f"mla_{name}"] = dict(max_abs_err=err, route=route)
            print(f"{head}  max_abs_err {err:.3e}", flush=True)
            del qa, qr, ckv, kr
            continue
        per_kernel = kernel_us(run_k)
        ms = cuda_ms(run_k, reps=50, warmup=3)
        dev_ms = device_ms(run_k, reps=50)
        plain = cuda_ms(run_p, reps=10, warmup=1)
        lib = lib_dev = None
        if name in ("bf16", "f32"):
            qcat = torch.cat([qa, qr], -1).transpose(1, 2).contiguous()
            kcat = torch.cat([ckv, kr], -1)[:, None].contiguous()
            vlat = ckv[:, None].contiguous()
            mask = cv[:, None, None, :]
            run_l = lambda: F.scaled_dot_product_attention(
                qcat, kcat, vlat, attn_mask=mask, scale=scale,
                enable_gqa=True)
            try:
                lib = cuda_ms(run_l, reps=50, warmup=3)
                lib_dev = device_ms(run_l, reps=50)
            except RuntimeError as e:      # a yardstick only: report, go on
                print(f"  sdpa yardstick for mla {name} refused: {e}")
            del qcat, kcat, vlat
        elt = qa.element_size()
        nbytes = (b * h * (2 * r + dr) * elt + rows * (r + dr) * elt
                  + cv.numel())

        # scores q.[ckv, krope] in the model dtype (bf16: tensor cores);
        # the value product p.ckv has f32 p
        def mla_ops(n):
            score, value = 2.0 * h * n * (r + dr), 2.0 * h * n * r
            return (value, score) if dt == bf else (value + score, 0.0)
        bnd, by = bound_ms(nbytes, *mla_ops(rows))
        bnd_full, _ = bound_ms(b * h * (2 * r + dr) * elt
                               + b * c * (r + dr) * elt + cv.numel(),
                               *mla_ops(b * c))
        row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                   bound_by=by, bound_full_cache_ms=bnd_full,
                   library_ms=lib, library_device_ms=lib_dev,
                   max_abs_err=err, rows_needed=rows, route=route,
                   kernel_us=per_kernel)
        extra = ""
        if name == "bf16":
            # k_partial on the same inputs
            part_k = lambda: dk._launch_mla(qa, qr, ckv, kr, cv, scale=scale)
            ab = [device_ms(f, reps=50) for f in (run_k, part_k, part_k,
                                                  run_k)]
            row.update(ab_device_ms=ab, partial_device_ms=(ab[1] + ab[2]) / 2,
                       partial_kernel_us=kernel_us(part_k),
                       plan=dk.mla_split_plan(b, c, h, r, sm_count(dev)))
            extra = (f"  k_partial same inputs (A,B,B,A device ms) "
                     f"{[round(x, 5) for x in ab]}  plan {row['plan']}")
        out[f"mla_{name}"] = row
        print(f"{head}  kernel {ms:.4f} ms (device {dev_ms:.4f} ms)  plain "
              f"{plain:.4f} ms  bound {bnd:.4f} ms ({by}; {rows} of {b * c} "
              f"rows needed; full cache {bnd_full:.4f} ms)  sdpa "
              f"{_opt_ms(lib, lib_dev)}  max_abs_err {err:.3e}{extra}",
              flush=True)
        _print_kernel_us(per_kernel)
        del qa, qr, ckv, kr
    return out


def logits_kernel_vs_plain(engine, attr):
    """One decode step from the engine's current cache twice: through the
    decode kernel, and with ``kernels.ops.<attr>`` routed to its plain
    version on the card. Returns (relative L2 error of the logits, share
    of slots whose argmax agrees)."""
    import torch
    from repro_torch.kernels import ops, ref
    model = engine.model
    tokens = torch.full((engine.batch_slots, 1), 7, device=engine.device)

    def step():
        cache = {k: (v.clone() if torch.is_tensor(v) else
                     {n: t.clone() for n, t in v.items()})
                 for k, v in engine.cache.items()}
        return model.apply(tokens, cache=cache, mode="decode")[0].float()

    got = step()
    kernel = getattr(ops, attr)
    plain = (ref.decode_attention_ref if attr == "decode_attention"
             else ref.mla_decode_attention_ref)
    setattr(ops, attr, plain)
    try:
        want = step()
    finally:
        setattr(ops, attr, kernel)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, agree


# the decode kernels' names in a profiler trace
DECODE_KERNELS = ("k_gqa_split", "k_mla", "k_partial", "k_merge")


def decode_busy(engine, steps: int = 3):
    """Device busy share of decode steps from the engine's current cache:
    ``steps`` steps under ``torch.profiler``; the device time its kernels
    cover over the host-clock time, and the decode kernels' covered time
    and share of it. A measurement only: a profiler that reports no
    device events gives None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.full((engine.batch_slots, 1), 7, device=engine.device)
    cache = engine.cache
    cache = engine.model.apply(tokens, cache=cache, mode="decode")[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cache = engine.model.apply(tokens, cache=cache,
                                       mode="decode")[1]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None
    busy = _covered_us(kern)
    ours = [e for e in kern if any(n in e.name for n in DECODE_KERNELS)]
    per = {}
    for e in ours:
        n = next(n for n in DECODE_KERNELS if n in e.name)
        per[n] = per.get(n, 0.0) + e.time_range.elapsed_us() / steps
    span = _covered_us(ours)
    return dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_ms_per_step=busy / steps / 1e3,
                busy_share=busy / wall_us,
                decode_kernel_share=span / busy,
                decode_kernel_us_per_step=span / steps,
                decode_kernel_spans_us_per_step=per,
                kernels_per_step=len(kern) / steps)


def _covered_us(events) -> float:
    """Microseconds of device time covered by the events' intervals, each
    instant once: a PDL-launched kernel's trace starts while the kernel
    before it runs, so the sum of their spans would count that twice."""
    covered, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            covered += b - max(a, end)
            end = b
    return covered


def step_probe(engine, steps: int = 8):
    """Seconds per decode step from the engine's current cache (the
    engine's own step: model, token pick, read-back), first with the
    garbage collector as it is, then with every live object frozen out of
    its collections (``gc.freeze``), beside the count of objects the
    collector tracks: whether the size of the Python heap, which earlier
    phases grow, slows the host-bound step."""
    import gc
    import torch
    tokens = torch.full((engine.batch_slots, 1), 7, device=engine.device)

    def per_step():
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._decode(tokens).cpu()
        return (time.perf_counter() - t0) / steps
    per_step()
    tracked = len(gc.get_objects())
    as_is = per_step()
    gc.freeze()
    try:
        frozen = per_step()
    finally:
        gc.unfreeze()
    return dict(steps=steps, s_per_step=as_is, s_per_step_gc_frozen=frozen,
                gc_tracked_objects=tracked)


def serve_report(label, engine, done, card, retrieval_s=None):
    t = engine.timings
    steps = len(t["decode"])
    toks = sum(len(r.generated) - 1 for r in done)   # decode-step tokens
    dsec = sum(t["decode"])
    ttft = [round(r.first_token_at - r.submitted_at, 6) for r in done]
    rep = dict(prefill_s=t["prefill"], ttft_s=ttft, decode_steps=steps,
               decode_s=dsec, s_per_step=dsec / max(steps, 1),
               decode_tok_per_s=toks / max(dsec, 1e-9),
               retrieval_s=retrieval_s)
    ret = ("" if retrieval_s is None else
           f"  retrieval (s) {[round(x, 6) for x in retrieval_s]}")
    print(f"phase {label}:{ret}  prefill (s) "
          f"{[round(x, 6) for x in t['prefill']]}  ttft (s) {ttft}  decode "
          f"{steps} steps in {dsec:.4f} s = {rep['s_per_step']:.6f} s/step, "
          f"{rep['decode_tok_per_s']:.1f} tok/s  [{card}]", flush=True)
    return rep


def phase_serve(mgr, card):
    """VenusService over the main manager, Qwen2-VL-7B at full width."""
    import numpy as np
    import torch
    from repro_torch.configs.qwen2_vl_7b import config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import ServingEngine, StreamQuery, VenusService
    cfg = config().replace(param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = ServingEngine(model, batch_slots=4, max_len=2048)
    svc = VenusService(mgr, engine)
    retrieval_s = []
    execute = mgr.execute

    def timed_execute(plan, **kw):
        t0 = time.perf_counter()
        res = execute(plan, **kw)
        torch.cuda.synchronize()
        retrieval_s.append(time.perf_counter() - t0)
        return res
    rng = np.random.default_rng(7)
    qe = unit_queries_np(8, D, 8)
    queries = [StreamQuery(rid=i, sid=2 * i, text=f"what happened {i}",
                           prompt_tokens=rng.integers(
                               3, cfg.vocab_size, size=int(rng.integers(
                                   16, 48))),
                           query_emb=qe[i], max_new_tokens=12)
               for i in range(8)]
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    ops.reset_scan_counts()
    mgr.execute = timed_execute
    try:
        done = svc.answer(queries)
    finally:
        del mgr.execute
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    steps = len(engine.timings["decode"])
    check(launches["gqa_decode"] == cfg.num_layers * steps,
          f"gqa_decode launches {launches['gqa_decode']} != "
          f"{cfg.num_layers} x {steps} decode steps")
    check(launches["mla_decode"] == 0, f"serve launches {launches}")
    check(svc.io_stats()["stack_rebuilds"] == 0, "serve stack_rebuilds")
    check([r.rid for r in done] == list(range(8)), "serve: requests")
    for q, r in zip(queries, done):
        check(len(q.frame_ids) > 0, f"serve: query {q.rid} retrieved "
              f"nothing")
        check(len(r.generated) == 12 and all(
            0 <= t < cfg.vocab_size for t in r.generated),
            f"serve: request {r.rid} generated {r.generated}")
    rep = serve_report("serve", engine, done, card, retrieval_s)
    rel, agree = logits_kernel_vs_plain(engine, "decode_attention")
    check(rel <= 2 ** -5, f"serve: kernel vs plain logits rel L2 {rel}")
    rep.update(launches=launches, init_s=t_init, logits_rel_l2=rel,
               argmax_agree=agree,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               probe=step_probe(engine), profile=decode_busy(engine))
    print(f"  serve probe: {rep['probe']}\n  serve profile: "
          f"{rep['profile']}", flush=True)
    print(f"phase serve: ok  qwen2-vl-7b full width, bf16, init "
          f"{t_init:.2f} s  launches {launches}  kernel vs plain logits "
          f"rel L2 {rel:.3e} (argmax agree {agree:.2f})  peak "
          f"{rep['peak_gb']:.1f} GB", flush=True)
    return rep


def phase_serve_mla(card):
    """The engine on MiniCPM3-4B at full width: 8 text requests."""
    import numpy as np
    import torch
    from repro_torch.configs.minicpm3_4b import config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Request, ServingEngine
    cfg = config().replace(param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = ServingEngine(model, batch_slots=4, max_len=2048)
    rng = np.random.default_rng(8)
    reqs = [Request(rid=i, tokens=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(8, 65))),
        max_new_tokens=12) for i in range(8)]
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    routes = dict(dk.mla_decode.route_launches)
    steps = len(engine.timings["decode"])
    check(launches["mla_decode"] == cfg.num_layers * steps,
          f"mla_decode launches {launches['mla_decode']} != "
          f"{cfg.num_layers} x {steps} decode steps")
    check(routes == {"k_mla": launches["mla_decode"], "k_partial": 0},
          f"serve_mla: mla_decode routes {routes}")
    check(launches["gqa_decode"] == 0, f"serve_mla launches {launches}")
    for r in done:
        check(len(r.generated) == 12 and all(
            0 <= t < cfg.vocab_size for t in r.generated),
            f"serve_mla: request {r.rid} generated {r.generated}")
    rep = serve_report("serve_mla", engine, done, card)
    rel, agree = logits_kernel_vs_plain(engine, "mla_decode_attention")
    check(rel <= 2 ** -5, f"serve_mla: kernel vs plain logits rel L2 {rel}")
    prof = decode_busy(engine)
    # #6 per launch in the decode step: the device time k_mla and its
    # merge cover, 62 launches a step
    us = (None if prof is None else
          prof["decode_kernel_us_per_step"] / cfg.num_layers)
    rep.update(launches=launches, routes=routes, init_s=t_init,
               logits_rel_l2=rel, argmax_agree=agree,
               probe=step_probe(engine), profile=prof,
               mla_us_per_launch=us)
    print(f"  serve_mla probe: {rep['probe']}\n  serve_mla profile: "
          f"{rep['profile']}", flush=True)
    print(f"phase serve_mla: ok  minicpm3-4b full width, bf16, init "
          f"{t_init:.2f} s  launches {launches}  routes {routes}  #6 "
          f"{'not measured' if us is None else f'{us:.2f}'} device us a "
          f"launch  kernel vs plain logits rel L2 {rel:.3e} (argmax agree "
          f"{agree:.2f})", flush=True)
    return rep


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

    # 1. build: nvcc for every CUDA source, all started together
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
    print(f"phase build: ok  nvcc {t_nvcc:.2f} s  (worlds generated in "
          f"{t_worlds:.2f} s)", flush=True)

    # 2-4, 10. each kernel against its plain version
    fused = phase_fused(gen)
    sim = phase_similarity(gen)
    scene = phase_scene(frames65)
    dec = phase_decode(gen)

    # 5. the main path, with every launch counter read around it
    cfg = VenusConfig()
    t0 = time.perf_counter()
    mem = MEM.init(mem_config(), seed=0, device="cuda")
    embedder = TimedEmbedder(MEMEmbedder(mem))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    for _ in range(3):     # again, from nothing, where the trace is empty
        ops.reset_kernel_launches()
        ops.reset_scan_counts()
        embedder.seconds, embedder.frames = 0.0, 0
        mgr, results, times = run_main_path(worlds, cfg, embedder, D, card,
                                            "main", trace=True)
        if times["scene_trace"] is not None:
            break
        del mgr, results
    check(times["scene_trace"] is not None,
          "main: 3 traces of the ingest held no device event")
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
    st = times["scene_trace"]
    check(st["launches"] == launches["scene_score"],
          f"main trace: {st['launches']} scene launches in the ingest, "
          f"{launches['scene_score']} in the phase")
    print(f"  #2 in the main phase (profiler): {st['launches']} launches, "
          f"{st['device_us']:.2f} device us = "
          f"{st['device_us_per_launch']:.2f} a launch, "
          f"{100 * st['share_of_ingest_device']:.2f} % of the ingest's "
          f"{st['ingest_device_us'] / 1e3:.2f} device ms", flush=True)
    # where the segment stage of tick 1 goes
    seg = segment_split(worlds)
    seg["main_segment_s"] = times["stages"]["segment_ticks"][1]
    times["segment_split"] = seg
    print(f"  segment stage, tick 1 (s, host clock, {seg['sessions']} "
          f"sessions): main phase {seg['main_segment_s']:.4f}; replayed: "
          f"upload {seg['upload_s']:.4f}  #2 {seg['kernel_s']:.4f}  read "
          f"back {seg['readback_s']:.4f}", flush=True)
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

    # 11-12. serving: Venus retrieval feeding Qwen2-VL-7B, then MiniCPM3-4B
    serve = phase_serve(mgr, card)
    del mgr
    torch.cuda.empty_cache()
    serve_mla = phase_serve_mla(card)
    torch.cuda.empty_cache()

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

    def scan_row(name, source, replaces, r, n_launch):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=n_launch,
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    device_ms=r["device_ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    library_device_ms=r["library_device_ms"],
                    library_note="torch.bmm/mm over operands normalised "
                                 "beforehand: sims only")
    stack_row = scan_row("similarity_scan_stack", "similarity_scan.cu",
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
        dict(scan_row("similarity_scan", "similarity_scan_2d.cu",
                      "src/repro/kernels/similarity.py:148", sim["2d"],
                      dl["similarity_scan"]),
             max_abs_err=max(v["max_abs_err"] for k, v in sim.items()
                             if k.startswith("2d")),
             int8_ms=sim["2d_int8"]["ms"],
             int8_device_ms=sim["2d_int8"]["device_ms"],
             int8_bound_ms=sim["2d_int8"]["bound_ms"]),
        dict(name="scene_score", route="cuda",
             source="src/repro_torch/kernels/csrc/scene_score.cu",
             replaces="src/repro/kernels/scene_score.py:75",
             launches=launches["scene_score"],
             max_abs_err=max(v["max_abs_err"] for v in scene.values()),
             ms=scene["table"]["ms"], device_ms=scene["table"]["device_ms"],
             cold_device_ms=scene["table"]["cold_device_ms"],
             main_device_us_per_launch=st["device_us_per_launch"],
             main_device_us=st["device_us"],
             plain_ms=scene["table"]["plain_ms"],
             bound_ms=scene["table"]["bound_ms"],
             bound_by=scene["table"]["bound_by"], library_ms=None)]

    def decode_row(name, source, replaces, prefix, n_launch, cases):
        r = dec[f"{prefix}_bf16"]
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{source}",
                   replaces=replaces, launches=n_launch,
                   max_abs_err=max(dec[f"{prefix}_{c}"]["max_abs_err"]
                                   for c in cases),
                   ms=r["ms"], device_ms=r["device_ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], library_ms=r["library_ms"],
                   library_device_ms=r["library_device_ms"],
                   library_note="F.scaled_dot_product_attention, boolean "
                                "mask, enable_gqa",
                   f32_ms=dec[f"{prefix}_f32"]["ms"],
                   f32_device_ms=dec[f"{prefix}_f32"]["device_ms"],
                   f32_bound_ms=dec[f"{prefix}_f32"]["bound_ms"])
        return row
    kernels += [
        decode_row("gqa_decode", "decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:96",
                   "gqa", serve["launches"]["gqa_decode"],
                   ("bf16", "bf16_softcap30", "bf16_mha", "f32",
                    "bf16_holes", "bf16_c2000", "bf16_g16", "bf16_serve",
                    "bf16_g32", "bf16_d72", "f32_d6", "bf16_g128_d512")),
        dict(decode_row("mla_decode", "mla_decode.cu",
                        "src/repro/kernels/decode_attention.py:173",
                        "mla", serve_mla["launches"]["mla_decode"],
                        ("bf16", "f32", "bf16_holes", "bf16_c2000",
                         "bf16_serve", "bf16_dsv2", "bf16_dsv3",
                         "bf16_r30")),
             f32_source="src/repro_torch/kernels/csrc/decode_attention.cu",
             partial_device_ms=dec["mla_bf16"]["partial_device_ms"],
             serve_device_us_per_launch=serve_mla["mla_us_per_launch"])]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, fused=fused,
                       similarity=sim, scene=scene, decode=dec, main=times,
                       dense=dense, serve=serve, serve_mla=serve_mla,
                       mem=mem_out), f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
