#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Venus on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero), run in the order 1–4, 30, 10, 5, 6,
11, 12, 15–20, 7, 26, 13, 14, 8, 9, 21–25, 27, 28, 29:

1. build      — compile the CUDA kernels from ``src/repro_torch/kernels/
                csrc`` (one nvcc per source, all started together);
2. fused      — the fused retrieval kernel against its plain PyTorch
                version at S=16, N=8192, d=768, Q=8, T=32, K=8: f32, int8
                (from ``quantise_rows``) and wrapping (S, 2) ring windows
                (timed; the bound counts the rows the mask keeps, every
                row beside it); then the edge cases of
                ``scan_edge_cases`` (S=4, N=1000: d=6 and d=770, and d=768
                from an unaligned index view, f32 and int8) and of
                ``fused_cases`` (sessions with fewer valid rows than K,
                windows that wrap with whole chunks masked inside, targets
                past the total mass, N=8400). Raw counts, draws and top-K
                lanes equal; floats allclose (rtol 1e-5, atol 1e-6); a
                count of N has drawn_p 0; draw targets kept ≥ 1e-6 from
                every CDF value; each case checked to have launched the
                kernel; the host's plan of the score pass (tensor cores
                or ring stages, shared memory) held to the source's;
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
                kernel must have launched in this run; the ingest and then
                the queries run under the profiler (device activity only),
                which gives #2's device time over its launches in the
                ingest and #1's over its 4 in the queries (each launch
                must show in the trace); then tick 1's segment stage
                replayed with the device synchronised between upload, #2
                and the φ
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
                same memory; then a consolidating manager and a
                cluster_merge one (capacity 8, MEM at smoke width with
                OCR and detector prompts) carried to CPU twins by
                ``arena_from_numpy``: identical frame ids for akr,
                sampling and topk, two-stage where the tier holds
                history;
10. decode    — the two decode-attention kernels against their plain
                versions at the serving shapes (B=4 slots, C=2048 cache
                rows, bf16 and f32; per-slot ragged masks with one slot of
                a single valid row and one with none): GQA at Qwen2-VL-7B
                (H=28, Hkv=4, D=128; also softcap 30 and q_per_kv=1; in
                bf16 also masks with holes of whole tiles and a last-row
                mask, C=2000, G=16 at H=32, Hkv=2, and the zoo's other
                widths at G = 1: D=80 at H=Hkv=32 (Zamba2-2.7B) and D=64
                at H=Hkv=8 (Whisper-base); and the shapes
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
                source's layout at every routed shape. Both kernels'
                ``partials=True`` on both routes: GQA at Qwen2-VL-7B's
                widths, MLA at MiniCPM3-4B's and DeepSeek-V2-Lite's, each
                on the mask with holes (a sequence with none: the empty
                part) reduced to one part; MLA also on a shard with no
                valid row whose ckv/krope are NaN (exactly the empty
                part), and four shards' partials merged by
                ``merge_partials`` at Dv = 256 and 512. bf16 within one
                bf16 ulp (rtol 2^-7, atol 1e-6), f32 at rtol 1e-5 / atol
                1e-6.
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
                the dry run's argument bytes of the decode step (the
                bf16 weights, the 4 × 2048 cache) within 2 % of what
                building the model and the engine allocated, and the
                cost model's ``venus_query_latency`` of the main phase's
                akr group from its measured edge seconds;
12. serve_mla — the engine on MiniCPM3-4B at full width (bf16): 8 text
                requests of 8–64 tokens, 12 new tokens each;
                mla_decode launches == 62 × decode steps, every one on
                k_mla (``mla_decode.route_launches``); #6's device µs a
                launch in the step by the profiler; the same logits
                check;
13. tier      — the hierarchical tier through the entry points: the main
                phase's MEM embedder, 16 streams of 224² worlds of 16
                scenes into ``VenusConfig(memory_capacity=128,
                eviction="consolidate", coarse_capacity=32,
                coarse_block=16, coarse_topb=4)``; every session
                consolidates; the main phase's four query groups each run
                two-stage (two #1 launches, S·Q·B·block gathered rows,
                the coarse tier's bytes counted, no restack); the same
                specs with ``coarse=False`` (one flat launch each), then
                two-stage again; ingest stage times and each group's
                similarity and sample_expand seconds printed; then
                ``tier_8192`` (capacity 8192, filled by ``insert_batch``);
14. standing  — standing queries and the spill tier through the entry
                points: the main phase's MEM embedder and 16 worlds into
                ``VenusConfig(spill_dir=<a temporary directory>,
                host_retain=128)``; each session registers a text topk
                spec and an embedding spec (one of its index rows from
                the main phase, which must fire) before the ingest, which
                runs under the profiler (#1's device µs a standing
                launch): one #1 launch with ``tier="standing"`` a
                committing tick over the (G, pow2(n), d) slab,
                ``standing_scan_bytes`` its bytes, no restack; each launch
                held to the plain version on its operands (two top-K
                lanes may trade places only where the plain scores of
                their rows tie within the float tolerance; each swap is
                printed), every spec's top-K bit for bit an ad-hoc topk
                plan's over the same rows on the card; frames demoted, host windows within 128, a
                uniform group and every alert's frame ids read back equal
                to the worlds' frames, and after the closes no spill byte
                and no directory; the evaluation's host ms a tick by
                stage, ``_trim_archives``' seconds a tick and the spill
                directory's file system printed; then the edge slabs
                (``phase_standing_edges``: N = 1, 2, 4, G = 1 to 16, Q =
                1 or 2, K = 1 or 2, f32 and int8 at d = 768, and
                ``quantise_rows`` of the mirrors against the arena's int8
                rows);
15. serve_moe — the engine on DeepSeek-V2-Lite-16B at full width and
                depth (27 layers: 1 dense, 26 of 64 routed + 2 shared
                experts, top 6; MLA with R=512, Dr=64, 16 heads; bf16
                weights from seed 0, made on the card; 4 slots, max_len
                2048): 8 text requests of 8–64 tokens, 12 new tokens each;
                mla_decode launches == 27 × decode steps, every one on
                k_mla, and gqa_decode none; one step's logits kernel
                against plain (rel L2 ≤ 2^-5), each MoE routing flip
                between the two printed — where a flip occurs the gate
                holds the comparison with the plain step's experts pinned
                to the kernel step's — and every #6 launch of one step
                held to the plain version on its operands (one bf16 ulp);
                every MoE layer of one decode step and of a 64-token
                prefill (which drops pairs at capacity) held to a plain
                per-expert ``torch.matmul`` loop on its input (one bf16
                ulp);
                the step's device ms, busy share, kernels, #6's µs a
                launch and the MoE layers' device ms (profiler); the
                experts used a layer and the weight bytes a step against
                their bound at 3.35 TB/s; peak GB;
16. serve_olmoe — the same on OLMoE-1B-7B (16 MoE layers of 64 experts,
                top 8; GQA with QK-norm: #5 at G = 1), gqa_decode
                launches == 16 × decode steps, all on k_gqa_split;
17. serve_zoo — the same on GLM-4-9B (#5 at G = 16, half rotary),
                Nemotron-4-15B (G = 6, squared ReLU) and DeepSeek-LLM-7B
                (G = 1) at full width, each cut to 4 layers: 4 requests,
                8 new tokens each;
18. serve_hybrid — the same on Zamba2-2.7B at full width and depth (54
                Mamba2 layers; one weight-tied attention block after each
                group of 6: #5 at G = 1, D = 80, 9 launches a decode step,
                each application its own KV cache): 8 requests of 8–200
                tokens, two over 128 (the SSD's multi-chunk scan and its
                padded last chunk on the card), prefilled at their exact
                lengths; the bytes a step count the shared block once an
                application and the f32 SSM and conv state read and
                written; then ``state_continuation``: the model in f32
                (TF32 off) prefills 150 tokens of two sequences and
                decodes 4 more, each step's logits against its own
                train-mode logits at rtol = atol = 1e-3;
19. serve_rwkv — RWKV6-1.6B at full width and depth (24 layers, no
                attention: neither decode kernel may launch): 8 requests
                of 8–64 tokens at their exact lengths; the continuation
                over 24 tokens;
20. serve_whisper — Whisper-base at full width and depth (6 encoder, 6
                decoder layers; #5 at G = 1, D = 64, 6 a step): 8 requests
                of 8–64 tokens, each with 1,500 × 512 encoder frames
                (N(0, 0.02) from the seed, as the reference's launcher);
                the per-step cross K/V recompute's operations in the
                bound; the continuation over 20 tokens, its decode reading
                the encoder's output from the cache. Each serve phase
                frees its model before the next one starts.
21. train_mem — SigLIP training of venus-mem-large at full width and
                depth (f32 weights, bf16 activations, remat on): 20 steps
                of 32 synthetic pairs (a class a row: a prototype patch
                row over 784 patches, a caption); the contrastive accuracy
                of the last 5 steps above the first 5's;
22. train_lm  — DeepSeek-LLM-7B at full width cut to 4 layers: one
                batch's gradients with remat off and on (equal within
                1e-5 relative L2 a leaf, each one's memory printed), then
                20 steps of 4 × 512 tokens from ``lm_batches``; the last
                3 steps' mean loss below the first 3's;
23. train_moe — OLMoE-1B-7B at full width cut to 4 layers: 10 steps of
                4 × 512; then one batch's gradients with its routing
                recorded: pairs dropped, every gradient finite, each
                router's nonzero; the drop share and the experts reached
                a layer;
24. train_zoo — one step each (then one timed warm) of Qwen2-VL-7B (4
                layers, 1,024 vision tokens a row), MiniCPM3-4B (4 layers),
                Zamba2-2.7B (6 Mamba2 layers and the shared block once),
                RWKV6-1.6B (4 layers) and Whisper-base (full, 1,500
                frames a row): a finite loss and changed parameters;
25. train_parity — f32 with TF32 off, the card against the CPU on the
                same weights and batch: MEM at full width with 2 layers a
                tower, OLMoE at full width with 1 layer (the same routing
                on both); every gradient leaf within 1e-4 relative L2.
                Each training phase prints its seconds a step, tokens or
                pairs a second, peak ``max_memory_allocated``, the
                optimiser's share of a step (AdamW alone, CUDA events)
                and the card; each frees its models and optimiser state.
                No hand-written kernel launches on the train path.
26. shard     — the sharded, double-buffered memory path on one card, its
                slabs on ``cuda:0`` K times (``phase_shard``): the main
                worlds' 16 streams in 3 ticks of 64 frames at d = 768,
                capacity 8192 (``PixelEmbedder(dim=768)``, which does not
                touch sharding), into (a) an unsharded single-buffered
                oracle, (b) a K = 1 mesh, double-buffered, (c) K = 2, (d)
                K = 4, (e) K = 4 int8 beside an unsharded int8 oracle;
                an akr group before each tick equal on (a)–(d), every
                session's front rows bit-equal to its oracle's after each
                tick; then the akr, sampling, topk and a ``fused=False``
                group with equal draws, frame ids and n_drawn, one
                sharded launch a group, the gathered bytes under one f32
                (S, Q, cap) tensor, a double flush an append; every #1
                and #3 launch (one a slab) held to its plain version; a
                launch queued behind a sleep unchanged by two flushes
                (the streams' order); the tier configuration of phase 13
                at K = 4 against the unsharded tier manager (16 sessions
                filled by ``insert_batch``); ``DistributedVenusMemory``
                at K = 4 over 131,072 × 768 f32 rows (every per-shard #4
                launch held, the candidates' probabilities against the
                dense softmax renormalised over them, an empty index's
                zero mass; the lane order, a stable sort, timed against
                ``torch.topk`` on a shard's scores).
27. mesh_train — FSDP2 on one card: DeepSeek-LLM-7B at full width cut to
                4 layers, 3 steps of 4 × 512 tokens without a mesh, then
                the same 3 steps through ``fsdp_shard`` and
                ``make_train_step(mesh=)`` on a (1, 1) ``("data",
                "model")`` mesh over an NCCL process group of one rank;
                the losses at rtol 1e-6, the parameters after step 3
                within 1e-6 · max |p|; both step times; the dry run of the same step on the ``meta``
                device against the card: its argument bytes within 1 %
                of ``memory_allocated()``, its flops equal to
                ``FlopCounterMode`` around a card step, its temp bytes
                printed beside the step's peak. The process group is
                destroyed.
28. tp_serve  — serving on the model axis: ``python -m
                repro_torch.launch.serve --model K`` under ``torchrun``
                (each rank this script's ``--tp-worker``, around the
                launcher's ``main``), the K ranks on this card over gloo,
                bf16 weights from seed 0, 2 slots, 2 requests of 3
                tokens, then 4 teacher-forced decode steps:
                Qwen2-VL-7B at (1, 2), 2048 cache rows (each rank's 14 q
                and 2 KV heads, #5 on k_gqa_split at G = 7) and GLM-4-9B
                at full depth (40 layers) at (1, 4), 64 cache rows (2 KV
                heads: the cache split by its sequence, #5's partials on
                each rank's 16 rows merged across the ranks by one
                k_merge a layer; the held step has valid rows on two or
                more ranks, and a shard with none is the empty part);
                the MLA and MoE decoders at full width and depth:
                DeepSeek-V2-Lite-16B at (1, 4), 64 cache rows (4 heads,
                16 experts and a quarter of the shared expert a rank;
                #6's partials on each rank's 16 latent rows, merged
                across the ranks), MiniCPM3-4B at (1, 2), 64 cache rows
                (20 heads a rank, #6's partials on 32 rows) and
                OLMoE-1B-7B at (1, 2), 2048 cache rows (8 KV heads and
                32 experts a rank, #5 on k_gqa_split); the rest of the
                zoo: Zamba2-2.7B at (1, 4), all 54 layers, 2048 cache
                rows (20 of 80 Mamba2 heads, 8 of the shared block's 32
                heads a rank; #5 on k_gqa_split at D = 80, 9 a step),
                not held, and at 12 layers, held; RWKV6-1.6B at (1, 2)
                (16 of 32 heads a rank) at full depth, not held, and at
                4 layers, held; and
                Whisper-base at (1, 2), 448 cache rows, 1,500 encoder
                frames a request (4 of 8 heads a rank; #5 at D = 64);
                each against a one-process run of the same seed (run
                first), the teacher-forced logits within relative L2
                ``TP_BOUND`` a step (an MoE model's with the one
                process's experts pinned in a second teacher-forced run
                of the mesh, the bf16 router's flips of the unpinned run
                counted), a recurrent model's ``ssm`` or ``wkv`` shard
                after them on every rank within relative L2
                ``TP_BOUND`` a layer of the one process's heads; every #5 or #6 launch of the first decode step
                (each rank's partials reduced to one part), every
                cross-rank merge and every MoE layer's partial (before
                its all-reduce, against a plain loop over the rank's
                experts on the global routing) held to the plain
                versions on every rank (one bf16 ulp); the launches
                counted over the run; each rank's #5 or #6 device µs by
                the profiler over decode steps 2–4. The
                one-process run is the launcher's ``main`` in this
                process.
29. tp_train  — training on the model axis: ``python -m
                repro_torch.launch.train --model 2`` under ``torchrun``
                with 4 ranks on this card over gloo (each rank this
                script's ``--train-worker``, around the launcher's
                ``main``): DeepSeek-LLM-7B at full width cut to 4
                layers, f32 weights and activations, TF32 off, remat on,
                3 steps of 4 × 512 tokens (``mesh_train``'s batches) on
                a (2, 2) mesh — FSDP2 over ``data`` × the port's tensor
                parallelism over ``model``, every parameter a 2-D
                DTensor. Rank 0 first runs the same 3 steps in one
                process on the card (f32: ``mesh_train``'s are bf16);
                the mesh's losses within rtol ``TRAIN_TP_LOSS`` of its,
                every parameter after step 3 (gathered whole) within
                ``TRAIN_TP_UPDATE`` of its update a leaf (relative L2 of
                the difference over the one process's step-1-to-3
                movement; AdamW moves the elements whose gradient sits
                at f32 rounding level by a share of lr), each printed;
                every rank's model-axis collective bytes by op in each
                step equal to ``launch.dryrun``'s count for the same
                config, shape and mesh; no kernel launched; the step
                times by rank 0's clock.
30. cluster   — the clustering kernel (``csrc/cluster.cu``) against its
                plain version: frames of the benchmark's world (d =
                2,352, K = 16) at T = 1, 2, 61 and 256; n reaching K (K
                = 4); d = 48; more than 16 clusters on chip and in
                device memory; the device-memory route at d = 9,408. n,
                assignments and counts equal, index frames but for a
                two-member tie, centroids at rtol 1e-5 / atol 1e-6; the
                T = 61 partition timed (device µs by the profiler).
                Alone: ``python3 -c "import chip_smoke;
                chip_smoke.phase_cluster()"``.

Prints the card's name and power limit, one line per phase, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Every kernel's launch count is read around the phase that drives its path
(main: fused retrieval, scene score and clustering, one launch a
partition; dense: the dense scans; serve,
serve_mla, serve_moe, serve_olmoe, serve_zoo, serve_hybrid, serve_rwkv
and serve_whisper: the decode kernels; tp_serve: #5 or #6 and the
cross-rank merge in each rank; mesh_train and tp_train: none (training
runs no hand-written kernel);
tier: fused retrieval, two a group; standing: fused retrieval, one a
committing tick; shard: fused retrieval and the dense stack scan, one a
slab a group).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, fp32 outside tensor cores
BF16_TENSOR_FLOP_PER_S = 989e12    # H100 SXM, bf16 on the tensor cores
S, N, D, Q, T, K = 16, 8192, 768, 8, 32, 8
TAU = 0.1


def elapsed() -> None:
    """Print the script's seconds so far (between main's phase groups)."""
    print(f"  [{time.perf_counter() - T_START:.1f} s since start]",
          flush=True)


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


def fused_cases(gen):
    """The fused scan's cases beyond the table's shape, at d = 768 (f32
    rows staged through the CUDA cores' ring, int8 rows on the tensor
    cores), each with a ragged last chunk: ``few_rows`` (S=4, N=1000:
    sessions of 1000, 3 and 0 valid rows and 613, so top-K carries -1e30
    lanes, lowest lane first), ``wrap_holes`` (S=4, N=2048: windows that
    wrap around the ring with whole 256-row chunks masked inside them,
    and one that does not wrap; f32 and int8), ``ring_int8`` (the
    few_rows sessions over int8 rows of d = 800, which take the ring),
    ``beyond_mass`` (the few_rows inputs with targets at and past the
    total mass: count N, drawn_p 0) and ``n8400`` (S=16, N=8400,
    wrapping windows: a row of two slabs; f32 and int8) → [(name, query,
    index, valid, extra targets)]."""
    import torch
    from repro_torch.core.memory import quantise_rows
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)

    def rows(s, n):
        return (torch.randn((s, Q, D), generator=gen, device=dev),
                torch.randn((s, n, D), generator=gen, device=dev))
    q4, x4 = rows(4, 1000)
    few = torch.tensor([1000, 3, 0, 613], **i32)
    qw, xw = rows(4, 2048)
    holes = torch.tensor([[1900, 400], [2047, 2], [100, 50], [1000, 2000]],
                         **i32)
    q16, x16 = rows(S, 8400)
    wins = torch.stack([torch.randint(0, 8400, (S,), generator=gen, **i32),
                        torch.randint(1, 8401, (S,), generator=gen, **i32)],
                       dim=1)
    check(bool((wins.sum(1) > 8400).any()), "n8400: a window wraps")
    x16_8 = torch.from_numpy(quantise_rows(x16.cpu().numpy())[0]).to(dev)
    xw8 = torch.from_numpy(quantise_rows(xw.cpu().numpy())[0]).to(dev)
    q800 = torch.randn((4, Q, 800), generator=gen, device=dev)
    x800 = torch.from_numpy(quantise_rows(torch.randn(
        (4, 1000, 800), generator=gen, device=dev).cpu().numpy())[0]).to(dev)
    beyond = torch.tensor([1.0 + 2 ** -10, 1.5, 2.0], device=dev)
    return [("few_rows", q4, x4, few, None),
            ("wrap_holes", qw, xw, holes, None),
            ("wrap_holes_int8", qw, xw8, holes, None),
            ("ring_int8", q800, x800, few, None),
            ("beyond_mass", q4, x4, few, beyond),
            ("n8400", q16, x16, wins, None),
            ("n8400_int8", q16, x16_8, wins, None)]


def check_scan_plan():
    """The host's mirror of the score pass's plan (``similarity.
    scan_plan``) against the source's own (``scan::mma_ok``,
    ``scan::scan_stages`` and the shared memory of each, exported by the
    fused library), at every width the cases take and at the limits."""
    import ctypes
    from repro_torch.kernels import build, similarity
    lib = build.load("fused_retrieve.cu")
    lib.fused_retrieve_smem.restype = ctypes.c_longlong
    n = 0
    for d in (6, 8, 768, 770, 784, 792, 800, 804, 808, 1024, 1808, 1824,
              2416, 2432, 7264):
        for elt in (4, 1):
            for aligned in (0, 1):
                path, st, smem = similarity.scan_plan(d, elt, bool(aligned))
                got = (bool(lib.fused_retrieve_mma(d, elt, aligned)),
                       lib.fused_retrieve_stages(d, elt, aligned),
                       lib.fused_retrieve_smem(d, elt, aligned))
                check(got[0] == (path == "mma")
                      and (got[0] or got[1] == st) and got[2] == smem,
                      f"scan plan d={d} elt={elt} aligned={aligned}: "
                      f"source {got}, host {(path, st, smem)}")
                n += 1
    return n


def phase_fused(gen):
    import torch
    from repro_torch.core.memory import quantise_rows
    from repro_torch.kernels import ops, ref, similarity
    dev = torch.device("cuda")
    n_plans = check_scan_plan()
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
    cases = ([("f32", query, index32, sizes, None),
              ("int8", query, index8, sizes, None),
              ("f32_windows", query, index32, wins, None)]
             + [c + (None,) for c in scan_edge_cases(gen)]
             + fused_cases(gen))
    out = {}
    for name, query, index, valid, extra in cases:
        n = index.shape[1]
        vmask = ref.as_valid_mask(valid, n)
        sims, m, l = ref.similarity_scan_stack_ref(query, index, valid,
                                                   tau=TAU)
        probs = ref.scan_probs(sims, m, l, vmask[:, None, :], TAU)
        del sims
        targets, margin = margin_targets(probs, gen, T)
        del probs
        if extra is not None:       # targets at and past the total mass
            targets[..., -len(extra):] = extra
        run_k = lambda: similarity.fused_retrieve_scan_stack(
            query, index, valid, targets, tau=TAU, n_topk=K)
        run_p = lambda: ref.fused_retrieve_stack_ref(
            query, index, valid, targets, tau=TAU, n_topk=K)
        before = similarity.fused_retrieve_scan_stack.launches
        raw = run_k()
        check(similarity.fused_retrieve_scan_stack.launches == before + 1,
              f"fused {name}: the kernel did not launch")
        raw_p = run_p()
        got, want = ops.finalize(raw, n), ops.finalize(raw_p, n)
        torch.cuda.synchronize()
        check(torch.equal(raw.counts, raw_p.counts),
              f"fused {name}: raw counts differ in "
              f"{int((raw.counts != raw_p.counts).sum())} places")
        past = raw.counts == n
        check(bool((raw.drawn_p[past] == 0).all()),
              f"fused {name}: drawn_p of a count of N is not 0")
        if extra is not None:
            check(bool(past[..., -len(extra):].all()),
                  f"fused {name}: targets past the mass did not count N")
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
        if name not in ("f32", "int8", "f32_windows"):   # checked only
            out[name] = dict(max_abs_err=err, margin=margin,
                             d=index.shape[2], n=n)
            print(f"phase fused[{name}]: ok  d={index.shape[2]} N={n}  "
                  f"max_abs_err {err:.3e}  target margin {margin:.2e}",
                  flush=True)
            continue
        ms = cuda_ms(run_k, reps=10, warmup=2)
        dev_ms = device_ms(run_k)
        plain = cuda_ms(run_p, reps=2)
        elt = index.element_size()
        # the bound reads the rows the mask keeps (and, beside it, every
        # row), the queries, the mask and the targets once, and writes the
        # outputs once
        small = (S * Q * D * 4 + valid.numel() * valid.element_size()
                 + S * Q * T * 4 + S * Q * (2 * T + 2 * K + 4) * 4)
        flops = 2.0 * Q + 3.0
        n_valid = int(vmask.sum())
        b, by = bound_ms(n_valid * D * elt + small, flops * n_valid * D)
        b_all, _ = bound_ms(S * N * D * elt + small, flops * S * N * D)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, all_rows_bound_ms=b_all,
                         valid_rows=n_valid, max_abs_err=err, margin=margin)
        print(f"phase fused[{name}]: ok  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms)  plain "
              f"{plain:.4f} ms  bound {b:.4f} ms ({by}; {n_valid} valid "
              f"rows; all rows {b_all:.4f})  max_abs_err "
              f"{err:.3e}  target margin {margin:.2e}", flush=True)
    print(f"  fused: the host's plan of the score pass equals the source's "
          f"at {n_plans} widths", flush=True)
    return out


# the hierarchical tier at the production geometry: capacity N = 8192,
# coarse_block 64 (n_blocks 128), coarse_capacity 256 (n_coarse 384),
# top-B 4, so stage 2 scans B·block = 256 candidates a query
TIER_BLOCK, TIER_NB, TIER_NC, TIER_B = 64, 128, 384, 4


def stage_cases(gen):
    """The two launches of a two-stage group at the production geometry
    → [(name, query, index, valid, K)]. ``stage1``: S=16, Q=8 over the
    coarse tier (N=384), every block summary valid and 100 of the 256
    consolidated rows, K=B=4. ``stage2``: the S·Q = 128 lanes of the
    candidate operand, Q=1, N=256: per lane two winners are whole live
    blocks and two consolidated rows (one valid row out of 64, the rest
    zero rows, as ``tiering._gather_candidates`` builds them), K=8."""
    import torch
    dev = torch.device("cuda")
    q1 = torch.randn((S, Q, D), generator=gen, device=dev)
    x1 = torch.randn((S, TIER_NC, D), generator=gen, device=dev)
    v1 = torch.zeros((S, TIER_NC), dtype=torch.bool, device=dev)
    v1[:, :TIER_NB] = True
    for s in range(S):
        pick = torch.randperm(TIER_NC - TIER_NB, generator=gen,
                              device=dev)[:100]
        v1[s, TIER_NB + pick] = True
    lanes, c = S * Q, TIER_B * TIER_BLOCK
    q2 = torch.randn((lanes, 1, D), generator=gen, device=dev)
    x2 = torch.randn((lanes, c, D), generator=gen, device=dev)
    v2 = torch.zeros((lanes, TIER_B, TIER_BLOCK), dtype=torch.bool,
                     device=dev)
    blocks = torch.rand((lanes, TIER_B), generator=gen,
                        device=dev).argsort(-1) < 2      # two block winners
    v2[blocks] = True
    v2[..., 0] = True
    x2 = x2.view(lanes, TIER_B, TIER_BLOCK, D)
    x2[..., 1:, :] *= blocks[..., None, None]
    check(int(v2.sum()) == lanes * (2 * TIER_BLOCK + 2),
          "stage2: two whole blocks and two single rows a lane")
    return [("stage1", q1, x1, v1, TIER_B),
            ("stage2", q2, x2.view(lanes, c, D), v2.view(lanes, c), K)]


def hold_fused(what, query, index, valid, targets, k, *, draws=True,
               tau=TAU, ties=None):
    """One #1 launch held to its plain version on the same inputs: top-K
    lanes equal, and with ``draws`` the draws and raw counts too; top-K
    values, m, l, p_max (and the drawn probabilities) at rtol 1e-5 / atol
    1e-6. ``draws=False`` for a stage-1 launch, whose dummy zero target
    is not used. ``ties`` (a list) lets two top-K lanes trade places only
    where the plain version's own scores of the two rows agree within
    that tolerance (rows of near-equal embeddings, whose order the two
    summation orders may break either way); each such swap is appended
    to it. Returns (max abs error but l's, the kernel's call, the plain
    version's call)."""
    import torch
    from repro_torch.kernels import ops, ref, similarity
    run_k = lambda: similarity.fused_retrieve_scan_stack(
        query, index, valid, targets, tau=tau, n_topk=k)
    run_p = lambda: ref.fused_retrieve_stack_ref(
        query, index, valid, targets, tau=tau, n_topk=k)
    before = similarity.fused_retrieve_scan_stack.launches
    raw = run_k()
    check(similarity.fused_retrieve_scan_stack.launches == before + 1,
          f"{what}: the kernel did not launch")
    raw_p = run_p()
    n = index.shape[1]
    got, want = ops.finalize(raw, n), ops.finalize(raw_p, n)
    ints = ("draws", "topk_i") if draws else ("topk_i",)
    floats = (("drawn_p",) if draws else ()) + ("topk_v", "m", "l", "p_max")
    if draws:
        check(torch.equal(raw.counts, raw_p.counts),
              f"{what}: raw counts differ")
    for f in ints:
        a, b = getattr(got, f), getattr(want, f)
        if f == "topk_i" and ties is not None and not torch.equal(a, b):
            sims = ref.similarity_scan_stack_ref(query, index, valid,
                                                 tau=tau)[0]
            vm = ref.as_valid_mask(valid, n)[:, None, :].expand_as(sims)
            sa, sb = (torch.gather(sims, -1, x.long()) for x in (a, b))
            ok_a = torch.gather(vm, -1, a.long())
            diff = a != b
            tied = (sa - sb).abs() <= 1e-6 + 1e-5 * sb.abs()
            where = diff.nonzero().tolist()
            check(bool((tied & ok_a)[diff].all()),
                  f"{what}: topk_i differ at {where}: kernel lanes "
                  f"{a[diff].tolist()} (plain scores {sa[diff].tolist()}), "
                  f"plain lanes {b[diff].tolist()} ({sb[diff].tolist()})")
            ties.extend((tuple(w), float((sa - sb)[tuple(w)]))
                        for w in where)
            continue
        check(torch.equal(a, b),
              f"{what}: {f} differ in {int((a != b).sum())} places")
    err = 0.0
    for f in floats:
        a, b = getattr(got, f), getattr(want, f)
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
              f"{what}: {f} max abs err {float((a - b).abs().max())}")
        if f != "l":
            err = max(err, float((a - b).abs().max()))
    return err, run_k, run_p


def phase_fused_stages(gen, card):
    """Kernel #1 at the two stage shapes of the hierarchical tier, held to
    its plain version: stage 1 with the executor's dummy zero target
    (its draws are not used, so only top-K lanes and values, m, l and
    p_max are held), stage 2 with ``margin_targets``; integers equal,
    floats at rtol 1e-5 / atol 1e-6. Each timed by ``device_ms``, the
    bound over the rows the mask keeps. Then the stage-2 candidate gather
    (``tiering._gather_candidates``) over a 16-slot arena of 8192 rows,
    timed the same way."""
    import torch
    from repro_torch.core import tiering
    from repro_torch.core.memory import MemoryArena
    from repro_torch.kernels import ref
    out = {}
    for name, query, index, valid, k in stage_cases(gen):
        s, q, _ = query.shape
        n = index.shape[1]
        if name == "stage1":
            targets, margin = torch.zeros((s, q, 1), device=query.device), None
        else:
            sims, m, l = ref.similarity_scan_stack_ref(query, index, valid,
                                                       tau=TAU)
            probs = ref.scan_probs(sims, m, l, valid[:, None, :], TAU)
            targets, margin = margin_targets(probs, gen, T)
            del sims, probs
        err, run_k, run_p = hold_fused(f"fused {name}", query, index, valid,
                                       targets, k, draws=name == "stage2")
        dev_ms = device_ms(run_k)
        ms = cuda_ms(run_k, reps=10, warmup=2)
        plain = cuda_ms(run_p, reps=2)
        t = targets.shape[-1]
        small = (s * q * D * 4 + valid.numel() + s * q * t * 4
                 + s * q * (2 * t + 2 * k + 4) * 4)
        n_valid = int(valid.sum())
        b, by = bound_ms(n_valid * D * 4 + small, (2.0 * q + 3.0) * n_valid
                         * D)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, valid_rows=n_valid,
                         max_abs_err=err, margin=margin, s=s, q=q, n=n,
                         k=k, t=t)
        print(f"phase fused[{name}]: ok  S={s} Q={q} N={n} T={t} K={k}  "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms)  plain "
              f"{plain:.4f} ms  bound {b:.4f} ms ({by}; {n_valid} valid "
              f"rows)  max_abs_err {err:.3e}"
              + (f"  target margin {margin:.2e}" if margin else "")
              + f"  [{card}]", flush=True)
    # the stage-2 operand's gather over a production-size arena
    arena = MemoryArena(N, D, coarse_capacity=TIER_NC - TIER_NB,
                        coarse_block=TIER_BLOCK, device="cuda")
    for _ in range(S):
        arena.add_session()
    arena.emb.copy_(torch.randn(arena.emb.shape, generator=gen,
                                device="cuda"))
    arena.coarse_emb.copy_(torch.randn(arena.coarse_emb.shape,
                                       generator=gen, device="cuda"))
    arena.coarse_valid[:] = True
    arena.version += 1
    winners = torch.stack([torch.randperm(TIER_NC, generator=gen,
                                          device="cuda")[:TIER_B * Q]
                           for _ in range(S)]).view(S, Q, TIER_B).int()
    gather = lambda: tiering._gather_candidates(arena, winners)
    emb = gather()[0]
    check(emb.shape == (S, Q, TIER_B * TIER_BLOCK, D), "gather shape")
    nbytes = emb.numel() * 4
    n_blk = int((winners < TIER_NB).sum())
    read = (n_blk * TIER_BLOCK + winners.numel() - n_blk) * D * 4
    g_ms = device_ms(gather)
    gb, _ = bound_ms(read + nbytes, 0.0)
    split = kernels_by_name(gather)
    out["gather"] = dict(device_ms=g_ms, operand_bytes=nbytes,
                         read_bytes=read, bound_ms=gb, by_kernel_us=split)
    print(f"phase fused[gather]: ok  candidate operand {nbytes / 1e6:.1f} MB "
          f"({S}x{Q} lanes x {TIER_B * TIER_BLOCK} rows x {D}; "
          f"{n_blk} of {winners.numel()} winners blocks), device "
          f"{g_ms:.4f} ms (bound: {read / 1e6:.1f} MB read, the operand "
          f"written: {gb:.4f} ms)  [{card}]", flush=True)
    if split is not None:
        print(f"  gather by kernel (profiler; launches, device us a call): "
              f"{ {k: (n, round(us, 2)) for k, (n, us) in split.items()} }",
              flush=True)
    del arena, emb
    return out


def kernels_by_name(fn, reps: int = 5):
    """``fn``'s device time by kernel, from one profiler trace of ``reps``
    calls: {name without its template arguments: (launches a call,
    device us a call)}, dearest first; None for an empty trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _by_name([e for e in prof.events()
                     if e.device_type == DeviceType.CUDA], reps) or None


def _by_name(events, reps):
    """{kernel name without its template arguments (a mangled name cut
    to 60 characters): (launches, device us), each a call of ``reps``},
    dearest first."""
    by = {}
    for e in events:
        name = e.name.removeprefix("void ").split("<")[0].split("(")[0]
        name = name[:60]
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + e.time_range.end - e.time_range.start)
    return {k: (n / reps, us / reps) for k, (n, us) in
            sorted(by.items(), key=lambda kv: -kv[1][1])}


def _scan_check(name, got, want, valid, sessions_empty=(), tau=TAU):
    """Kernel triple vs plain triple (+ the epilogue's probs of each, at
    the scan's ``tau``): allclose at rtol 1e-5 / atol 1e-6; empty sessions
    give l = N and probs = 1/N. Returns the max abs error (l, a sum of N
    terms, is judged relative only)."""
    import torch
    from repro_torch.kernels import ref
    n = got[0].shape[-1]
    pk = ref.scan_probs(*got, valid, tau)
    pp = ref.scan_probs(*want, valid, tau)
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


def make_worlds(n: int, resolution: int, n_scenes: int = 3, seed0: int = 0):
    """n ``VideoWorld``s of seeds seed0.. , rendered by 8 threads (numpy's
    random fills and array ops release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.data.video import VideoWorld, WorldConfig
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(lambda s: VideoWorld(WorldConfig(
            n_scenes=n_scenes, resolution=resolution, seed=s)),
            range(seed0, seed0 + n)))


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


def cluster_cases():
    """The clustering kernel's cases → [(name, vecs (T, d) on the card,
    threshold, K, route)]: frames of camera 0 of the benchmark's world
    (``perfbench/traffic/ingest-16cam.json``, seed 7) pooled 8 × 8 (d =
    2,352) at the cell's threshold 0.35 and K = 16, T = 1, 2, 61 and 256
    (four chunks); the 256 frames at K = 4 (n reaches K); d = 48 blobs
    (T = 40, K = 8) and d = 48 noise at threshold 0.1 (n reaches K = 4);
    more than 16 clusters, one reduction a chunk of 16: d = 48 at K = 40
    on chip and d = 2,352 at K = 40 in device memory; and the device-
    memory route at the cell's K: frames pooled 4 × 4 (d = 9,408)."""
    import torch
    from perfbench.world import CameraWorld
    from repro_torch.core.clustering import frame_vectors
    with open(os.path.join(HERE, "perfbench", "traffic",
                           "ingest-16cam.json")) as f:
        traffic = json.load(f)
    world = CameraWorld.from_traffic(traffic, 7, "cuda")
    frames = torch.cat([world.render(0, c) for c in range(4)])   # 256
    v8 = frame_vectors(frames, 8).contiguous()
    v4 = frame_vectors(frames[:61], 4).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(34)
    centres = 5.0 * torch.arange(4, device="cuda")[:, None] + torch.rand(
        (4, 48), generator=gen, device="cuda")
    blobs = (centres.repeat_interleave(10, 0)
             + 0.01 * torch.randn((40, 48), generator=gen, device="cuda"))
    noise = 10.0 * torch.randn((64, 48), generator=gen, device="cuda")
    return [("t1", v8[:1], 0.35, 16, "smem"),
            ("t2", v8[:2], 0.35, 16, "smem"),
            ("t61", v8[:61], 0.35, 16, "smem"),
            ("t256", v8, 0.35, 16, "smem"),
            ("t256_k4", v8, 0.35, 4, "smem"),
            ("d48_blobs", blobs, 1.0, 8, "smem"),
            ("d48_k4", noise, 0.1, 4, "smem"),
            ("d48_k40", noise, 0.1, 40, "smem"),
            ("t256_k40_global", v8, 0.02, 40, "global"),
            ("d9408_global", v4, 0.35, 16, "global")]


def phase_cluster():
    """The clustering kernel (``csrc/cluster.cu``) against its plain
    version in every case of ``cluster_cases``: n, assignments and counts
    equal; index frames equal but where a cluster of two members ties
    (ROADMAP "Two-member clusters tie on the index frame"); centroids at
    rtol 1e-5 / atol 1e-6; each case one launch on the route it names,
    its shared memory held to the source's count. The T = 61 partition
    (the cell's ≈ 61 frames a partition) timed: the kernel's device µs by
    the profiler, the wrapper's wall ms and the plain loop's."""
    import torch
    from repro_torch.core.clustering import cluster_partition
    from repro_torch.kernels import cluster, ref
    out = {}
    for name, vecs, thr, k, route in cluster_cases():
        t, d = vecs.shape
        plan = cluster.cluster_plan(t, d, k)
        check(plan.route == route, f"cluster {name}: plan {plan}, not "
                                   f"route {route}")
        check(plan.smem == cluster.kernel_smem_bytes(
            d, k, plan.threads, route == "smem"),
            f"cluster {name}: the plan's shared memory is not the source's")
        before = cluster.cluster_partition.launches
        run_k = lambda: cluster_partition(vecs, threshold=thr,
                                          max_clusters=k)
        got = run_k()
        want = ref.cluster_partition_ref(vecs, thr, k)
        torch.cuda.synchronize()
        check(cluster.cluster_partition.launches == before + 1,
              f"cluster {name}: the kernel did not launch once")
        w_assign, w_n, w_cent, w_counts, w_index = want
        n = int(w_n)
        check(int(got.n_clusters) == n, f"cluster {name}: n "
                                        f"{int(got.n_clusters)} != {n}")
        check(torch.equal(got.assignments, w_assign),
              f"cluster {name}: assignments differ at "
              f"{torch.nonzero(got.assignments != w_assign)[:8].tolist()}")
        check(torch.equal(got.counts, w_counts),
              f"cluster {name}: counts {got.counts.tolist()} != "
              f"{w_counts.tolist()}")
        ties = [c for c in range(k) if int(got.index_frames[c])
                != int(w_index[c])]
        check(all(c < n and int(w_counts[c]) == 2 for c in ties),
              f"cluster {name}: index frames differ outside a two-member "
              f"tie at clusters {ties}")
        err = float((got.centroids - w_cent).abs().max())
        check(torch.allclose(got.centroids, w_cent, rtol=1e-5, atol=1e-6),
              f"cluster {name}: centroids max abs err {err:.3e}")
        row = dict(t=t, d=d, k=k, threshold=thr, n=n, plan=plan._asdict(),
                   two_member_ties=len(ties), max_abs_err=err)
        if name == "t61":
            b, by = bound_ms(t * d * 4 + k * d * 4 + (1 + t + k) * 4,
                             3.0 * t * k * d)
            row.update(ms=cuda_ms(run_k, reps=50, warmup=3),
                       plain_ms=cuda_ms(lambda: ref.cluster_partition_ref(
                           vecs, thr, k), reps=3),
                       bound_ms=b, bound_by=by,
                       kernel_us=kernel_us(run_k, reps=50))
            us = (row["kernel_us"] or {}).get("k_cluster")
            row["device_us"] = us
            print(f"phase cluster[{name}]: ok  kernel {row['ms']:.4f} ms "
                  f"wall, device "
                  + ("not measured" if us is None else
                     f"{us:.2f} us = {us / t:.3f} us a frame")
                  + f" against the serial floor aimed at {3 * t} us (3 us "
                  f"a frame)  plain {row['plain_ms']:.3f} ms  bytes bound "
                  f"{b:.5f} ms ({by})  n {n}  plan {tuple(plan)}",
                  flush=True)
            _print_kernel_us(row["kernel_us"])
        else:
            print(f"phase cluster[{name}]: ok  T={t} d={d} K={k} n={n}  "
                  f"two-member ties {len(ties)}  max_abs_err {err:.3e}  "
                  f"plan {tuple(plan)}", flush=True)
        out[name] = row
    out["launches"] = cluster.cluster_partition.launches
    print(f"phase cluster: ok  {len(out) - 1} cases, one launch each; "
          f"{out['launches']} launches with the timed ones", flush=True)
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
    # a TimedEmbedder's seconds in the ticks, before the flush embeds more
    stages["embed_ticks_s"] = getattr(embedder, "seconds", 0.0)
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


def kernel_in_trace(prof, launches: int, parts, what: str):
    """A kernel's device time in a traced phase: the time its parts (the
    kernels whose names hold each of ``parts``) cover, the union of their
    intervals, so a PDL'd part that starts early counts once, over its
    ``launches`` launches, and the device time of every kernel in the
    trace. None where the trace holds no device event at all (the
    profiler now and then returns such a trace); else fails unless it
    holds one of each part for each launch. The ``torch.cuda._sleep``
    pad at the head of a trace (``spin_kernel``) is not counted."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.name]
    if not kern:
        return None
    found = {p: [e for e in kern if p in e.name] for p in parts}
    check(launches > 0 and all(len(v) == launches for v in found.values()),
          f"{what} trace: { {p: len(v) for p, v in found.items()} } for "
          f"{launches} launches")
    us = _covered_us([e for v in found.values() for e in v])
    busy = _covered_us(kern)
    return dict(launches=launches, device_us=us,
                device_us_per_launch=us / launches, traced_device_us=busy,
                share_of_traced_device=us / busy)


def unit_queries_np(n: int, dim: int, seed: int):
    import numpy as np
    qe = np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)
    return qe / np.linalg.norm(qe, axis=-1, keepdims=True)


# (group, strategy, budget, text?): the query groups of every phase
QUERY_GROUPS = (("akr", "akr", None, False),
                ("sampling", "sampling", 16, False),
                ("topk", "topk", 8, False),
                ("text", "akr", None, True))


def run_queries(mgr, n_sessions: int, dim: int, coarse=None,
                text: bool = True):
    """8 queries per session under akr, sampling and topk, and 8 text
    queries per session (akr, embedded by the manager's embedder): one
    execution group (one fused launch, two where the group is two-stage)
    each, from ``QUERY_GROUPS``. ``coarse=None``: through
    ``query_batch_cross``; True or False: the same specs through
    ``execute(plan(specs), coarse=coarse)``. Returns (per-group results,
    host-clock seconds of each)."""
    from repro_torch.core.queryplan import QuerySpec
    sids = [s for s in range(n_sessions) for _ in range(8)]
    qe = unit_queries_np(len(sids), dim, 5)
    texts = [f"what happens on camera {s} around event {j % 8}"
             for j, s in enumerate(sids)]
    results, qtimes = {}, {}
    for group, strategy, budget, is_text in QUERY_GROUPS:
        if is_text and not text:
            continue
        t0 = time.perf_counter()
        if coarse is None:
            inputs = dict(texts=texts) if is_text else dict(query_embs=qe)
            results[group] = mgr.query_batch_cross(
                sids, strategy=strategy, budget=budget, **inputs)
        else:
            specs = [QuerySpec(sid=s, strategy=strategy, budget=budget,
                               text=texts[j] if is_text else None,
                               embedding=None if is_text else qe[j])
                     for j, s in enumerate(sids)]
            results[group] = mgr.execute(mgr.plan(specs), coarse=coarse)
        qtimes[group] = time.perf_counter() - t0
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
    """Ingest, then the queries. ``trace``: the ingest and then the
    queries each run under the profiler (device activity only), which
    reads #2 in the ingest and #1 in the queries (``kernel_in_trace``,
    None for an empty trace); their host clocks then carry the tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import scene_score, similarity
    times = {}
    if trace:
        before = scene_score.scene_score.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mgr, ticks, stages = ingest_streams(worlds, cfg, embedder, dim,
                                                "cuda")
            torch.cuda.synchronize()
        times["scene_trace"] = kernel_in_trace(
            prof, scene_score.scene_score.launches - before,
            ("k_scene<", "k_scene_sum"), "main ingest")
        before = similarity.fused_retrieve_scan_stack.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            results, qtimes = run_queries(mgr, len(worlds), dim)
            torch.cuda.synchronize()
        times["fused_trace"] = kernel_in_trace(
            prof, similarity.fused_retrieve_scan_stack.launches - before,
            ("k_scores<", "k_finish"), "main queries")
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


TIER_SCENES = 16        # ≈ 160 index rows a session: every one overflows
STAGES = ("segment", "cluster", "embed_insert")


def hold_tier_launches(mgr, label, text=True):
    """One more round of the query groups, two-stage, with every #1
    launch's operands captured at ``ops.fused_retrieve_stack``, then each
    launch held to the plain version on those inputs (``hold_fused``;
    stage 1 without its dummy draws): the kernel at the shapes the tier
    gives it. Returns the launches held, their shapes and the max abs
    error."""
    from repro_torch.kernels import ops
    orig, calls = ops.fused_retrieve_stack, []

    def capture(query, index, *, tau, valid, targets, n_topk, tier="fine",
                **mesh):
        calls.append((tier, query, index, valid, targets, n_topk, tau))
        return orig(query, index, tau=tau, valid=valid, targets=targets,
                    n_topk=n_topk, tier=tier, **mesh)
    ops.fused_retrieve_stack = capture
    try:
        run_queries(mgr, S, D, coarse=True, text=text)
    finally:
        ops.fused_retrieve_stack = orig
    tiers = [c[0] for c in calls]
    check(tiers and tiers == ["coarse", "fine"] * (len(tiers) // 2),
          f"{label}: launches {tiers}, not coarse then fine a group")
    err, shapes = 0.0, []
    for j, (tier, q, x, v, t, k, tau) in enumerate(calls):
        shape = (tier, *q.shape, x.shape[1], t.shape[-1], k)
        e, _, _ = hold_fused(f"{label} launch {j} {shape}", q, x, v, t, k,
                             draws=tier == "fine", tau=tau)
        err = max(err, e)
        shapes.append(shape)
    return dict(held=len(calls), shapes=sorted(set(shapes)),
                max_abs_err=err)


def tier_query_runs(mgr, label, text=True):
    """The query groups on a manager whose every session consolidated:
    two-stage, then the same specs with ``coarse=False`` (the flat scan),
    then two-stage again. Checks each group two-stage with two #1
    launches, the rows gathered and the coarse bytes counted, and no
    restack. Returns the groups' seconds and their ``similarity`` and
    ``sample_expand`` timings, and the fused launches, by run."""
    import torch
    from repro_torch.kernels import ops
    a, cfg = mgr.arena, mgr.cfg
    n_groups = 4 if text else 3
    runs, launches = {}, {}
    for run, coarse in (("two_stage", True), ("flat", False),
                        ("two_stage_again", True)):
        mgr.reset_io_stats(include_memories=False)
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        ops.reset_scan_counts()
        results, qtimes = run_queries(mgr, S, D, coarse=coarse, text=text)
        torch.cuda.synchronize()
        launches[run] = ops.kernel_launches()["fused_retrieve"]
        counts = ops.scan_counts()
        check(mgr.io_stats["stack_rebuilds"] == 0,
              f"{label}: stack_rebuilds")
        check_results(mgr, S, results, f"{label} {run}")
        if coarse:
            check(mgr.io_stats["two_stage_groups"] == n_groups
                  == mgr.io_stats["group_scans"],
                  f"{label}: every group two-stage: {mgr.io_stats}")
            check(launches[run] == 2 * n_groups
                  and counts["two_stage_scans"] == n_groups,
                  f"{label}: two #1 launches a group: {launches[run]}, "
                  f"{counts}")
            check(counts["fine_gather_rows"] == n_groups * S * 8
                  * cfg.coarse_topb * cfg.coarse_block
                  and counts["coarse_scan_bytes"] == n_groups * S
                  * a.n_coarse * D * 4, f"{label}: counts {counts}")
        else:
            check(mgr.io_stats["two_stage_groups"] == 0
                  and launches[run] == n_groups
                  and counts["two_stage_scans"] == 0,
                  f"{label}: coarse=False is flat: {counts}")
        runs[run] = dict(seconds=qtimes, timings={
            g: {k: res[0].timings[k] for k in ("similarity",
                                                "sample_expand")}
            for g, res in results.items()})
    for run, r in runs.items():
        split = {g: (round(v["similarity"], 6), round(v["sample_expand"], 6))
                 for g, v in r["timings"].items()}
        print(f"  {label} {run}: fused launches {launches[run]}  seconds "
              f"{ {k: round(v, 6) for k, v in r['seconds'].items()} }  "
              f"similarity, sample_expand (s) {split}", flush=True)
    return runs, launches


def phase_tier(embedder, card):
    """The hierarchical tier through the entry points at d = 768: 16
    streams of 224² worlds of 16 scenes into a consolidating manager with
    the reference's ``TIER_CFG`` geometry (capacity 128, coarse_block 16,
    coarse_capacity 32, top-B 4) and the main phase's MEM embedder, then
    the main phase's four query groups (``tier_query_runs``). Every #1
    launch of one more round is held to the plain version at the shapes
    the tier gives it, and the manager's state to a CPU twin
    (``check_twin``: equal frame ids through the two-stage path)."""
    from repro_torch.core.session import VenusConfig
    cfg = VenusConfig(memory_capacity=128, eviction="consolidate",
                      coarse_capacity=32, coarse_block=16, coarse_topb=4)
    t0 = time.perf_counter()
    worlds = make_worlds(S, 224, n_scenes=TIER_SCENES, seed0=100)
    t_worlds = time.perf_counter() - t0
    embedder.seconds, embedder.frames = 0.0, 0
    mgr, ticks, stages = ingest_streams(worlds, cfg, embedder, D, "cuda")
    consolidated = [mgr[s].memory.io_stats["consolidated_rows"]
                    for s in range(S)]
    check(all(c > 0 for c in consolidated),
          f"tier: every session consolidates: {consolidated}")
    check(mgr.arena.has_consolidated(), "tier: the arena holds history")
    rows = [mgr[s].memory.size for s in range(S)]
    n_emb = sum(mgr[s].stats["frames_embedded"] for s in range(S))
    frames = sum(w.total_frames for w in worlds)
    insert_s = stages["embed_insert"] - stages["embed_ticks_s"]
    print(f"phase tier: ingest  {S} streams of {TIER_SCENES} scenes, "
          f"{frames} frames (worlds {t_worlds:.2f} s)  ingest ticks (s) "
          f"{[round(x, 4) for x in ticks]}  by stage (s) "
          f"{ {k: round(stages[k], 4) for k in STAGES} }"
          f"  MEM {embedder.seconds:.3f} s for {n_emb} frames, insert and "
          f"consolidate {insert_s:.3f} s  consolidated rows "
          f"{consolidated}  [{card}]", flush=True)
    runs, launches = tier_query_runs(mgr, "tier")
    held = hold_tier_launches(mgr, "tier")
    twin = check_twin(mgr, cfg, "tier", D)
    check(twin["two_stage_groups"] == 3, f"tier twin: {twin}")
    out = dict(worlds_s=t_worlds, frames=frames, ticks=ticks,
               stages={k: stages[k] for k in STAGES},
               embed_s=embedder.seconds, embedded=n_emb,
               insert_s=insert_s, consolidated_rows=consolidated,
               rows=rows, launches=launches["two_stage"], runs=runs,
               held=held, twin_two_stage_groups=twin["two_stage_groups"])
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase tier: ok  {held['held']} #1 launches held to the plain "
          f"version at {held['shapes']} (max abs err "
          f"{held['max_abs_err']:.3e}); CPU twin: equal frame ids over "
          f"{twin['two_stage_groups']} two-stage groups; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    del mgr, worlds
    return out


# rows past the capacity, rows a scene, rows a session a tick
TIER_EXTRA, TIER_SCENE_ROWS, TIER_TICK = 512, 2, 512


def tier_rows_np(sid: int, n_rows: int, dim: int):
    """A session's index rows: scenes of ``TIER_SCENE_ROWS`` rows around a
    random unit centroid (cosine ≈ 0.8 between two rows of a scene, the
    merge threshold), unit length."""
    import numpy as np
    rng = np.random.default_rng(1000 + sid)
    c = rng.standard_normal((-(-n_rows // TIER_SCENE_ROWS), dim))
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    x = (np.repeat(c, TIER_SCENE_ROWS, 0)[:n_rows] + 0.5
         * rng.standard_normal((n_rows, dim)) / np.sqrt(dim))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def phase_tier_full(card):
    """The two-stage query path at the production geometry the fused
    phase's stage cases hold #1 at: ``VenusConfig(memory_capacity=8192,
    eviction="consolidate", coarse_capacity=256, coarse_block=64,
    coarse_topb=4)``, 16 sessions at d = 768, each filled by
    ``insert_batch`` (ticks of 512 rows into the arena's deferred appends)
    with 8192 + 512 rows, so 512 rows a session consolidate. Then the
    akr, sampling and topk groups through ``tier_query_runs``, one more
    round's #1 launches held to the plain version, and a CPU twin."""
    import numpy as np
    import torch
    from repro_torch.core.session import SessionManager, VenusConfig
    cfg = VenusConfig(memory_capacity=N, eviction="consolidate",
                      coarse_capacity=TIER_NC - TIER_NB,
                      coarse_block=TIER_BLOCK, coarse_topb=TIER_B)
    t_phase = time.perf_counter()
    mgr = SessionManager(cfg, None, D, device="cuda")
    for sid in range(S):
        mgr.create_session(sid)
    n_rows = N + TIER_EXTRA
    data = [tier_rows_np(sid, n_rows, D) for sid in range(S)]
    t0 = time.perf_counter()
    for lo in range(0, n_rows, TIER_TICK):
        r = np.arange(lo, min(lo + TIER_TICK, n_rows))
        with mgr.arena.deferred_appends():
            for sid in range(S):
                mgr[sid].memory.insert_batch(
                    data[sid][r], scene_ids=list(r // TIER_SCENE_ROWS),
                    index_frames=4 * r + 1,
                    member_lists=[range(4 * i, 4 * i + 4) for i in r])
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    for sid in range(S):
        mgr[sid].stats["frames_seen"] = 4 * n_rows
    mems = [mgr[s].memory for s in range(S)]
    consolidated = [m.io_stats["consolidated_rows"] for m in mems]
    csize = [m._coarse_csize for m in mems]
    check(all(c == TIER_EXTRA for c in consolidated)
          and all(m.size == N for m in mems),
          f"tier_8192: {consolidated} consolidated")
    print(f"phase tier_8192: ingest  {S} x {n_rows} rows by insert_batch in "
          f"{insert_s:.3f} s (host; {S * TIER_EXTRA} consolidated), "
          f"consolidated rows a session {min(csize)}-{max(csize)} of "
          f"{cfg.coarse_capacity}  [{card}]", flush=True)
    runs, launches = tier_query_runs(mgr, "tier_8192", text=False)
    held = hold_tier_launches(mgr, "tier_8192", text=False)
    twin = check_twin(mgr, cfg, "tier_8192", D)
    check(twin["two_stage_groups"] == 3, f"tier_8192 twin: {twin}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase tier_8192: ok  {held['held']} #1 launches held to the "
          f"plain version at {held['shapes']} (max abs err "
          f"{held['max_abs_err']:.3e}); CPU twin: equal frame ids over 3 "
          f"two-stage groups; phase {phase_s:.1f} s", flush=True)
    del mgr, data
    return dict(insert_s=insert_s, consolidated_rows=consolidated,
                coarse_rows=csize, runs=runs, phase_s=phase_s,
                launches=launches["two_stage"], held=held)


# the standing phase's host window (frames a session keeps on the host);
# the edge slabs: (rows a session a tick, sessions a tick), n_pad 1, 2, 4, 4
STANDING_RETAIN = 128
EDGE_TICKS = ((1, 1), (2, 16), (3, 5), (4, 16))


def capture_standing(mgr):
    """Record each standing launch (``ops.fused_retrieve_stack`` with
    ``tier="standing"``: operands, result, the registry's tick) and each
    evaluation's new rows by session (``mgr.standing.evaluate``) until
    ``undo()`` → (launches, evaluations, undo)."""
    import numpy as np
    from repro_torch.kernels import ops
    orig, evaluate = ops.fused_retrieve_stack, mgr.standing.evaluate
    launches, evals = [], []

    def capture(query, index, *, tau, valid, targets, n_topk, tier="fine",
                **mesh):
        fr = orig(query, index, tau=tau, valid=valid, targets=targets,
                  n_topk=n_topk, tier=tier, **mesh)
        if tier == "standing":
            launches.append(dict(query=query, index=index, valid=valid,
                                 targets=targets, k=n_topk, tau=tau, fr=fr,
                                 tick=mgr.standing.tick))
        return fr

    def logged(sessions, new_by_sid, io_stats=None):
        rows = {sid: np.concatenate([np.asarray(p, np.int64) for p in ps])
                for sid, ps in new_by_sid.items()}
        live = sorted(s for s, p in rows.items()
                      if len(p) and mgr.standing.by_sid.get(s))
        evals.append(dict(tick=mgr.standing.tick + 1, rows=rows, live=live))
        return evaluate(sessions, new_by_sid, io_stats)

    ops.fused_retrieve_stack = capture
    mgr.standing.evaluate = logged

    def undo():
        ops.fused_retrieve_stack = orig
        del mgr.standing.evaluate
    return launches, evals, undo


def adhoc_topk(rows, ifr, emb, budget: int, index_dtype: str, dev="cuda"):
    """An ad-hoc ``topk`` plan over exactly ``rows`` (index frames
    ``ifr``) in a fresh manager on ``dev`` → (frame ids, its launch's
    top-K scores and lanes of the one query)."""
    import numpy as np
    from repro_torch.core.queryplan import QuerySpec
    from repro_torch.core.session import SessionManager, VenusConfig
    from repro_torch.kernels import ops
    mgr = SessionManager(VenusConfig(memory_capacity=128,
                                     index_dtype=index_dtype), None,
                         rows.shape[1], device=dev)
    sid = mgr.create_session()
    with mgr.arena.deferred_appends():
        mgr[sid].memory.insert_batch(
            rows, scene_ids=[0] * len(rows), index_frames=ifr,
            member_lists=[[int(f)] for f in ifr])
    orig, got = ops.fused_retrieve_stack, []

    def capture(*a, **kw):
        got.append(orig(*a, **kw))
        return got[-1]
    ops.fused_retrieve_stack = capture
    try:
        res = mgr.query_specs([QuerySpec(sid=sid, embedding=emb,
                                         strategy="topk", budget=budget)])
    finally:
        ops.fused_retrieve_stack = orig
    fr = got[0]
    return (np.asarray(res[0].frame_ids), fr.topk_v[0, 0].cpu(),
            fr.topk_i[0, 0].cpu())


def hold_standing(mgr, launches, evals, label, dev="cuda"):
    """One standing launch a committing evaluation (a session with specs
    got rows), each slab (G, pow2(max n), d) over the live sessions in sid
    order; each launch held to the plain version on its operands
    (``hold_fused``, no draws; top-K lanes may trade places only between
    rows the plain version scores within the float tolerance, each swap
    counted); and the determinism contract: every live spec's top-K
    scores in the launch are bit for bit, and its frame ids equal, those
    of an ad-hoc ``topk`` plan over the same rows on the card. Returns
    the shapes held, the max abs error, the lanes held to ad-hoc plans
    and the tied swaps."""
    import torch
    from repro_torch.core.standing import _pow2
    live = [e for e in evals if e["live"]]
    check(len(launches) == len(live),
          f"{label}: {len(launches)} standing launches for {len(live)} "
          f"committing evaluations")
    err, shapes, lanes, swaps = 0.0, set(), 0, []
    for j, (ln, ev) in enumerate(zip(launches, live)):
        check(ln["tick"] == ev["tick"], f"{label}: launch {j} tick")
        n = max(len(ev["rows"][s]) for s in ev["live"])
        x = ln["index"]
        check(tuple(x.shape) == (len(ev["live"]), _pow2(n), x.shape[2]),
              f"{label}: launch {j} slab {tuple(x.shape)}")
        shape = (tuple(x.shape), str(x.dtype).removeprefix("torch."),
                 ln["query"].shape[1], ln["k"])
        e, _, _ = hold_fused(f"{label} standing launch {j} {shape}",
                             ln["query"], x, ln["valid"], ln["targets"],
                             ln["k"], draws=False, tau=ln["tau"],
                             ties=swaps)
        err = max(err, e)
        shapes.add(shape)
        tv, ti = ln["fr"].topk_v.cpu(), ln["fr"].topk_i.cpu()
        for gi, sid in enumerate(ev["live"]):
            mem, p = mgr[sid].memory, ev["rows"][sid]
            for qi, spec_id in enumerate(mgr.standing.by_sid[sid]):
                ent = mgr.standing.entries[spec_id]
                kk = min(ent.budget, ln["k"], len(p))
                ids, a_v, a_i = adhoc_topk(mem._emb[p], mem._index_frame[p],
                                           ent.embedding, ent.budget,
                                           mgr.cfg.index_dtype, dev)
                check(torch.equal(tv[gi, qi, :kk], a_v[:kk])
                      and torch.equal(ti[gi, qi, :kk], a_i[:kk]),
                      f"{label}: launch {j} session {sid} spec {spec_id}: "
                      f"standing {tv[gi, qi, :kk].tolist()} "
                      f"{ti[gi, qi, :kk].tolist()} vs ad-hoc "
                      f"{a_v[:kk].tolist()} {a_i[:kk].tolist()}")
                check(mem._index_frame[p][ti[gi, qi, :kk].numpy()].tolist()
                      == ids[:kk].tolist(),
                      f"{label}: launch {j} spec {spec_id} frame ids")
                lanes += 1
    return sorted(shapes), err, lanes, swaps


def phase_standing_edges(card, dev="cuda"):
    """The slab shapes the ingest seldom gives #1, at d = 768, f32 and
    int8 (the int8 rows on the tensor cores): a manager of 16 sessions
    fed by ``insert_batch``, each session with a ``topk`` spec of budget 1
    and session 0 one more of budget 2, evaluated tick by tick over
    ``EDGE_TICKS``: N = pow2(n) of 1, 2, 4 and 4 rows, G = 1, 16, 5 and 16
    sessions, Q = 1 (staged in a tile of 8) or 2, K = 1 or 2. Every launch
    held to the plain version and to ad-hoc plans (``hold_standing``);
    for int8, ``quantise_rows`` of the host mirrors is the arena's int8
    rows on the card."""
    import numpy as np
    from repro_torch.core.memory import quantise_rows
    from repro_torch.core.queryplan import QuerySpec
    from repro_torch.core.session import SessionManager, VenusConfig
    out = {}
    for dtype in ("float32", "int8"):
        mgr = SessionManager(VenusConfig(memory_capacity=64,
                                         index_dtype=dtype), None, D,
                             device=dev)
        embs = unit_queries_np(S + 1, D, 11)
        for sid in range(S):
            mgr.create_session(sid)
            mgr.register_standing(sid, QuerySpec(
                sid=sid, embedding=embs[sid], strategy="topk", budget=1),
                threshold=-1.0)
        mgr.register_standing(0, QuerySpec(sid=0, embedding=embs[S],
                                           strategy="topk", budget=2),
                              threshold=-1.0)
        launches, evals, undo = capture_standing(mgr)
        rng = np.random.default_rng(12)
        fid = 0
        try:
            for n, g in EDGE_TICKS:
                new = {}
                with mgr.arena.deferred_appends():
                    for sid in range(S - g, S):
                        rows = rng.standard_normal((n, D)).astype(np.float32)
                        rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
                        ids = np.arange(fid, fid + n)
                        fid += n
                        new[sid] = [mgr[sid].memory.insert_batch(
                            rows, scene_ids=[0] * n, index_frames=ids,
                            member_lists=[[int(f)] for f in ids])]
                mgr.standing.evaluate(mgr.sessions, new, mgr.io_stats)
        finally:
            undo()
        shapes, err, lanes, swaps = hold_standing(
            mgr, launches, evals, f"standing edges {dtype}", dev)
        check(len(launches) == len(EDGE_TICKS),
              f"standing edges {dtype}: {len(launches)} launches")
        if dtype == "int8":
            for sid in range(S):
                mem = mgr[sid].memory
                p = np.arange(mem.size)
                q = quantise_rows(mem._emb[p])[0]
                check(np.array_equal(
                    q, mgr.arena.emb[mem.slot, :mem.size].cpu().numpy()),
                    f"standing edges: session {sid}: quantise_rows of the "
                    f"mirrors is not the arena's int8 rows")
        out[dtype] = dict(shapes=shapes, max_abs_err=err, lanes=lanes,
                          tied_swaps=swaps)
        print(f"phase standing[edges {dtype}]: ok  {len(launches)} launches "
              f"held to the plain version at {shapes} (max abs err "
              f"{err:.3e}; tied top-K swaps {swaps}); {lanes} spec lanes "
              f"bit-equal to ad-hoc top-k"
              f"{'; quantise_rows(mirrors) == arena int8 rows' if dtype == 'int8' else ''}"
              f"  [{card}]", flush=True)
        del mgr
    return out


def phase_standing(embedder, worlds, first_pass, card, dev="cuda"):
    """Standing queries and the spill tier through the entry points: the
    main phase's MEM embedder and 16 worlds into ``VenusConfig(spill_dir=
    <a new temporary directory>, host_retain=128)`` (capacity 8192, f32).
    Before the ingest every session registers a text ``topk`` spec
    (through the MEM text tower; threshold 0.999) and an embedding spec
    set to one of its index rows from the main phase (threshold 0.99,
    hysteresis 0.05, cooldown 2, priority 1), which must fire. The ingest
    (ticks of 64 frames, the flush) runs under the profiler: one #1
    launch a committing tick, ``standing_scan_bytes`` the slabs' bytes,
    no restack; every launch held to the plain version and to ad-hoc
    ``topk`` plans (``hold_standing``). Then the spill tier: frames
    demoted, every host window within ``host_retain``; a ``uniform``
    group over the 16 sessions and every alert's frame ids read back
    equal to the worlds' frames; ``close_session`` of every stream leaves
    ``spill_disk_bytes`` 0 and no directory. Then the edge slabs
    (``phase_standing_edges``)."""
    import contextlib
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.queryplan import QuerySpec
    from repro_torch.core.session import SessionManager, VenusConfig
    from repro_torch.core.standing import STAGES
    from repro_torch.kernels import ops
    from repro_torch.serving import VenusService
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="venus-spill-")
    fstype = subprocess.run(["stat", "-f", "-c", "%T", root],
                            capture_output=True, text=True).stdout.strip()
    mgr = SessionManager(VenusConfig(spill_dir=root,
                                     host_retain=STANDING_RETAIN),
                         embedder, embed_dim=D, device=dev)
    svc = VenusService(mgr, None)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    text_specs, emb_specs = [], []
    for sid in range(S):
        mgr.create_session(sid)
        text_specs.append(mgr.register_standing(sid, QuerySpec(
            sid=sid, text=f"someone opens the door on camera {sid}",
            strategy="topk", budget=4), threshold=0.999))
        emb_specs.append(mgr.register_standing(sid, QuerySpec(
            sid=sid, embedding=first_pass[sid], strategy="topk", budget=4),
            threshold=0.99, hysteresis=0.05, cooldown_ticks=2,
            priority=1.0))
    launches, evals, undo = capture_standing(mgr)
    trim, trim_s = mgr._trim_archives, []

    def timed_trim(sids):
        t0 = time.perf_counter()
        n = trim(sids)
        trim_s.append(time.perf_counter() - t0)
        return n
    mgr._trim_archives = timed_trim
    ops.reset_kernel_launches()
    ops.reset_scan_counts()
    ticks, eval_ms = [], []
    try:
        with (profile(activities=[ProfilerActivity.CUDA]) if dev == "cuda"
              else contextlib.nullcontext()) as prof:
            longest = max(w.total_frames for w in worlds)
            for i in list(range(0, longest, 64)) + [None]:
                before = dict(mgr.standing.seconds)
                sync()
                t0 = time.perf_counter()
                if i is None:
                    mgr.flush()
                else:
                    mgr.ingest_tick({sid: w.frames[i:i + 64]
                                     for sid, w in enumerate(worlds)
                                     if i < w.total_frames})
                sync()
                ticks.append(time.perf_counter() - t0)
                eval_ms.append({k: 1e3 * (mgr.standing.seconds[k]
                                          - before[k]) for k in STAGES})
    finally:
        undo()
        del mgr._trim_archives
    n_fused = ops.kernel_launches()["fused_retrieve"]
    counts = ops.scan_counts()
    trace = prof and kernel_in_trace(prof, n_fused, ("k_scores<", "k_finish"),
                                     "standing ingest")
    check(n_fused == len(launches) > 0,
          f"standing: #1 launched {n_fused} times, {len(launches)} "
          f"standing launches")
    check(counts["standing_scan_bytes"] == sum(
        ln["index"].numel() * 4 for ln in launches) > 0,
          f"standing: standing_scan_bytes {counts}")
    check(mgr.io_stats["stack_rebuilds"] == 0, "standing: stack_rebuilds")
    shapes, err, lanes, swaps = hold_standing(mgr, launches, evals,
                                              "standing", dev)
    bounds = []
    for ln in launches:
        g, q, d = ln["query"].shape
        rows = int(ln["valid"].sum())
        small = 4 * (g * q * d + g + g * q + g * q * (2 * ln["k"] + 4))
        b, bound_by = bound_ms(rows * d * 4 + small,
                               (2.0 * q + 3.0) * rows * d)
        bounds.append(1e3 * b)
    bound_us = sum(bounds) / len(bounds)
    alerts = mgr.poll_alerts()
    fired = {a.spec_id for a in alerts}
    check(set(emb_specs) <= fired, f"standing: embedding specs fired "
          f"{sorted(fired & set(emb_specs))} of {emb_specs}")
    never = set(text_specs + emb_specs) - fired
    check(len(never) > 0, "standing: every spec fired")
    check(mgr.io_stats["alerts_fired"] == len(alerts),
          f"standing: {mgr.io_stats['alerts_fired']} fired, "
          f"{len(alerts)} polled")
    text_best = max((float(ln["fr"].topk_v[gi, 0, 0]) for ln, ev in zip(
        launches, [e for e in evals if e["live"]])
        for gi, _ in enumerate(ev["live"])), default=float("nan"))
    for a in alerts:
        got = mgr[a.sid].frames.get(a.frame_ids)
        check(np.array_equal(got, worlds[a.sid].frames[a.frame_ids]),
              f"standing: alert {a.spec_id} frames read back differ")
    # the spill tier
    stores = [mgr[s].frames for s in range(S)]
    spilled = sum(f.io_stats["spilled_frames"] for f in stores)
    demoted = sum(f.io_stats["spilled_bytes"] for f in stores)
    check(spilled > 0 and all(f.retained <= STANDING_RETAIN
                              for f in stores),
          f"standing: spilled {spilled}, retained "
          f"{[f.retained for f in stores]}")
    qe = unit_queries_np(S, D, 17)
    t0 = time.perf_counter()
    res = mgr.query_specs([QuerySpec(sid=s, embedding=qe[s],
                                     strategy="uniform", budget=16)
                           for s in range(S)])
    t_uniform = time.perf_counter() - t0
    from_disk = 0
    for s, r in enumerate(res):
        f = r.frame_ids
        check(len(f) > 0, f"standing: uniform on session {s} empty")
        check(np.array_equal(mgr[s].frames.get(f), worlds[s].frames[f]),
              f"standing: uniform frames of session {s} differ")
        from_disk += int((f < stores[s].base).sum())
    check(from_disk > 0, "standing: no uniform draw read from disk")
    io = svc.io_stats()
    faults, hits = io["spill_faults"], io["spill_cache_hits"]
    disk_before = io["spill_disk_bytes"]
    for sid in range(S):
        mgr.close_session(sid)
    io = svc.io_stats()
    check(io["spill_disk_bytes"] == 0 and not os.listdir(root)
          and io["spilled_frames"] == spilled,
          f"standing: after the closes {io['spill_disk_bytes']} bytes, "
          f"{os.listdir(root)}")
    os.rmdir(root)
    check(not os.path.exists(root), "standing: spill directory remains")
    ev_ms = {k: sum(t[k] for t in eval_ms) / len(eval_ms) for k in STAGES}
    ev_tick = [sum(t.values()) for t in eval_ms]
    print(f"phase standing: ingest  {len(ticks)} ticks (s) "
          f"{[round(x, 4) for x in ticks]}; {len(launches)} standing "
          f"launches at {shapes}; #1 {trace['device_us_per_launch']:.2f} "
          f"device us a launch (profiler, {trace['launches']} launches; "
          f"mean bound {bound_us:.3f} us a launch, {bound_by})"
          if trace else "phase standing: ingest (empty trace)", flush=True)
    print(f"  standing evaluation, host ms a tick {[round(x, 3) for x in ev_tick]}"
          f" (mean by stage {({k: round(v, 3) for k, v in ev_ms.items()})});"
          f" alerts {len(alerts)} ({len(fired)} specs fired, {len(never)} "
          f"never; best text-spec score {text_best:.4f}); standing_scan_bytes"
          f" {counts['standing_scan_bytes']}  [{card}]", flush=True)
    print(f"  spill: {spilled} frames / {demoted} bytes demoted to {fstype} "
          f"({disk_before} bytes on disk before the closes); _trim_archives"
          f" s a tick {[round(x, 4) for x in trim_s]}; uniform group "
          f"{t_uniform:.4f} s, {from_disk} draws from disk; spill_faults "
          f"{faults}, spill_cache_hits {hits}  [{card}]", flush=True)
    edges = phase_standing_edges(card, dev)
    phase_s = time.perf_counter() - t_phase
    print(f"phase standing: ok  {len(launches)} launches held to the plain "
          f"version (max abs err {err:.3e}; {len(swaps)} top-K lanes "
          f"swapped between rows tied within the tolerance: "
          f"{swaps}), {lanes} spec lanes bit-equal "
          f"to ad-hoc top-k; spill checks passed; phase {phase_s:.1f} s",
          flush=True)
    del mgr, svc
    return dict(ticks=ticks, eval_ms=eval_ms, trim_s=trim_s, shapes=shapes,
                launches=len(launches), max_abs_err=err, lanes=lanes,
                tied_swaps=swaps,
                bound_us=bound_us, bound_by=bound_by,
                trace=trace, alerts=len(alerts), specs_fired=len(fired),
                specs_never=len(never), text_best=text_best,
                standing_scan_bytes=counts["standing_scan_bytes"],
                spilled_frames=spilled, spilled_bytes=demoted,
                disk_bytes=disk_before, fstype=fstype, spill_faults=faults,
                spill_cache_hits=hits, uniform_s=t_uniform,
                uniform_from_disk=from_disk, edges=edges, phase_s=phase_s)


def card_state(mgr, sids):
    """A card manager's state as ``arena_from_numpy``'s arguments: the
    arena's arrays, each session's PRNG key and, with a coarse tier, its
    buffers and the memories' consolidated rows."""
    import numpy as np
    a = mgr.arena
    mems = [mgr[s].memory for s in sids]
    out = dict(emb=a.emb.cpu().numpy(), members=a.members.cpu().numpy(),
               member_count=a.member_count.cpu().numpy(),
               index_frame=a.index_frame.cpu().numpy(), sizes=a.sizes.copy(),
               heads=a.heads.copy(),
               keys=np.stack([np.array(mgr[s].key) for s in sids]))
    if a.n_coarse:
        out["coarse"] = dict(
            emb=a.coarse_emb.cpu().numpy(),
            members=a.coarse_members.cpu().numpy(),
            member_count=a.coarse_member_count.cpu().numpy(),
            index_frame=a.coarse_index_frame.cpu().numpy(),
            valid=a.coarse_valid.copy(),
            weight=np.stack([m._coarse_weight for m in mems]),
            fid_lo=np.stack([m._coarse_fid_lo for m in mems]),
            fid_hi=np.stack([m._coarse_fid_hi for m in mems]),
            csize=np.asarray([m._coarse_csize for m in mems]))
    return out


def check_twin(card_mgr, cfg, label, dim):
    """Card and CPU answer alike over the same memory: the card manager's
    state into a CPU twin (``arena_from_numpy``), then akr, sampling and
    topk queries through both; frame ids and n_drawn equal. Returns the
    card's io_stats of the queries."""
    from repro_torch.core.convert import arena_from_numpy
    sids = sorted(card_mgr.sessions)
    twin = arena_from_numpy(cfg, None, device="cpu",
                            **card_state(card_mgr, sids))
    card_mgr.reset_io_stats(include_memories=False)
    on_card, _ = run_queries(card_mgr, len(sids), dim, text=False)
    on_cpu, _ = run_queries(twin, len(sids), dim, text=False)
    for strat in on_card:
        for x, y in zip(on_card[strat], on_cpu[strat]):
            check(x.frame_ids.tolist() == y.frame_ids.tolist()
                  and x.n_drawn == y.n_drawn,
                  f"parity {label} {strat}: card {x.frame_ids} vs cpu "
                  f"{y.frame_ids}")
    check(card_mgr.io_stats["two_stage_groups"]
          == twin.io_stats["two_stage_groups"],
          f"parity {label}: two-stage groups card {card_mgr.io_stats} vs "
          f"cpu {twin.io_stats}")
    return dict(card_mgr.io_stats)


def phase_parity():
    """The same small input through the card and through the plain
    versions on the CPU. Ingest: identical partitions, clusters and
    reservoirs; index frames identical except where a two-member
    cluster's members are equidistant from its centroid (an exact tie
    that rounding breaks, differently on each device); embeddings of the
    same frame allclose. Query: both routes over the card's memory give
    identical frame ids. Then the tier: one world streamed by two
    sessions (the second a tick behind) on the card, embedded by MEM at
    smoke width (f32) with OCR and detector prompts from the world's
    annotations, into a consolidating manager and a ``cluster_merge``
    one of capacity 8; each one's state into a CPU twin, and identical
    frame ids for akr, sampling and topk, through the two-stage path
    where the tier holds history."""
    import numpy as np
    import torch
    from repro_torch.configs.venus_mem import smoke_config
    from repro_torch.core.aux_models import DetectorStub, OCRStub
    from repro_torch.core.convert import arena_from_numpy
    from repro_torch.core.pipeline import MEMEmbedder
    from repro_torch.core.session import SessionManager, VenusConfig
    from repro_torch.data.video import PixelEmbedder
    from repro_torch.kernels import prng
    from repro_torch.models.mem import MEM
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
    # the tier and cluster_merge, with the aux models' prompts
    world = small[0]
    mem = MEM.init(_mem_with_dtype(smoke_config(), "float32"), seed=2,
                   device="cuda")
    tier = {}
    for label, tcfg in (
            ("consolidate", VenusConfig(memory_capacity=8,
                                        eviction="consolidate",
                                        coarse_capacity=8, coarse_block=4,
                                        coarse_topb=2)),
            ("cluster_merge", VenusConfig(memory_capacity=8,
                                          eviction="cluster_merge"))):
        mgr = SessionManager(tcfg, MEMEmbedder(mem), 64,
                             aux_models=[OCRStub(), DetectorStub()],
                             annotation_fn=world.annotations, device="cuda")
        for sid in (0, 1):
            mgr.create_session(sid)
        for tick in range(world.total_frames // 64 + 2):
            mgr.ingest_tick({sid: world.frames[64 * (tick - sid):
                                               64 * (tick - sid + 1)]
                             for sid in (0, 1)
                             if 0 <= 64 * (tick - sid) < world.total_frames})
        mgr.flush()
        mems = [mgr[s].memory for s in (0, 1)]
        prompts = sum(bool(world.annotations(int(f))["text"])
                      for m in mems for f in m._index_frame[:m.size])
        check(prompts > 0, f"parity {label}: no index frame has a prompt")
        evicted = [m.io_stats["evicted_rows"] for m in mems]
        check(all(e > 0 for e in evicted), f"parity {label}: evictions")
        stats = check_twin(mgr, tcfg, label, 64)
        if label == "consolidate":
            check(all(m.io_stats["consolidated_rows"] > 0 for m in mems)
                  and stats["two_stage_groups"] == 3,
                  f"parity {label}: two-stage groups {stats}")
        tier[label] = dict(evicted=evicted, prompts=prompts,
                           two_stage_groups=stats["two_stage_groups"],
                           merges=[m.io_stats["reservoir_merges"]
                                   for m in mems])
    print(f"phase parity: ok  ingest equal ({ties} two-member index-frame "
          f"ties broken differently)  card == cpu frame ids for akr, "
          f"sampling, topk; tier (MEM smoke f32, OCR + detector prompts) "
          f"{tier}: card == cpu twin frame ids", flush=True)
    return tier


def check_results(mgr, n_sessions, results, label):
    for strat, res in results.items():
        check(len(res) == 8 * n_sessions, f"{label}: {strat} result count")
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
    check_results(mgr, len(worlds), results, "dense")
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
            # the zoo's other widths at G = 1: Zamba2-2.7B's shared block
            # (32 heads of 80) and Whisper-base's decoder (8 heads of 64)
            ("bf16_d80", 32, 32, 80, 0.0, bf, valid, split),
            ("bf16_d64", 8, 8, 64, 0.0, bf, valid, split),
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
    # the partials of a sequence shard (``partials=True``, no merge) on
    # both routes: the mask with holes (sequence 2 with no valid row: the
    # empty part), against the plain version's, each reduced to one part
    shard = holes
    for name, dt, route in (("bf16", torch.bfloat16, split),
                            ("f32", torch.float32, part)):
        c = shard.shape[-1]
        q = torch.randn((b, 1, 28, 128), generator=gen, device=dev).to(dt)
        k = torch.randn((b, c, 4, 128), generator=gen, device=dev).to(dt)
        v = torch.randn((b, c, 4, 128), generator=gen, device=dev).to(dt)
        kw = dict(scale=128 ** -0.5, q_per_kv=7)
        before = dict(dk.gqa_decode.route_launches)
        got = dk.gqa_decode(q, k, v, shard, partials=True, **kw)
        torch.cuda.synchronize()
        ran = [r for r, n in dk.gqa_decode.route_launches.items()
               if n != before[r]]
        check(ran == [route], f"gqa partials {name}: ran {ran}, not "
              f"{route}")
        err = hold_parts(got, ref.decode_partials_ref(q, k, v, shard, **kw),
                         v, f"gqa partials {name}")
        out[f"gqa_partials_{name}"] = dict(max_abs_err=err, route=route)
        print(f"phase decode[gqa partials {name}]: ok  {route}  "
              f"{got[0].shape[-1]} parts a head, one sequence empty  "
              f"max_abs_err {err:.3e}", flush=True)
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
    out.update(mla_partials_cases(gen, holes))
    return out


def mla_partials_cases(gen, holes):
    """#6's partials of a sequence shard (``partials=True``, no merge) on
    both routes (bf16 on ``k_mla``, f32 on ``k_partial``) at MiniCPM3-4B's
    (H=40, R=256, Dr=32) and DeepSeek-V2-Lite's (H=16, R=512, Dr=64)
    widths: the mask with holes (sequence 2 with no valid row: the empty
    part) held, reduced to one part, to the plain version's; then a shard
    with no valid row whose ckv and krope are NaN, which must give the
    empty part exactly (a launch that read a row would carry its NaN).
    Then the bf16 partials of four shards of the holes mask, merged by
    ``merge_partials`` (``k_merge`` alone, Dv = R = 256 and 512), held to
    the plain merge of the same parts and, where a sequence has a valid
    row, to the unsharded plain version."""
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    dev = holes.device
    b, c = holes.shape
    none = torch.zeros_like(holes)
    out = {}
    for wname, h, r, dr, nope in (("minicpm3", 40, 256, 32, 64),
                                  ("dsv2", 16, 512, 64, 128)):
        scale = (nope + dr) ** -0.5
        for dname, dt, route in (("bf16", torch.bfloat16, "k_mla"),
                                 ("f32", torch.float32, "k_partial")):
            qa, qr, ckv, kr = (torch.randn(sh, generator=gen, device=dev)
                               .to(dt) for sh in ((b, 1, h, r), (b, 1, h, dr),
                                                  (b, c, r), (b, c, dr)))
            what = f"mla partials {wname} {dname}"
            before = dict(dk.mla_decode.route_launches)
            got = dk.mla_decode(qa, qr, ckv, kr, holes, scale=scale,
                                partials=True)
            nan = [torch.full_like(x, float("nan")) for x in (ckv, kr)]
            empty = dk.mla_decode(qa, qr, *nan, none, scale=scale,
                                  partials=True)
            torch.cuda.synchronize()
            ran = {k: n - before[k]
                   for k, n in dk.mla_decode.route_launches.items()
                   if n != before[k]}
            check(ran == {route: 2}, f"{what}: ran {ran}, not {route}")
            err = hold_parts(got, ref.mla_decode_partials_ref(
                qa, qr, ckv, kr, holes, scale=scale), ckv, what)
            m, l, acc = empty
            check(bool((m == -1e30).all() and (l == 0).all()
                       and (acc == 0).all()),
                  f"{what}: a shard with no valid row is not the empty "
                  f"part (its NaN rows were read)")
            row = dict(max_abs_err=err, route=route, parts=got[0].shape[-1])
            if dt == torch.bfloat16:
                n = c // 4
                parts = [dk.mla_decode(qa, qr, ckv[:, i:i + n],
                                       kr[:, i:i + n], holes[:, i:i + n],
                                       scale=scale, partials=True)
                         for i in range(0, c, n)]
                pm, pl, pa = (torch.cat([x[i] for x in parts], dim=2)
                              for i in range(3))
                merged = dk.merge_partials(pm, pl, pa, dt)
                want = ref.merge_partials_ref(pm, pl, pa, dt)
                torch.testing.assert_close(
                    merged.float(), want.float(), **BF16_TOL,
                    msg=lambda e: f"{what} merge: {e}")
                whole = ref.mla_decode_attention_ref(qa, qr, ckv, kr, holes,
                                                     scale=scale)
                live = holes.any(1)
                torch.testing.assert_close(
                    merged[live].float(), whole[live].float(), **BF16_TOL,
                    msg=lambda e: f"{what} merge vs unsharded: {e}")
                check(bool((merged[~live] == 0).all()),
                      f"{what} merge: a sequence with no valid row is not 0")
                out[f"mla_merge_{wname}"] = dict(
                    max_abs_err=float((merged.float() - want.float())
                                      .abs().max()), dv=r, parts=pm.shape[-1])
            out[f"mla_partials_{wname}_{dname}"] = row
            print(f"phase decode[{what}]: ok  {route}  {row['parts']} parts "
                  f"a head, one sequence empty, an all-empty NaN shard "
                  f"exactly empty  max_abs_err {err:.3e}"
                  + (f"; merge of 4 shards (Dv = {r}, "
                     f"{out[f'mla_merge_{wname}']['parts']} parts) ok"
                     if dt == torch.bfloat16 else ""), flush=True)
            del qa, qr, ckv, kr, nan
    return out


def _clone_cache(cache):
    import torch
    return {k: (v.clone() if torch.is_tensor(v) else
                {n: t.clone() for n, t in v.items()})
            for k, v in cache.items()}


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
        return model.apply(tokens, cache=_clone_cache(engine.cache),
                           mode="decode")[0].float()

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


def decode_busy(engine, steps: int = 3, span=None):
    """Device busy share of decode steps from the engine's current cache:
    ``steps`` steps under ``torch.profiler``; the device time its kernels
    cover over the host-clock time, and the decode kernels' covered time
    and share of it, and the eight dearest kernels by name (launches and
    device us a step); with ``span``, the name of profiler ranges the
    steps open, also the device time its kernels cover inside those
    ranges' device-side intervals, a step (the intervals themselves,
    which the trace lists beside the kernels, are not kernels). A
    measurement only: a profiler that reports no device events gives
    None."""
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
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name != span]
    if not kern:
        return None
    busy = _covered_us(kern)
    ours = [e for e in kern if any(n in e.name for n in DECODE_KERNELS)]
    per = {}
    for e in ours:
        n = next(n for n in DECODE_KERNELS if n in e.name)
        per[n] = per.get(n, 0.0) + e.time_range.elapsed_us() / steps
    covered = _covered_us(ours)
    extra = {}
    if span is not None:
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and e.name == span)
        inside = [e for e in kern if any(
            a <= e.time_range.start and e.time_range.end <= b
            for a, b in ranges)]
        extra["span_device_ms_per_step"] = (
            _covered_us(inside) / steps / 1e3 if ranges else None)
        extra["span_intervals_per_step"] = len(ranges) / steps
    return dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_ms_per_step=busy / steps / 1e3,
                busy_share=busy / wall_us,
                decode_kernel_share=covered / busy,
                decode_kernel_us_per_step=covered / steps,
                decode_kernel_spans_us_per_step=per,
                kernels_per_step=len(kern) / steps,
                top_kernels=dict(list(_by_name(kern, steps).items())[:8]),
                **extra)


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


def serve_dryrun_line(cfg, held, card, slots=4, max_len=2048):
    """The dry run's argument bytes of the decode step of ``cfg`` at the
    engine's slots and ``max_len`` (its weights, its cache, a token a
    slot) against the ``held`` bytes that building the engine
    allocated; within 2 %."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import placement_bytes
    from repro_torch.launch.mesh import make_abstract_mesh
    arg = placement_bytes(cfg, ShapeSpec("decode_32k", max_len, slots,
                                         "decode"),
                          make_abstract_mesh((1, 1), ("data", "model")))[
                              "argument"]
    check(abs(held - arg) <= 0.02 * arg,
          f"serve: dry-run argument bytes {arg} vs {held} allocated")
    print(f"  serve dry run: {cfg.name} weights + cache ({slots} slots x "
          f"{max_len}) {arg:.0f} argument bytes vs {held} allocated by "
          f"the model and the engine ({100 * (held / arg - 1):+.3f} %)  "
          f"[{card}]", flush=True)
    return dict(argument_bytes=arg, allocated_bytes=held)


def serve_costmodel_line(akr, card):
    """``costmodel.venus_query_latency`` of the main phase's akr group:
    its first query's measured edge seconds (the group's ``timings``)
    and its frames, the upload and the cloud VLM modelled."""
    from repro_torch.core.costmodel import venus_query_latency
    results, group_s = akr
    res = results[0]
    lat = venus_query_latency(measured_edge_s=res.timings,
                              n_frames_uploaded=len(res.frame_ids))
    print(f"  serve cost model, main phase's akr group ({len(results)} "
          f"queries in {group_s:.6f} s on the host clock): first query "
          f"{lat}  [{card}]", flush=True)
    return dict(parts=lat.parts, total=lat.total, group_s=group_s)


def phase_serve(mgr, card, akr=None):
    """VenusService over the main manager, Qwen2-VL-7B at full width;
    ``akr``: the main phase's akr group (results, seconds) for the cost
    model's line."""
    import numpy as np
    import torch
    from repro_torch.configs.qwen2_vl_7b import config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import ServingEngine, StreamQuery, VenusService
    cfg = config().replace(param_dtype="bfloat16")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = ServingEngine(model, batch_slots=4, max_len=2048)
    torch.cuda.synchronize()
    dry = serve_dryrun_line(cfg, torch.cuda.memory_allocated() - base, card)
    cost = serve_costmodel_line(akr, card) if akr is not None else None
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
               argmax_agree=agree, dryrun=dry, costmodel=cost,
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


class RouteLog:
    """While active, records every ``models.moe.route`` call in call order
    (a model step routes its MoE layers in order). With ``pin``, a second
    run of the step keeps the first run's experts: call ``i`` past the
    first ``pin`` calls takes call ``i - pin``'s experts and kept pairs,
    its weights from its own probabilities at those experts."""

    def __init__(self, pin: int = 0):
        self.pin = pin

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._orig = [], moe.route

        def rec(p, cfg, x, n):
            r = self._orig(p, cfg, x, n)
            if self.pin and len(self.calls) >= self.pin:
                first = self.calls[len(self.calls) - self.pin]
                w = r.probs.gather(-1, first.top_i)
                r = r._replace(top_i=first.top_i, keep=first.keep,
                               top_w=w / w.sum(-1, keepdim=True))
            self.calls.append(r)
            return r
        moe.route = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._orig


def routing_flips(log, n_dense: int):
    """Two runs of one decode step in ``log`` (a ``RouteLog``: the first
    run's MoE layers, then the second's): each (layer, slot, kept experts
    of the first, of the second, and each run's router margin — its k-th
    largest probability less its (k+1)-th) where they differ."""
    import torch
    half = len(log.calls) // 2
    flips = []
    for i in range(half):
        a, b = log.calls[i], log.calls[half + i]
        k = a.top_i.shape[-1]
        for row in range(a.top_i.shape[0]):
            for t in range(a.top_i.shape[1]):
                ea = sorted(a.top_i[row, t][a.keep[row, t]].tolist())
                eb = sorted(b.top_i[row, t][b.keep[row, t]].tolist())
                if ea != eb:
                    gaps = []
                    for pr in (a.probs, b.probs):
                        top = torch.topk(pr[row, t], k + 1).values
                        gaps.append(float(top[k - 1] - top[k]))
                    flips.append((n_dense + i, row, ea, eb, *gaps))
    return flips


def hold_decode_launches(engine, attr, label):
    """One decode step from a copy of the engine's cache with every launch
    of ``kernels.ops.<attr>`` captured (operands and output), then each
    held to the plain version on those operands within one bf16 ulp."""
    import torch
    from repro_torch.kernels import ops, ref
    orig, calls = getattr(ops, attr), []

    def capture(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out
    tokens = torch.full((engine.batch_slots, 1), 7, device=engine.device)
    setattr(ops, attr, capture)
    try:
        engine.model.apply(tokens, cache=_clone_cache(engine.cache),
                           mode="decode")
    finally:
        setattr(ops, attr, orig)
    plain = (ref.decode_attention_ref if attr == "decode_attention"
             else ref.mla_decode_attention_ref)
    err = 0.0
    for j, (a, kw, out) in enumerate(calls):
        err = max(err, _kernel_check(f"{label} launch {j}", out,
                                     plain(*a, **kw), BF16_TOL, None, None))
    return dict(held=len(calls), max_abs_err=err)


def moe_plain(p, cfg, x):
    """The MoE layer computed plainly on the layer's own routing: for each
    expert a kept pair reached, its rows' FFN by ``torch.matmul``, summed
    per token in f32 (experts in order), then the shared experts."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import activation_fn, mlp_apply
    b, s, d = x.shape
    k, dt = cfg.moe.experts_per_token, x.dtype
    act = activation_fn(cfg.activation)
    r = moe_mod.route(p, cfg, x, moe_mod.chunk_size(s))
    xf = x.reshape(b * s, d)
    ti, kp = r.top_i.reshape(-1, k), r.keep.reshape(-1, k)
    tw = r.top_w.reshape(-1, k).to(dt).to(torch.float32)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for e in torch.unique(ti[kp]).tolist():
        rows, slots = ((ti == e) & kp).nonzero(as_tuple=True)
        h = (act(xf[rows] @ p["w_gate"][e].to(dt))
             * (xf[rows] @ p["w_up"][e].to(dt)))
        y[rows] += (h @ p["w_down"][e].to(dt)).to(torch.float32) \
            * tw[rows, slots][:, None]
    y = y.to(dt).reshape(b, s, d)
    if cfg.moe.num_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg.activation)
    return y, int((~r.keep).sum())


def hold_moe_layers(engine, label):
    """Every MoE layer of one decode step (from a copy of the engine's
    cache) and of one prefill of a 64-token prompt, whose chunk drops
    pairs at capacity, with its input and output captured at
    ``models.moe.moe_apply``, then held to ``moe_plain`` on that input
    within one bf16 ulp. Returns the layers held, the pairs the prefill
    dropped and the max abs error."""
    import numpy as np
    import torch
    from repro_torch.models import moe as moe_mod
    model = engine.model
    orig, calls = moe_mod.moe_apply, []

    def capture(p, cfg, x, tp=None):
        y, aux = orig(p, cfg, x, tp)
        calls.append((p, cfg, x, y))
        return y, aux
    tokens = torch.full((engine.batch_slots, 1), 7, device=engine.device)
    prompt = torch.from_numpy(np.random.default_rng(12).integers(
        3, model.cfg.vocab_size, (1, 64))).to(engine.device)
    moe_mod.moe_apply = capture
    try:
        model.apply(tokens, cache=_clone_cache(engine.cache), mode="decode")
        engine._prefill(prompt, torch.tensor([64], device=engine.device),
                        None)
    finally:
        moe_mod.moe_apply = orig
    err, dropped = 0.0, 0
    for j, (p, cfg, x, y) in enumerate(calls):
        want, drops = moe_plain(p, cfg, x)
        err = max(err, _kernel_check(
            f"{label} moe layer {j} {tuple(x.shape)}", y, want, BF16_TOL,
            None, None))
        dropped += drops if x.shape[1] > 1 else 0
    return dict(held=len(calls), prefill_dropped_pairs=dropped,
                max_abs_err=err)


def step_weight_bytes(engine):
    """One decode step from a copy of the engine's cache with the routing
    recorded: the experts that received a kept pair in each MoE layer,
    the bytes of their weights (what the step reads of the routed
    experts) beside all routed experts' bytes, and the bytes the step
    needs — every parameter but the routed experts, the encoder (which
    runs at prefill only) and the embedding and position tables (of which
    it reads one row a slot; the embedding is read whole where it is also
    the head), a weight-tied block once for each of its applications,
    plus the experts used — and the recurrent state read and written
    (``mamba``, ``rwkv``) and the encoder output read (``enc_out``). The
    bound is the larger of those bytes at the memory rate and the
    operations of the per-step cross K/V recompute (audio) at the bf16
    tensor-core rate."""
    import torch
    model = engine.model
    cfg = model.cfg
    b = engine.batch_slots
    tokens = torch.full((b, 1), 7, device=engine.device)
    with RouteLog() as log:
        model.apply(tokens, cache=_clone_cache(engine.cache), mode="decode")
    used = [int(torch.unique(r.top_i[r.keep]).numel()) for r in log.calls]
    other = 0
    for name, t in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks" and parts[2:3] == ["moe"] and parts[3] in (
                "w_gate", "w_up", "w_down"):
            continue
        if parts[0] in ("enc_blocks", "enc_pos_embed", "enc_final_norm"):
            continue
        if name == "pos_embed" or (name == "embed"
                                   and model.lm_head is not None):
            other += b * t.shape[1] * t.element_size()
            continue
        n = t.numel() * t.element_size()
        other += n * (model.attn_applications if parts[0] == "shared" else 1)
    state = sum(2 * v.numel() * v.element_size()
                for g in ("mamba", "rwkv") for v in engine.cache.get(
                    g, {}).values())
    if "enc_out" in engine.cache:
        state += engine.cache["enc_out"].numel() * \
            engine.cache["enc_out"].element_size()
    # the cross attention's K and V of every encoder frame, each layer
    flops = (2 * b * cfg.encoder_seq_len * cfg.d_model
             * 2 * cfg.num_heads * cfg.head_dim * cfg.num_layers
             if cfg.family == "audio" else 0)
    per_expert = 0
    if cfg.moe is not None:
        per_expert = (3 * cfg.d_model * cfg.moe.d_ff
                      * model.embed.element_size())
    read = sum(used) * per_expert
    every = len(used) * (cfg.moe.num_experts if cfg.moe else 0) * per_expert
    bnd, by = bound_ms(other + read + state, 0.0, flops)
    return dict(experts_used=used, expert_bytes_read=read,
                expert_bytes_all=every, other_weight_bytes=other,
                state_bytes=state, recompute_flops=flops,
                bound_ms=bnd, bound_by=by,
                all_experts_bound_ms=bound_ms(other + every + state, 0.0,
                                              flops)[0])


def phase_serve_model(label, cfg, card, *, n_req, max_new, seed, attr,
                      lengths=None, continuation=None):
    """The engine on ``cfg`` (bf16 weights from seed 0, initialised on the
    card; 4 slots, max_len 2048): ``n_req`` text requests of ``lengths``
    tokens (default: drawn from 8–64), ``max_new`` new tokens each; an
    audio request carries 1,500 frames of N(0, 0.02) from the seed, as
    the reference's launcher. The decode kernel of ``attr`` (#5 for
    ``decode_attention``, #6 for ``mla_decode_attention``; None for a
    model without attention) must launch once an attention application a
    decode step (``Transformer.attn_applications``: each layer, the
    hybrid's shared block's applications), all on its tensor-core route,
    the other never. Holds one step's logits, kernel against plain (rel L2
    ≤ 2^-5; each MoE routing flip between the two printed; where one
    occurs, the gate holds the step with the plain run's experts pinned
    to the kernel run's), every attention launch of one step against the
    plain version on its operands, and every MoE layer of a decode step
    and a prefill against ``moe_plain``;
    reports the step's device time, busy share, kernels, the decode
    kernel's µs a launch and the MoE layers' device ms (profiler), the
    bytes a step against their bound, and the peak memory. Frees the
    model and its cache; then, with ``continuation`` (the keyword
    arguments of ``state_continuation``), holds the recurrent or encoder
    state."""
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Request, ServingEngine
    mla = attr == "mla_decode_attention"
    kname, other = (("mla_decode", "gqa_decode") if mla
                    else ("gqa_decode", "mla_decode"))
    fast = "k_mla" if mla else "k_gqa_split"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    apps = model.attn_applications
    engine = ServingEngine(model, batch_slots=4, max_len=2048)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(8, 65)) if lengths is None else lengths[i]
        r = Request(rid=i, tokens=rng.integers(3, cfg.vocab_size, size=n),
                    max_new_tokens=max_new)
        if cfg.family == "audio":
            r.encoder_frames = rng.normal(
                0, 0.02, (cfg.encoder_seq_len, cfg.d_model)).astype(
                    np.float32)
        reqs.append(r)
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    routes = dict(getattr(dk, kname).route_launches)
    steps = len(engine.timings["decode"])
    if attr is None:
        check(apps == 0 and launches["gqa_decode"] == 0
              and launches["mla_decode"] == 0,
              f"{label}: a model without attention launched {launches}")
    else:
        check(launches[kname] == apps * steps,
              f"{label}: {kname} launches {launches[kname]} != "
              f"{apps} x {steps} decode steps")
        check(routes == {fast: launches[kname], "k_partial": 0},
              f"{label}: {kname} routes {routes}")
        check(launches[other] == 0, f"{label} launches {launches}")
    check([r.rid for r in done] == list(range(n_req)), f"{label}: requests")
    for r in done:
        check(len(r.generated) == max_new and all(
            0 <= t < cfg.vocab_size for t in r.generated),
            f"{label}: request {r.rid} generated {r.generated}")
    rep = serve_report(label, engine, done, card)
    rel = agree = held = None
    flips = []
    if attr is not None:
        with RouteLog() as log:
            rel, agree = logits_kernel_vs_plain(engine, attr)
        flips = routing_flips(log, model.n_dense)
        for layer, row, ek, ep, gk, gp in flips:
            print(f"  {label} routing flip: layer {layer} slot {row} "
                  f"experts {ek} (kernel) vs {ep} (plain); top-k margin of "
                  f"the router probabilities {gk:.3e} (kernel), {gp:.3e} "
                  f"(plain)", flush=True)
        held = hold_decode_launches(engine, attr, label)
        check(held["held"] == apps,
              f"{label}: held {held['held']} launches of {apps}")
        check(rel <= 2 ** -5 or flips, f"{label}: kernel vs plain logits "
              f"rel L2 {rel} with no routing flip")
    n_moe = cfg.num_layers - model.n_dense if cfg.moe else 0
    # an MoE step is also compared with the plain step's experts pinned
    # to the kernel step's: the bf16 router's near-ties then cannot move
    # the logits; without a flip both comparisons are gated
    rel_pinned = agree_pinned = held_moe = None
    if n_moe:
        with RouteLog(pin=n_moe) as pinned:
            rel_pinned, agree_pinned = logits_kernel_vs_plain(engine, attr)
        check(len(pinned.calls) == 2 * n_moe, f"{label}: pinned run "
              f"routed {len(pinned.calls)} layers of {2 * n_moe}")
        check(rel_pinned <= 2 ** -5, f"{label}: kernel vs plain logits, "
              f"experts pinned, rel L2 {rel_pinned}")
        held_moe = hold_moe_layers(engine, label)
        check(held_moe["held"] == 2 * n_moe, f"{label}: held "
              f"{held_moe['held']} MoE layers of {2 * n_moe}")
        check(held_moe["prefill_dropped_pairs"] > 0,
              f"{label}: the 64-token prefill dropped no pair")
    wb = step_weight_bytes(engine)
    # the MoE layers' device time: each moe_apply inside a profiler range
    orig_apply = moe_mod.moe_apply

    def ranged(*a, **kw):
        with torch.profiler.record_function("moe_apply"):
            return orig_apply(*a, **kw)
    moe_mod.moe_apply = ranged
    try:
        prof = decode_busy(engine, span="moe_apply" if cfg.moe else None)
    finally:
        moe_mod.moe_apply = orig_apply
    us = (None if prof is None or not apps else
          prof["decode_kernel_us_per_step"] / apps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rep.update(arch=cfg.name, num_layers=cfg.num_layers,
               attn_applications=apps, launches=launches,
               routes=routes, init_s=t_init, logits_rel_l2=rel,
               argmax_agree=agree, routing_flips=flips,
               logits_rel_l2_pinned=rel_pinned,
               argmax_agree_pinned=agree_pinned, held=held,
               held_moe=held_moe,
               weights=wb, profile=prof, kernel_us_per_launch=us,
               peak_gb=peak,
               prompt_lengths=[len(r.tokens) for r in reqs])
    nm = "not measured"
    fmt = lambda x, f: nm if x is None else format(x, f)
    moe_ms = None if prof is None else prof.get("span_device_ms_per_step")
    print(f"  {label} profile: {prof}\n  {label} bytes a step: experts "
          f"used a layer {wb['experts_used']}  expert bytes read "
          f"{wb['expert_bytes_read'] / 1e9:.3f} GB (all experts "
          f"{wb['expert_bytes_all'] / 1e9:.3f} GB)  other weights "
          f"{wb['other_weight_bytes'] / 1e9:.3f} GB  state "
          f"{wb['state_bytes'] / 1e9:.3f} GB  recompute "
          f"{wb['recompute_flops'] / 1e9:.1f} GFLOP  bound "
          f"{wb['bound_ms']:.3f} ms ({wb['bound_by']}; all experts "
          f"{wb['all_experts_bound_ms']:.3f} ms)", flush=True)
    print(f"phase {label}: ok  {cfg.name}, {cfg.num_layers} layers, bf16, "
          f"init {t_init:.2f} s  launches {launches}  routes {routes}  "
          f"s/step {rep['s_per_step']:.6f}  device "
          f"{fmt(prof and prof['device_ms_per_step'], '.3f')} ms a step "
          f"(bound {wb['bound_ms']:.3f} ms), busy "
          f"{fmt(prof and prof['busy_share'], '.3f')}, "
          f"{fmt(prof and prof['kernels_per_step'], '.0f')} kernels a step, "
          f"{'#6' if mla else '#5'} x {apps} a step, {fmt(us, '.2f')} "
          f"device us a launch, MoE layers {fmt(moe_ms, '.3f')} device ms "
          f"a step  logits rel L2 {fmt(rel, '.3e')} (argmax agree "
          f"{fmt(agree, '.2f')}, {len(flips)} routing flips; experts "
          f"pinned: {fmt(rel_pinned, '.3e')}, argmax agree "
          f"{fmt(agree_pinned, '.2f')})  "
          f"{'no' if held is None else held['held']} launches held "
          f"(max abs err {fmt(held and held['max_abs_err'], '.3e')}); MoE "
          f"layers held to the plain version: "
          f"{'none' if held_moe is None else held_moe}  peak "
          f"{peak:.1f} GB  [{card}]",
          flush=True)
    del engine, model, done
    gc.collect()
    torch.cuda.empty_cache()
    if continuation:
        rep["continuation"] = state_continuation(label, cfg, **continuation)
    return rep


def state_continuation(label, cfg, prompt: int, extra: int = 4,
                       layers=None):
    """The recurrent and encoder state on the card: ``cfg`` in float32
    (weights from seed 0, TF32 off) prefills ``prompt`` tokens of two
    sequences (audio: over 1,500 frames each) into a cache, then decodes
    ``extra`` more one at a time; the prefill's and every decode step's
    logits against the same model's train-mode logits over all the tokens
    at rtol = atol = 1e-3 (``tests/test_models.py::
    test_prefill_decode_parity``'s bound). With ``layers`` the model is
    cut to that depth (full width), and first the full-depth model's
    train-mode logits are printed beside how far they move when the
    embedding table is scaled by 1 + 1e-7, about one f32 rounding: at a
    depth where rounding alone moves the logits past the bound, the
    comparison cannot hold whatever the port does. Frees the model."""
    import gc
    import numpy as np
    import torch
    from repro_torch.models.transformer import init_model
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(13)
    tok = torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (2, prompt + extra))).cuda()
    kw = {}
    if cfg.family == "audio":
        kw["encoder_frames"] = torch.from_numpy(rng.normal(
            0, 0.02, (2, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)).cuda()
    moved = None
    if layers is not None:
        model = init_model(f32, seed=0, device="cuda")
        full = model.apply(tok, mode="train", **kw)[0]
        model.embed.mul_(1 + 1e-7)
        moved = float((model.apply(tok, mode="train", **kw)[0]
                       - full).abs().max())
        print(f"  {label} continuation: the {cfg.num_layers}-layer f32 "
              f"model's train logits (up to {float(full.abs().max()):.2f})"
              f" move by {moved:.3e} under a 1e-7 relative change of the "
              f"embedding; held at {layers} layers", flush=True)
        del model, full
        f32 = f32.replace(num_layers=layers)
    model = init_model(f32, seed=0, device="cuda")
    full = model.apply(tok, mode="train", **kw)[0]
    cache = model.init_cache(2, prompt + extra, torch.float32)
    got, cache, _ = model.apply(tok[:, :prompt], mode="prefill",
                                cache=cache, **kw)
    pairs = [(got[:, 0], full[:, prompt - 1])]
    for t in range(prompt, prompt + extra):
        got, cache, _ = model.apply(tok[:, t:t + 1], mode="decode",
                                    cache=cache)
        pairs.append((got[:, 0], full[:, t]))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    for j, (a, b) in enumerate(pairs):
        check(bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=1e-3, atol=1e-3), f"{label} continuation step {j}: "
            f"max abs err {float((a - b).abs().max())}")
    scale = float(full.abs().max())
    print(f"  {label} continuation: ok  f32 on the card, "
          f"{f32.num_layers} layers, prompt {prompt} + {extra} decode steps "
          f"against train mode: max abs err {err:.3e} (logits up to "
          f"{scale:.2f})", flush=True)
    del model, cache, full
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prompt=prompt, extra=extra, layers=f32.num_layers,
                max_abs_err=err, max_abs_logit=scale,
                full_depth_moved_by_1e7=moved)


def phase_serve_moe(card):
    """DeepSeek-V2-Lite-16B at full width and depth (27 layers: 1 dense,
    26 MoE of 64 routed + 2 shared experts; MLA, kernel #6)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("deepseek-v2-lite-16b").replace(param_dtype="bfloat16")
    return phase_serve_model("serve_moe", cfg, card, n_req=8, max_new=12,
                             seed=9, attr="mla_decode_attention")


def phase_serve_olmoe(card):
    """OLMoE-1B-7B at full width and depth (16 MoE layers of 64 experts,
    top 8; kernel #5 at G = 1)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("olmoe-1b-7b").replace(param_dtype="bfloat16")
    return phase_serve_model("serve_olmoe", cfg, card, n_req=8, max_new=12,
                             seed=10, attr="decode_attention")


ZOO = ("glm4-9b", "nemotron-4-15b", "deepseek-7b")
ZOO_LAYERS = 4


def phase_serve_zoo(card):
    """GLM-4-9B, Nemotron-4-15B and DeepSeek-LLM-7B at full width (d_model,
    heads, kv heads, d_ff, vocab), cut to ``ZOO_LAYERS`` layers each:
    kernel #5 at G = 16, 6 and 1."""
    from repro_torch.configs.registry import get_config
    out = {}
    for arch in ZOO:
        full = get_config(arch)
        print(f"  serve_zoo[{arch}]: cut to {ZOO_LAYERS} of "
              f"{full.num_layers} layers", flush=True)
        cfg = full.replace(num_layers=ZOO_LAYERS, param_dtype="bfloat16")
        out[arch] = phase_serve_model(f"serve_zoo[{arch}]", cfg, card,
                                      n_req=4, max_new=8, seed=11,
                                      attr="decode_attention")
        out[arch]["published_layers"] = full.num_layers
    return out


def phase_serve_hybrid(card):
    """Zamba2-2.7B at full width and depth (54 Mamba2 layers; the shared
    attention block, #5 at G = 1, D = 80, after each group of 6: 9
    applications a step): 8 requests of 8–200 tokens, two of them over
    128, so the SSD's multi-chunk scan and its padded last chunk run on
    the card; then the f32 continuation over a 150-token prompt (3
    chunks, the last padded)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    cfg = get_config("zamba2-2.7b").replace(param_dtype="bfloat16")
    lengths = [200, 137] + [int(x) for x in
                            np.random.default_rng(14).integers(8, 201, 6)]
    return phase_serve_model("serve_hybrid", cfg, card, n_req=8, max_new=12,
                             seed=14, attr="decode_attention",
                             lengths=lengths,
                             continuation=dict(prompt=150))


def phase_serve_rwkv(card):
    """RWKV6-1.6B at full width and depth (24 layers; no attention: neither
    decode kernel may launch): 8 requests of 8–64 tokens, prefilled at
    their exact lengths; then the f32 continuation over 24 tokens, at 4
    layers: with the reference's random initialisation (decay ≈ 0.9975 a
    token) the 24-layer model amplifies rounding past the 1e-3 bound (on
    the CPU a 1e-6 change of the embedding moves 2, 4 and 8 layers'
    logits by 3e-5, 1e-4 and 1.5e-3), which the phase prints."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("rwkv6-1.6b").replace(param_dtype="bfloat16")
    return phase_serve_model("serve_rwkv", cfg, card, n_req=8, max_new=12,
                             seed=15, attr=None,
                             continuation=dict(prompt=24, layers=4))


def phase_serve_whisper(card):
    """Whisper-base at full width and depth (6 encoder and 6 decoder
    layers; the decoder's self-attention is #5 at G = 1, D = 64): 8
    requests of 8–64 tokens, each with 1,500 × 512 encoder frames; then
    the f32 continuation over 20 tokens, its decode reading the encoder's
    output back from the cache."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("whisper-base").replace(param_dtype="bfloat16")
    return phase_serve_model("serve_whisper", cfg, card, n_req=8,
                             max_new=12, seed=16, attr="decode_attention",
                             continuation=dict(prompt=20))


# ---------------------------------------------------------------------------
# training (phases 21-25): plain PyTorch, no hand-written kernel on the path
# ---------------------------------------------------------------------------

MEM_PATCHES = 784                  # 224² frames in 8 × 8 patches
TRAIN_SEQ = 512


def _fingerprint(model):
    """Σ p² of each parameter in f64: a leaf that an update moved changes
    its fingerprint."""
    import torch
    with torch.no_grad():
        return {k: float(torch.sum(torch.square(p.to(torch.float64))))
                for k, p in model.named_parameters()}


def loss_and_grads(model, loss_fn):
    """(loss, {name: gradient}) of ``loss_fn(model)`` over the model's
    parameters, unfrozen for it."""
    import torch
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, _ = loss_fn(model)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def _rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖, summed in f64 on b's device."""
    import torch
    f64 = torch.float64
    den = float(torch.linalg.vector_norm(b, dtype=f64))
    num = float(torch.linalg.vector_norm(a.to(b.device) - b, dtype=f64))
    return num / den if den else num


def hold_grads(label, got, want, gate):
    """Every gradient leaf of ``got`` within ``gate`` relative L2 of
    ``want``'s and finite; → (worst leaf, its error)."""
    import math
    import torch
    check(set(got) == set(want), f"{label}: gradient leaves differ")
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"{label}: a gradient is not finite")
    check(errs[worst] <= gate and math.isfinite(errs[worst]),
          f"{label}: {worst} rel L2 {errs[worst]:.3e} > {gate}")
    return worst, errs[worst]


def train_run(label, model, step, batches, card, *, units, unit_name,
              first_step=0):
    """Train ``model`` on the card over ``batches`` with ``step``; every
    metric finite. → seconds a step (the median after the first, which
    warms the allocator), ``units`` a step per second, the peak of
    ``torch.cuda.max_memory_allocated`` and the optimiser alone (AdamW in
    place over this model's state with zero gradients and lr 0, CUDA
    events) beside the step."""
    import math
    import statistics
    import torch
    from repro_torch.training import adamw_init, adamw_update
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(dict(model.named_parameters()))
    secs, hist = [], {}
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b, first_step + i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for k, v in m.items():
            hist.setdefault(k, []).append(float(v))
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad = {k: v for k, v in hist.items()
           if not all(math.isfinite(x) for x in v)}
    check(not bad, f"{label}: metrics not finite: {bad}")
    params = dict(model.named_parameters())
    zero = {k: torch.zeros_like(p) for k, p in params.items()}
    opt_ms = cuda_ms(lambda: adamw_update(zero, opt, params, lr=0.0),
                     reps=3)
    del zero, opt
    step_s = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
    out = dict(steps=len(secs), step_s=step_s, first_step_s=secs[0],
               all_step_s=secs, **{f"{unit_name}_per_s": units / step_s},
               peak_gb=peak, optimiser_ms=opt_ms,
               optimiser_share=opt_ms / 1e3 / step_s, metrics=hist,
               params=sum(p.numel() for p in params.values()))
    print(f"  {label}: {len(secs)} steps, {step_s:.4f} s a step (first "
          f"{secs[0]:.3f}), {units / step_s:.1f} {unit_name}/s, "
          f"optimiser {opt_ms:.2f} ms = {100 * out['optimiser_share']:.1f} "
          f"% of a step, peak {peak:.2f} GB, {out['params'] / 1e9:.3f} B "
          f"params  [{card}]", flush=True)
    return out


def free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def mem_pairs(cfg, n, steps, seed, device):
    """SigLIP pairs as ``tests/test_training.py::
    test_mem_contrastive_training_improves`` builds them, at full width
    with n classes: each class a prototype patch row (N(0, 1), repeated
    over the frame's patches, N(0, 0.1) noise) and a caption; each batch
    the n classes in a random order (distinct rows, as SigLIP needs)."""
    import numpy as np
    import torch
    from repro_torch.data.text import tokenize_batch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    dv = cfg.vision.d_model
    protos = torch.from_numpy(rng.normal(0, 1, (n, dv)).astype(
        np.float32)).to(device)
    texts = [f"class{i} object{i}" for i in range(n)]
    out = []
    for _ in range(steps):
        cls = rng.permutation(n)
        toks, mask = tokenize_batch([texts[c] for c in cls],
                                    cfg.text.vocab_size, 16)
        patches = protos[torch.from_numpy(cls).to(device)][:, None].expand(
            n, MEM_PATCHES, dv) + 0.1 * torch.randn(
            (n, MEM_PATCHES, dv), generator=gen, device=device)
        out.append({"tokens": toks, "mask": mask, "patches": patches})
    return out


def phase_train_mem(card):
    """SigLIP training of venus-mem-large at full width and depth (text
    12 × 768, vision 12 × 1024 over 784 patches; f32 weights, bf16
    activations): 32 pairs a batch, remat on, 20 steps; the contrastive
    accuracy of the last 5 steps above the first 5's."""
    import numpy as np
    from repro_torch.configs.venus_mem import config as mem_config
    from repro_torch.models.mem import MEM
    from repro_torch.training import TrainHParams, make_mem_train_step
    cfg = mem_config()
    mem = MEM.init(cfg, seed=0, device="cuda")
    batches = mem_pairs(cfg, 32, 20, seed=21, device="cuda")
    # lr 3e-4 with 2 warm-up steps (the CPU test's) lifts the accuracy to
    # 0.81 at step 2 at this width, then collapses it to 0.03 by step 10
    step = make_mem_train_step(mem, TrainHParams(base_lr=5e-5, warmup=5,
                                                 total_steps=20))
    r = train_run("train_mem", mem, step, batches, card, units=32,
                  unit_name="pairs")
    acc = r["metrics"]["contrastive_acc"]
    check(np.mean(acc[-5:]) > np.mean(acc[:5]),
          f"train_mem: contrastive accuracy did not rise: {acc}")
    print(f"phase train_mem: ok  contrastive accuracy {acc}: first 5 "
          f"steps {np.mean(acc[:5]):.4f}, last 5 {np.mean(acc[-5:]):.4f}; "
          f"loss {r['metrics']['loss'][0]:.4f} -> "
          f"{r['metrics']['loss'][-1]:.4f}  [{card}]", flush=True)
    del mem, batches, step
    free_card()
    return r


def lm_batches_for(cfg, batch, seq, steps, seed):
    from repro_torch.data.text import lm_batches
    it = lm_batches(cfg.vocab_size, batch, seq, seed=seed)
    return [next(it) for _ in range(steps)]


def phase_train_lm(card, layers: int = 4):
    """deepseek-7b (the launcher's default) at full width (4096, vocab
    102,400), cut to ``layers`` layers: first the gradients of one batch
    with remat off and on, held equal (rel L2 ≤ 1e-5 a leaf) with each
    one's peak memory; then 20 steps of 4 × 512 tokens from
    ``lm_batches``, remat on; the mean loss of the last 3 steps below the
    first 3's."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import TrainHParams, make_train_step
    from repro_torch.training.trainer import lm_loss
    full = get_config("deepseek-7b")
    cfg = full.replace(num_layers=layers)
    print(f"  train_lm: deepseek-7b cut to {layers} of {full.num_layers} "
          f"layers", flush=True)
    model = init_model(cfg, seed=0, device="cuda")
    batches = lm_batches_for(cfg, 4, TRAIN_SEQ, 20, seed=0)
    b0 = {k: torch.from_numpy(v).cuda() for k, v in batches[0].items()}
    grads, remat = {}, {}
    for on in (False, True):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = loss_and_grads(model, lambda m: lm_loss(cfg, m, b0,
                                                          remat=on))
        torch.cuda.synchronize()
        remat[on] = dict(loss=float(loss), s=time.perf_counter() - t0,
                         activation_gb=(torch.cuda.max_memory_allocated()
                                        - base) / 1e9)
        grads[on] = g
        del g
    worst, err = hold_grads("train_lm remat", grads[True], grads[False],
                            1e-5)
    check(abs(remat[True]["loss"] - remat[False]["loss"])
          <= 1e-6 * abs(remat[False]["loss"]),
          f"train_lm: remat loss {remat[True]['loss']} != "
          f"{remat[False]['loss']}")
    del grads
    print(f"  train_lm: remat on vs off, one batch: loss "
          f"{remat[True]['loss']:.6f} both, worst gradient {worst} rel L2 "
          f"{err:.3e}; forward+backward {remat[False]['s']:.3f} s off, "
          f"{remat[True]['s']:.3f} s on (cold); beyond the weights "
          f"{remat[False]['activation_gb']:.2f} GB off, "
          f"{remat[True]['activation_gb']:.2f} GB on", flush=True)
    free_card()
    step = make_train_step(cfg, TrainHParams(base_lr=3e-4, warmup=2,
                                             total_steps=20))
    r = train_run("train_lm", model, step, batches, card,
                  units=4 * TRAIN_SEQ, unit_name="tokens")
    loss = r["metrics"]["loss"]
    check(np.mean(loss[-3:]) < np.mean(loss[:3]),
          f"train_lm: the loss did not fall: {loss}")
    print(f"phase train_lm: ok  loss {[round(x, 4) for x in loss]}: first "
          f"3 steps {np.mean(loss[:3]):.4f}, last 3 {np.mean(loss[-3:]):.4f}"
          f"  [{card}]", flush=True)
    r.update(remat=remat, remat_worst_rel_l2=err,
             published_layers=full.num_layers, layers=layers)
    del model, batches, step, b0
    free_card()
    return r


class RouteSpy:
    """Records the ``Routing`` of every MoE layer ``moe.route`` computes
    while it is installed (``with RouteSpy() as spy``)."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.routes, self._route = [], moe_mod.route

        def spy(*a, **kw):
            r = self._route(*a, **kw)
            self.routes.append(r)
            return r
        moe_mod.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod
        moe_mod.route = self._route


def phase_train_moe(card, layers: int = 4):
    """OLMoE-1B-7B at full width (2048, 64 experts, top 8) cut to
    ``layers`` layers: 10 steps of 4 × 512 tokens, remat on; then the
    last batch's gradients, remat off, with the routing recorded: pairs
    dropped at capacity, every gradient — each router's included, and
    nonzero — finite; the drop share and the experts each layer's kept
    pairs reached printed."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import TrainHParams, make_train_step
    from repro_torch.training.trainer import lm_loss
    full = get_config("olmoe-1b-7b")
    cfg = full.replace(num_layers=layers)
    print(f"  train_moe: olmoe-1b-7b cut to {layers} of {full.num_layers} "
          f"layers", flush=True)
    model = init_model(cfg, seed=0, device="cuda")
    batches = lm_batches_for(cfg, 4, TRAIN_SEQ, 10, seed=1)
    step = make_train_step(cfg, TrainHParams(base_lr=3e-4, warmup=1,
                                             total_steps=10))
    r = train_run("train_moe", model, step, batches, card,
                  units=4 * TRAIN_SEQ, unit_name="tokens")
    last = {k: torch.from_numpy(v).cuda() for k, v in batches[-1].items()}
    with RouteSpy() as spy:
        _, grads = loss_and_grads(model, lambda m: lm_loss(cfg, m, last))
    check(len(spy.routes) == layers, f"train_moe: {len(spy.routes)} routings")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "train_moe: a gradient is not finite")
    routers = [k for k in grads if k.endswith("moe.router")]
    check(len(routers) == layers and all(
        float(grads[k].abs().max()) > 0 for k in routers),
        "train_moe: a router's gradient is zero")
    drop = [float(1 - rt.keep.float().mean()) for rt in spy.routes]
    reached = [int(torch.unique(rt.top_i[rt.keep]).numel())
               for rt in spy.routes]
    check(max(drop) > 0, f"train_moe: no pair dropped ({drop})")
    print(f"phase train_moe: ok  every gradient finite, routers' max "
          f"|g| {[round(float(grads[k].abs().max()), 6) for k in routers]};"
          f" dropped share a layer {[round(d, 4) for d in drop]}; experts "
          f"reached a layer {reached} of {cfg.moe.num_experts}  [{card}]",
          flush=True)
    r.update(drop_share=drop, experts_reached=reached,
             published_layers=full.num_layers, layers=layers)
    del model, batches, step, grads, spy, last
    free_card()
    return r


# (arch, layers or None for full depth, batch, text tokens)
TRAIN_ZOO = (("qwen2-vl-7b", 4, 2, TRAIN_SEQ),
             ("minicpm3-4b", 4, 4, TRAIN_SEQ),
             ("zamba2-2.7b", 6, 4, TRAIN_SEQ),
             ("rwkv6-1.6b", 4, 4, TRAIN_SEQ),
             ("whisper-base", None, 4, 256))


def phase_train_zoo(card):
    """One step each, at full width, of the families ``train_lm`` and
    ``train_moe`` do not run: Qwen2-VL-7B (4 layers; 1,024 vision tokens
    a row, N(0, 0.02)), MiniCPM3-4B (4 layers, MLA), Zamba2-2.7B (6
    Mamba2 layers + 1 application of the shared block), RWKV6-1.6B (4
    layers; the WKV loop over 512 steps) and Whisper-base (full depth,
    1,500 encoder frames a row): a finite loss and changed parameters
    (the card's ``test_smoke_train_step``); a second step timed warm."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import TrainHParams, make_train_step
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(22)
    for arch, layers, b, s in TRAIN_ZOO:
        full = get_config(arch)
        cfg = full if layers is None else full.replace(num_layers=layers)
        model = init_model(cfg, seed=0, device="cuda")
        batches = lm_batches_for(cfg, b, s, 2, seed=2)
        for batch in batches:
            if cfg.family == "vlm":
                batch["vision_embeds"] = 0.02 * torch.randn(
                    (b, cfg.vision_tokens, cfg.d_model), generator=gen,
                    device="cuda")
            if cfg.family == "audio":
                batch["encoder_frames"] = 0.02 * torch.randn(
                    (b, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                    device="cuda")
        before = _fingerprint(model)
        step = make_train_step(cfg, TrainHParams(warmup=1, total_steps=10))
        r = train_run(f"train_zoo[{arch}]", model, step, batches, card,
                      units=b * s, unit_name="tokens", first_step=1)
        after = _fingerprint(model)
        moved = sum(after[k] != v for k, v in before.items())
        check(moved > 0, f"train_zoo[{arch}]: no parameter changed")
        r.update(layers=cfg.num_layers, published_layers=full.num_layers,
                 batch=b, seq=s, leaves_changed=moved, leaves=len(before))
        print(f"  train_zoo[{arch}]: ok  {cfg.num_layers} of "
              f"{full.num_layers} layers, loss {r['metrics']['loss'][0]:.4f}"
              f", {moved} of {len(before)} parameter leaves changed",
              flush=True)
        out[arch] = r
        del model, batches, step
        free_card()
    print(f"phase train_zoo: ok  {', '.join(out)}  [{card}]", flush=True)
    return out


def phase_train_parity(card):
    """The train path on the card against the port on the CPU, float32
    with TF32 off, the same weights and batch: MEM at full width with 2
    layers a tower (4 pairs), and OLMoE at full width with 1 layer (2 ×
    64 tokens; the routing recorded on both sides and held equal, its
    least top-k margin printed); each gradient leaf within 1e-4 relative
    L2 of the CPU's, the worst printed."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.venus_mem import config as mem_config
    from repro_torch.models.mem import MEM
    from repro_torch.models.transformer import init_model
    from repro_torch.training.trainer import lm_loss, mem_loss
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    out = {}
    mc = mem_config()
    mc = dataclasses.replace(
        mc, text=mc.text.replace(num_layers=2, dtype="float32"),
        vision=mc.vision.replace(num_layers=2, dtype="float32"))
    cpu = MEM.init(mc, seed=3, device="cpu")
    dev = copy.deepcopy(cpu).to("cuda")
    batch = mem_pairs(mc, 4, 1, seed=23, device="cpu")[0]
    res = {}
    for name, m, where in (("cpu", cpu, "cpu"), ("card", dev, "cuda")):
        b = {k: torch.as_tensor(v).to(where) for k, v in batch.items()}
        res[name] = loss_and_grads(m, lambda mm: mem_loss(mm, b))
    worst, err = hold_grads("train_parity mem", res["card"][1],
                            res["cpu"][1], 1e-4)
    lerr = abs(float(res["card"][0]) - float(res["cpu"][0]))
    check(lerr <= 1e-5 * abs(float(res["cpu"][0])) + 1e-6,
          f"train_parity mem: loss {float(res['card'][0])} vs "
          f"{float(res['cpu'][0])}")
    out["mem"] = dict(worst=worst, rel_l2=err, loss_abs_err=lerr)
    print(f"  train_parity[mem]: ok  loss {float(res['cpu'][0]):.6f}, "
          f"|card - cpu| {lerr:.2e}; worst gradient {worst} rel L2 "
          f"{err:.3e}", flush=True)
    del cpu, dev, res
    free_card()
    cfg = get_config("olmoe-1b-7b").replace(num_layers=1, dtype="float32")
    cpu = init_model(cfg, seed=4, device="cpu")
    dev = copy.deepcopy(cpu).to("cuda")
    raw = lm_batches_for(cfg, 2, 64, 1, seed=24)[0]
    res, routes = {}, {}
    for name, m, where in (("cpu", cpu, "cpu"), ("card", dev, "cuda")):
        b = {k: torch.from_numpy(v).to(where) for k, v in raw.items()}
        with RouteSpy() as spy:
            res[name] = loss_and_grads(m, lambda mm: lm_loss(cfg, mm, b))
        routes[name] = spy.routes[0]
    rc, rd = routes["cpu"], routes["card"]
    check(torch.equal(rc.top_i, rd.top_i.cpu())
          and torch.equal(rc.keep, rd.keep.cpu()),
          "train_parity olmoe: the card routed otherwise than the CPU")
    srt = torch.sort(rc.probs.detach(), dim=-1, descending=True).values
    k = cfg.moe.experts_per_token
    margin = float((srt[..., k - 1] - srt[..., k]).min())
    worst, err = hold_grads("train_parity olmoe", res["card"][1],
                            res["cpu"][1], 1e-4)
    lerr = abs(float(res["card"][0]) - float(res["cpu"][0]))
    check(lerr <= 1e-5 * abs(float(res["cpu"][0])) + 1e-6,
          f"train_parity olmoe: loss {float(res['card'][0])} vs "
          f"{float(res['cpu'][0])}")
    drop = float(1 - rc.keep.float().mean())
    out["olmoe"] = dict(worst=worst, rel_l2=err, loss_abs_err=lerr,
                        top_k_margin=margin, drop_share=drop)
    print(f"  train_parity[olmoe]: ok  the same routing (least top-{k} "
          f"margin {margin:.3e}, {100 * drop:.1f} % of pairs dropped); loss "
          f"|card - cpu| {lerr:.2e}; worst gradient {worst} rel L2 "
          f"{err:.3e}", flush=True)
    print(f"phase train_parity: ok  f32, TF32 off  [{card}]", flush=True)
    del cpu, dev, res, routes
    free_card()
    return out


def phase_train(card):
    """Phases 21-25; no hand-written kernel launches on the train path."""
    from repro_torch.kernels import ops
    ops.reset_kernel_launches()
    out = dict(train_mem=phase_train_mem(card),
               train_lm=phase_train_lm(card),
               train_moe=phase_train_moe(card),
               train_zoo=phase_train_zoo(card),
               train_parity=phase_train_parity(card))
    launched = {k: v for k, v in ops.kernel_launches().items() if v}
    check(not launched, f"train phases launched kernels: {launched}")
    return out


# ---------------------------------------------------------------------------
# 27. FSDP2 on one card, and the dry run held to it
# ---------------------------------------------------------------------------

MESH_LAYERS = 4
MESH_STEPS = 3


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_steps(label, model, opt, step, batches, card):
    """Run ``step`` over ``batches`` → (losses, seconds a step, model,
    opt)."""
    import torch
    losses, secs = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b, i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(f"  mesh_train {label}: losses {losses}  step s {secs}  "
          f"[{card}]", flush=True)
    return losses, secs, model, opt


def phase_mesh_train(card, layers: int = MESH_LAYERS):
    """DeepSeek-LLM-7B at full width cut to ``layers`` layers: 3 steps
    without a mesh, then 3 under FSDP2 on a (1, 1) mesh of one NCCL
    rank, on the same batches; the dry run of the step held to the
    card."""
    import statistics
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh, to_device_mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.training import TrainHParams, adamw_init
    from repro_torch.training.trainer import fsdp_shard, make_train_step
    cfg = get_config("deepseek-7b").replace(num_layers=layers)
    host = make_abstract_mesh((1, 1), ("data", "model"))
    shape = ShapeSpec("train_4k", TRAIN_SEQ, 4, "train")
    t0 = time.perf_counter()
    rec = dryrun.lower_combo("deepseek-7b", shape, mesh=host, cfg=cfg,
                             verbose=False)
    t_dry = time.perf_counter() - t0
    raw = lm_batches_for(cfg, 4, TRAIN_SEQ, MESH_STEPS, seed=0)
    hp = TrainHParams(base_lr=3e-4, warmup=1, total_steps=MESH_STEPS)
    free_card()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = init_model(cfg, seed=0, device="cuda")
    opt = adamw_init(dict(model.named_parameters()))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in raw[0].items()}]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    arg = rec["memory"]["argument_bytes"]
    check(abs(held - arg) <= 0.01 * arg,
          f"mesh_train: dry-run argument bytes {arg} vs {held} allocated")
    batches += [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                for b in raw[1:]]
    torch.cuda.reset_peak_memory_stats()
    before_step = torch.cuda.memory_allocated()
    step = make_train_step(cfg, hp)
    plain, plain_s, model, opt = _mesh_steps("no mesh", model, opt, step,
                                             batches, card)
    step_peak = torch.cuda.max_memory_allocated() - before_step
    want = {k: p.detach().clone() for k, p in model.named_parameters()}
    # one more step under the counter: a dispatch mode changes the bf16
    # products' rounding, so the compared steps run without it
    with FlopCounterMode(display=False) as flops:
        step(model, opt, batches[0], MESH_STEPS)
    card_flops = flops.get_total_flops()
    check(rec["flops_per_device"] == card_flops,
          f"mesh_train: dry-run flops {rec['flops_per_device']} != "
          f"{card_flops} counted on the card")
    del model, opt
    free_card()
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    try:
        dm = to_device_mesh(host, "cuda")
        model = fsdp_shard(init_model(cfg, seed=0, device="cuda"), dm)
        opt = adamw_init(dict(model.named_parameters()))
        fsdp, fsdp_s, model, opt = _mesh_steps(
            "fsdp (1, 1)", model, opt, make_train_step(cfg, hp, mesh=dm),
            batches, card)
        dmax = pmax = 0.0
        worst = None
        with torch.no_grad():
            for k, p in model.named_parameters():
                full = p.full_tensor()
                d = float((full - want[k]).abs().max())
                pmax = max(pmax, float(want[k].abs().max()))
                if worst is None or d > dmax:
                    dmax, worst = d, k
        del model, opt, full
    finally:
        dist.destroy_process_group()
    del want, batches
    free_card()
    check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(fsdp, plain)),
          f"mesh_train: losses {fsdp} vs {plain} without a mesh")
    check(dmax <= 1e-6 * pmax,
          f"mesh_train: parameters after step {MESH_STEPS}: max |d| {dmax}"
          f" ({worst}) > 1e-6 x {pmax}")
    out = dict(layers=layers, losses=plain, fsdp_losses=fsdp,
               step_s=statistics.median(plain_s[1:]),
               fsdp_step_s=statistics.median(fsdp_s[1:]),
               all_step_s=plain_s, fsdp_all_step_s=fsdp_s,
               param_max_abs_diff=dmax, param_max_abs=pmax,
               dryrun=rec, dryrun_s=t_dry, allocated_argument_bytes=held,
               card_flops=card_flops, step_peak_bytes=step_peak)
    print(f"phase mesh_train: ok  deepseek-7b {layers} layers, 4 x "
          f"{TRAIN_SEQ}: step {out['step_s']:.4f} s without a mesh, "
          f"{out['fsdp_step_s']:.4f} s FSDP2 (1, 1) (median of steps 2-3); "
          f"losses equal (rtol 1e-6), params max |d| {dmax:.3e} of "
          f"{pmax:.3e}; dry run ({t_dry:.2f} s on meta): argument bytes "
          f"{arg:.0f} vs {held} allocated ({100 * (held / arg - 1):+.3f} "
          f"%), flops {rec['flops_per_device']:.6e} = card's, temp bytes "
          f"{rec['memory']['temp_bytes']:.0f} (estimate) vs a step's peak "
          f"{step_peak} (ratio {rec['memory']['temp_bytes'] / step_peak:.3f})"
          f"  [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# 26. the sharded memory path
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------- tp_serve
# The model axis: the serving launcher under torchrun against one process.
# (arch, model-axis size K, cache rows): Qwen2-VL-7B at (1, 2) keeps 14 q
# and 2 KV heads a rank (#5 on k_gqa_split at G = 7); GLM-4-9B at (1, 4),
# all 40 layers: its 2 KV heads do not divide 4, so its cache splits by
# sequence and #5's partials are merged across the ranks. Its 64 rows
# give 16 a rank, so the served prompts (55 and 29 tokens) and the
# teacher-forced ones (19 and 20) put valid rows on two to four ranks,
# and some shards of a sequence hold none. The MLA and MoE decoders, each
# at full width and depth: DeepSeek-V2-Lite-16B at (1, 4), 27 layers,
# 4 of 16 heads, 16 of 64 experts and a quarter of the shared expert a
# rank, its latent cache by sequence at 16 rows a rank; MiniCPM3-4B at
# (1, 2), 62 layers, 20 heads a rank (``w_uq`` split), the vocabulary
# split under tied embeddings, 32 cache rows a rank; OLMoE-1B-7B at (1,
# 2), 16 layers, the GQA heads path (8 of 16 KV heads a rank) with 32 of
# 64 experts a rank. #6 runs its partials on each rank's rows and one
# cross-rank k_merge a layer merges them. The rest of the zoo: Zamba2-2.7B
# at (1, 4), 2048 cache rows: 20 of 80 Mamba2 heads, 8 of the shared
# block's 32 heads and a quarter of its MLP's columns a rank, #5 on
# k_gqa_split at D = 80 over the rank's heads; served at full depth (54
# layers, 9 launches a step) with its rel L2 printed, held at 12 layers;
# RWKV6-1.6B at (1, 2), 16 of 32 heads a rank, served at full depth (24
# layers) and held at 4. A model's bf16 arithmetic is itself that far
# from its f32 one at depth (one process, bf16 against f32 activations:
# Zamba2 3.0 % at 12 layers, 7.2 % at 54; RWKV6 6.4–7.1 % at 4 layers,
# 106 % at 24), so a second bf16 arithmetic (the mesh's) cannot be held
# to TP_BOUND at full depth: PERF.md §6, PR 29. Whisper-base at (1, 2),
# all 6 + 6 layers, held, 448 cache rows (its decoder's own context),
# 1,500 encoder frames a request, 4 of 8 heads a rank in the encoder,
# the self and the cross attention, #5 at D = 64.
# (arch, K, cache rows, layers (None: the config's), logits held)
TP_CASES = (("qwen2-vl-7b", 2, 2048, None, True),
            ("glm4-9b", 4, 64, None, True),
            ("deepseek-v2-lite-16b", 4, 64, None, True),
            ("minicpm3-4b", 2, 64, None, True),
            ("olmoe-1b-7b", 2, 2048, None, True),
            ("zamba2-2.7b", 4, 2048, None, False),
            ("zamba2-2.7b", 4, 2048, 12, True),
            ("rwkv6-1.6b", 2, 512, None, False),
            ("rwkv6-1.6b", 2, 512, 4, True),
            ("whisper-base", 2, 448, None, True))
# the recurrent state held after the teacher-forced steps, by family
TP_STATE = {"hybrid": ("mamba", "ssm"), "ssm": ("rwkv", "wkv")}
TP_ARGS = ("--full", "--param-dtype", "bfloat16", "--requests", "2",
           "--slots", "2", "--max-new", "3")
# teacher-forced logits, mesh against one process: relative L2 of each
# step's (B, V) logits. Both run bf16 weights and activations; the mesh
# sums each row-parallel product's R bf16 partials in f32 (two a layer)
# and merges #5 over other splits, so each layer adds a few bf16
# roundings (2^-9 relative) that one process does not make
TP_BOUND = 2 ** -4
# each rank's decode steps under the profiler (the first is held)
TP_PROFILED = (2, 3, 4)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-6)
# the first kernel of each decode launch by its wrapper's name
TP_FIRST = {"k_gqa_split": "_launch_gqa_split", "k_partial": "_launch_gqa",
            "k_mla": "_launch_mla_split", "k_partial_mla": "_launch_mla"}


def attn_layers(cfg) -> int:
    """Attention layers a decode step runs: the hybrid's shared-block
    applications, none for RWKV6, else every layer."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    return 0 if cfg.rwkv is not None else cfg.num_layers


def reduced_parts(m, l, acc):
    """Softmax parts m, l (B, H, N), acc (B, H, N, D) as one part: (M,
    sum l e^(m - M), sum acc e^(m - M)), M = max m."""
    import torch
    top = m.amax(-1)
    w = torch.exp(m - top[..., None])
    return top, (l * w).sum(-1), (acc * w[..., None]).sum(2)


def hold_parts(got, want, v, what) -> float:
    """Partials against the plain version's, each reduced to one part: M
    and l at one bf16 ulp; acc over the plain l (the context they give;
    0 for the empty part, so an empty part must be exactly empty) at one
    bf16 ulp, its absolute part 2^-14 max |v|: ``k_gqa_split`` carries
    each f32 weight as two bf16 (p = hi + lo, 2^-17 of p), so a context
    near 0 keeps an error of ~2^-17 mean |v|. An l and acc off by one
    factor fail on l. Returns acc / l's max abs error."""
    import torch
    (gm, gl, ga), (wm, wl, wa) = (reduced_parts(*got),
                                  reduced_parts(*want))
    den = wl.clamp(min=1e-30)[..., None]
    ctx = dict(rtol=BF16_ULP["rtol"],
               atol=max(BF16_ULP["atol"], 2 ** -14 * v.abs().max().item()))
    for name, x, y, tol in (("m", gm, wm, BF16_ULP), ("l", gl, wl, BF16_ULP),
                            ("acc / l", ga / den, wa / den, ctx)):
        torch.testing.assert_close(x.float(), y.float(), **tol,
                                   msg=lambda e: f"{what} {name}: {e}")
    return (ga / den - wa / den).abs().max().item()


def moe_rank_plain(p, cfg, x, lo: int):
    """A rank's partial of an expert-parallel MoE layer, computed plainly,
    as its all-reduce takes it: the global routing of x, then, as
    ``moe_plain`` does, each of the rank's experts [lo, lo + its E) that
    a kept pair reached by ``torch.matmul``, summed per token in f32,
    plus the rank's columns of the shared expert through its rows of
    ``w_down`` → (B, S, d) f32."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import activation_fn, mlp_apply
    b, s, d = x.shape
    k, dt = cfg.moe.experts_per_token, x.dtype
    el = p["w_gate"].shape[0]
    act = activation_fn(cfg.activation)
    r = moe_mod.route(p, cfg, x, moe_mod.chunk_size(s))
    xf = x.reshape(b * s, d)
    ti, kp = r.top_i.reshape(-1, k), r.keep.reshape(-1, k)
    tw = r.top_w.reshape(-1, k).to(dt).to(torch.float32)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    mine = kp & (ti >= lo) & (ti < lo + el)
    for e in torch.unique(ti[mine]).tolist():
        rows, slots = ((ti == e) & kp).nonzero(as_tuple=True)
        j = e - lo
        h = (act(xf[rows] @ p["w_gate"][j].to(dt))
             * (xf[rows] @ p["w_up"][j].to(dt)))
        y[rows] += (h @ p["w_down"][j].to(dt)).to(torch.float32) \
            * tw[rows, slots][:, None]
    y = y.reshape(b, s, d)
    if cfg.moe.num_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg.activation).to(torch.float32)
    return y


class TeacherRoutes:
    """Around ``launch.serve.teacher_forced``: records the (experts, kept)
    of every ``models.moe.route`` call of the teacher-forced run, in call
    order, into ``record`` (a path; rank 0 writes it); with ``pin`` (a
    path of such a record) the run is repeated with each call's experts
    and kept pairs taken from it, its weights from its own probabilities
    at those experts (``RouteLog``'s pin), and those logits go to
    ``pinned`` (a path). Restores ``teacher_forced`` and ``route`` on
    exit."""

    def __init__(self, record: str, pin: str = "", pinned: str = "",
                 write: bool = True):
        self.record, self.pin, self.pinned, self.write = (record, pin,
                                                          pinned, write)

    def __enter__(self):
        import numpy as np
        import torch
        from repro_torch.launch import serve
        from repro_torch.models import moe
        self._tf, self._route = serve.teacher_forced, moe.route
        tf, route = self._tf, self._route

        def run(model, cfg, **kw):
            calls = []

            def rec(p, c, x, n):
                r = route(p, c, x, n)
                calls.append((r.top_i.cpu(), r.keep.cpu()))
                return r
            moe.route = rec
            try:
                out = tf(model, cfg, **kw)
            finally:
                moe.route = route
            if self.write:
                torch.save(calls, self.record)
            if not self.pin:
                return out
            first, i = torch.load(self.pin), [0]

            def pinned(p, c, x, n):
                r = route(p, c, x, n)
                top_i, keep = (t.to(r.top_i.device) for t in first[i[0]])
                i[0] += 1
                w = r.probs.gather(-1, top_i)
                return r._replace(top_i=top_i, keep=keep,
                                  top_w=w / w.sum(-1, keepdim=True))
            moe.route = pinned
            try:
                logits = tf(model, cfg, **kw)[2]
            finally:
                moe.route = route
            check(i[0] == len(first), f"pinned {i[0]} of {len(first)} "
                  f"routings")
            if self.write:
                np.save(self.pinned, logits)
            return out
        serve.teacher_forced = run
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve
        from repro_torch.models import moe
        serve.teacher_forced, moe.route = self._tf, self._route


def route_flips(a, b) -> int:
    """(layer call, batch row, token)s whose kept expert sets differ
    between two ``TeacherRoutes`` records."""
    n = 0
    for (ia, ka), (ib, kb) in zip(a, b):
        ea = ia.masked_fill(~ka, -1).sort(-1).values
        eb = ib.masked_fill(~kb, -1).sort(-1).values
        n += int((ea != eb).any(-1).sum())
    return n


def tp_worker(argv) -> int:
    """One rank of phase tp_serve under ``torchrun``: the serving launcher
    (``repro_torch.launch.serve.main(argv)``) with every #5 and #6 launch
    of the first decode step captured (the split or chunk kernel, with or
    without ``partials``, and each cross-rank ``k_merge``) and held to
    the plain versions afterwards, every MoE layer of that step captured
    at its all-reduce (the rank's partial) and held to ``moe_rank_plain``,
    and decode steps ``TP_PROFILED`` under the profiler; writes the
    rank's json beside ``--dump`` and, for a recurrent family, its shard
    of the state after the teacher-forced steps (``$TP_STATE_LEAF``,
    from ``TP_STATE``). Any failure raises: the rank, and so torchrun,
    exits non-zero."""
    import json as _json
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import Transformer
    rank = int(os.environ["RANK"])
    st = dict(decode=0, capture=False, prof=None, cache=None)
    caps, moe_caps, events = [], [], []

    def spy(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if st["capture"]:
                keep = (tuple(o.clone() for o in out)
                        if isinstance(out, tuple) else out.clone())
                caps.append((name, [x.clone() if torch.is_tensor(x) else x
                                    for x in a], dict(kw), keep))
            return out
        return run
    for name, attr in TP_FIRST.items():
        setattr(da, attr, spy(name, getattr(da, attr)))
    da._launch_merge = spy("k_merge", da._launch_merge)
    moe_apply = moe_mod.moe_apply

    def moe_spy(p, cfg, x, tp=None):
        if not st["capture"] or tp is None:
            return moe_apply(p, cfg, x, tp)
        seen = []

        def all_reduce(t):
            seen.append(t.clone())
            return type(tp).all_reduce(tp, t)
        tp.all_reduce = all_reduce
        try:
            out = moe_apply(p, cfg, x, tp)
        finally:
            del tp.all_reduce
        moe_caps.append((p, cfg, x.clone(), seen[0], tp.rank))
        return out
    moe_mod.moe_apply = moe_spy
    apply = Transformer.apply

    def traced(self, tokens, **kw):
        dec = kw.get("mode") == "decode"
        if dec:
            st["decode"] += 1
            st["capture"] = st["decode"] == 1
            if st["decode"] in TP_PROFILED:
                torch.cuda.synchronize()
                st["prof"] = profile(activities=[ProfilerActivity.CUDA])
                st["prof"].__enter__()
        out = apply(self, tokens, **kw)
        st["cache"] = out[1]
        if dec:
            st["capture"] = False
            if st["prof"] is not None:
                torch.cuda.synchronize()
                st["prof"].__exit__(None, None, None)
                events.extend((e.name, e.time_range.elapsed_us())
                              for e in st["prof"].events()
                              if e.device_type == DeviceType.CUDA)
                st["prof"] = None
        return out
    Transformer.apply = traced
    ops.reset_kernel_launches()
    dump = argv[argv.index("--dump") + 1]
    with TeacherRoutes(f"{dump}.routes.pt", os.environ.get(
            "TP_PIN_ROUTES", ""), f"{dump}.pinned.npy", write=rank == 0):
        serve.main(argv)
    if os.environ.get("TP_STATE_LEAF"):
        from repro_torch.launch.sharding import local
        group, leaf = os.environ["TP_STATE_LEAF"].split("/")
        torch.save(local(st["cache"][group][leaf]).cpu(),
                   f"{dump}.state.rank{rank}.pt")
    st["cache"] = None
    launches = dict(gqa_decode=da.gqa_decode.launches,
                    partial_launches=da.gqa_decode.partial_launches,
                    mla_decode=da.mla_decode.launches,
                    mla_partial_launches=da.mla_decode.partial_launches,
                    merge_partials=da.merge_partials.launches,
                    routes=dict(da.gqa_decode.route_launches),
                    mla_routes=dict(da.mla_decode.route_launches),
                    decode_steps=st["decode"])
    held = dict(k_gqa_split=0, k_partial=0, k_mla=0, k_partial_mla=0,
                k_merge=0, partials=0, max_abs_err=0.0, shapes=[],
                bound_us={}, valid_rows=None)

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)
    for name, a, kw, out in caps:
        partials = bool(kw.get("partials"))
        if name == "k_merge":
            m, l, acc, dtype = a
            want = ref.merge_partials_ref(m, l, acc, dtype)
            got = out
            moved = nbytes(m, l, acc, out)
            key = "k_merge_partials"
        else:
            mla = name in ("k_mla", "k_partial_mla")
            if mla:
                q, qr, k, kr, valid = a
                plain = dict(scale=kw["scale"])
                fn = (ref.mla_decode_partials_ref if partials
                      else ref.mla_decode_attention_ref)
                operands, v = (q, qr, k, kr, valid), k
                # a row: its ckv and krope; the queries: q_abs and q_rope
                row_bytes = (k.shape[-1] + kr.shape[-1]) * k.element_size()
                q_bytes = nbytes(q, qr)
            else:
                q, k, v, valid = a
                plain = dict(scale=kw["scale"], softcap=kw["softcap"],
                             q_per_kv=kw["q_per_kv"])
                fn = (ref.decode_partials_ref if partials
                      else ref.decode_attention_ref)
                operands = (q, k, v, valid)
                row_bytes = 2 * k.shape[2] * k.shape[3] * k.element_size()
                q_bytes = nbytes(q)
            rows = int(valid.sum())
            if partials:
                held["partials"] += 1
                got = want = None
                err = hold_parts(out, fn(*operands, **plain), v,
                                 f"rank {rank} {name}")
                if held["valid_rows"] is None:
                    held["valid_rows"] = valid.sum(1).tolist()
            else:
                got, want = out, fn(*operands, **plain)
                # the merge's own launch: a sequence with no valid row
                # takes every row (the mean of the values)
                rows = int(torch.where(valid.any(1), valid.sum(1),
                                       valid.shape[1]).sum())
            # the bound reads the mask, the valid cache rows and, where
            # there is one, the queries, and writes the output: the
            # partials, or the merged context
            moved = (nbytes(valid) + (q_bytes if rows else 0)
                     + rows * row_bytes
                     + (nbytes(*out) if partials else nbytes(out)))
            key = name
            shape = [list(q.shape), list(k.shape), partials]
            if shape not in held["shapes"]:
                held["shapes"].append(shape)
        held[name] += 1
        held["bound_us"][key] = moved / HBM_BYTES_PER_S * 1e6
        if got is not None:
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(
                got.float(), want.float(), **BF16_ULP,
                msg=lambda m: f"rank {rank} {name}: {m}")
        held["max_abs_err"] = max(held["max_abs_err"], err)
    held["moe_layers"], held["moe_max_abs_err"] = len(moe_caps), 0.0
    for j, (p, cfg, x, part, r) in enumerate(moe_caps):
        want = moe_rank_plain(p, cfg, x, r * p["w_gate"].shape[0])
        torch.testing.assert_close(
            part, want, **BF16_ULP,
            msg=lambda m: f"rank {rank} moe layer {j}: {m}")
        held["moe_max_abs_err"] = max(held["moe_max_abs_err"],
                                      (part - want).abs().max().item())
    us = {}
    for ename, t in events:
        key = ("k_merge_partials" if "k_merge" in ename and "false>" in ename
               else next((k for k in ("k_gqa_split", "k_mla", "k_partial",
                                      "k_merge") if k in ename), None))
        if key:
            n, tot = us.get(key, (0, 0.0))
            us[key] = (n + 1, tot + t)
    with open(f"{dump}.rank{rank}.json", "w") as f:
        _json.dump(dict(rank=rank, launches=launches, held=held, profile={
            k: dict(launches=n, device_us=tot, device_us_per_launch=tot / n)
            for k, (n, tot) in us.items()}), f)
    return 0


def phase_tp_serve(card):
    """The serving launcher on the model axis (``python -m
    repro_torch.launch.serve --model K`` under torchrun, ``tp_worker`` in
    each rank): for each of ``TP_CASES``, one process of the same seed
    and the ranks on this card (gloo); their teacher-forced logits within
    ``TP_BOUND`` (relative L2 a step), every #5 or #6 launch of one
    decode step, every cross-rank merge and every MoE layer's partial
    held on every rank, the launches counted over the run, each rank's
    #5 or #6 device µs by the profiler. An MoE model's bf16 router moves
    experts at near ties (ROADMAP, Queue 3: MoE routing flips), so its
    mesh also runs the teacher-forced steps with the one process's
    experts pinned (``TeacherRoutes``): those logits are held to
    ``TP_BOUND``, and the unpinned ones too unless an expert set
    flipped (each flip counted and printed), as the serve phases hold
    the kernel step against the plain one. A recurrent family's state
    after the teacher-forced steps (``TP_STATE``) is held on every rank
    to the one process's heads, relative L2 ``TP_BOUND`` a layer. A case
    not held (``TP_CASES``' last field) prints its numbers only. The
    runs' logits, routings and states go to a temporary directory, each
    case's removed once it is read (they outgrow ``chiprun_out``)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    out_dir = tempfile.mkdtemp(prefix="tp-serve-")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    res = {}
    for arch, k, max_len, layers, held_case in TP_CASES:
        tag = arch if layers is None else f"{arch}_l{layers}"
        tp_npz = os.path.join(out_dir, f"{tag}_model{k}.npz")
        one_npz = os.path.join(out_dir, f"{tag}_one.npz")
        one_routes = f"{one_npz}.routes.pt"
        cfg = get_config(arch)
        args = [*TP_ARGS, "--max-len", str(max_len), "--arch", arch]
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
            args += ["--layers", str(layers)]
        state_leaf = TP_STATE.get(cfg.family)
        # the launcher in this process, no mesh; its teacher-forced
        # routing recorded, and the cache of its last step kept
        t0 = time.perf_counter()
        last, apply = {}, Transformer.apply

        def keep(self, tokens, **kw):
            out = apply(self, tokens, **kw)
            last["cache"] = out[1]
            return out
        Transformer.apply = keep
        try:
            with TeacherRoutes(one_routes):
                serve.main([*args, "--dump", one_npz])
        finally:
            Transformer.apply = apply
        one_state = (None if state_leaf is None else
                     last["cache"][state_leaf[0]][state_leaf[1]].cpu())
        last.clear()
        free_card()
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(k), os.path.join(HERE, "chip_smoke.py"),
             "--tp-worker", *args, "--model", str(k), "--dump", tp_npz],
            capture_output=True, text=True, timeout=600, cwd=HERE,
            env=dict(env, TP_PIN_ROUTES=one_routes if cfg.moe else "",
                     TP_STATE_LEAF="/".join(state_leaf or ())))
        t_mesh = time.perf_counter() - t0
        check(run.returncode == 0, f"tp_serve {tag} model {k}: exit "
              f"{run.returncode}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
        # each rank's state shard: its heads of the one process's (1, K
        # mesh: rank r is model rank r), relative L2 a layer
        state_l2 = None
        if state_leaf is not None:
            state_l2 = []
            heads = one_state.shape[2]
            for r in range(k):
                got = torch.load(f"{tp_npz}.state.rank{r}.pt")
                nh = got.shape[2]
                lo = r * nh if nh < heads else 0
                want = one_state[:, :, lo:lo + nh]
                check(got.shape == want.shape,
                      f"tp_serve {tag} rank {r}: state {got.shape}, heads "
                      f"of {one_state.shape}")
                state_l2.append(((got - want).flatten(1).norm(dim=1)
                                 / want.flatten(1).norm(dim=1)).tolist())
        one_state = None
        check(f"[ranks] world {k}, backend gloo" in run.stdout,
              f"tp_serve {tag}: {run.stdout[-1000:]}")

        def rel_l2(got, want):
            return [float(np.linalg.norm(x - y) / np.linalg.norm(y))
                    for x, y in zip(got, want)]
        with np.load(tp_npz) as a, np.load(one_npz) as b:
            steps = rel_l2(a["logits"], b["logits"])
            agree = float((a["logits"].argmax(-1)
                           == b["logits"].argmax(-1)).mean())
            tokens_equal = float((a["tokens"] == b["tokens"]).mean())
            pinned = (rel_l2(np.load(f"{tp_npz}.pinned.npy"), b["logits"])
                      if cfg.moe else None)
        flips = (route_flips(torch.load(one_routes),
                             torch.load(f"{tp_npz}.routes.pt"))
                 if cfg.moe else 0)
        state_max = (None if state_l2 is None
                     else max(max(r) for r in state_l2))
        if held_case:
            check(pinned is None or max(pinned) <= TP_BOUND,
                  f"tp_serve {tag}: teacher-forced logits, experts pinned, "
                  f"rel L2 {pinned} > {TP_BOUND}")
            check(max(steps) <= TP_BOUND or flips,
                  f"tp_serve {tag}: teacher-forced logits rel L2 {steps} > "
                  f"{TP_BOUND} with no routing flip")
            check(state_max is None or state_max <= TP_BOUND,
                  f"tp_serve {tag}: {state_leaf} shards' rel L2 a layer by "
                  f"rank {state_l2} > {TP_BOUND}")
        ranks = []
        for r in range(k):
            with open(f"{tp_npz}.rank{r}.json") as f:
                ranks.append(json.load(f))
        layers = attn_layers(cfg)
        mla = cfg.attn_type == "mla"
        # the latent cache splits by its sequence whatever the heads
        sharded = layers > 0 and (mla or cfg.num_kv_heads % k != 0)
        kernel, first, partial_key = (
            ("mla_decode", "k_mla", "mla_partial_launches") if mla else
            ("gqa_decode", "k_gqa_split", "partial_launches"))
        other = "gqa_decode" if mla else "mla_decode"
        moe_layers = (0 if cfg.moe is None
                      else cfg.num_layers - cfg.moe.first_dense_layers)
        for rk in ranks:
            ln, held = rk["launches"], rk["held"]
            want = layers * ln["decode_steps"]
            check(ln[kernel] == want and ln[other] == 0
                  and ln[partial_key] == (want if sharded else 0)
                  and ln["merge_partials"] == (want if sharded else 0),
                  f"tp_serve {tag} rank {rk['rank']}: launches {ln}, "
                  f"{want} expected")
            firsts = (held["k_mla"] + held["k_partial_mla"] if mla
                      else held["k_gqa_split"] + held["k_partial"])
            check(firsts == layers
                  and held["k_merge"] == (layers if sharded else 0)
                  and held["moe_layers"] == moe_layers,
                  f"tp_serve {tag} rank {rk['rank']}: held {held}")
            check(not sharded or held["valid_rows"] is not None,
                  f"tp_serve {tag} rank {rk['rank']}: no partials held")
            traced = rk["profile"].get(first)
            check(layers == 0 and traced is None
                  or traced is not None and traced["launches"] ==
                  layers * len(TP_PROFILED),
                  f"tp_serve {tag} rank {rk['rank']}: traced "
                  f"{rk['profile']}")
        # the held step's valid rows, by rank and sequence: a sharded
        # cache must merge valid parts of two or more ranks
        rows = [rk["held"]["valid_rows"] for rk in ranks]
        check(not sharded or max(sum(r[i] > 0 for r in rows)
                                 for i in range(len(rows[0]))) >= 2,
              f"tp_serve {tag}: valid rows by rank {rows} on one rank")
        kernel = kernel if layers else None     # RWKV6 runs no kernel
        res[tag] = dict(
            arch=arch, model=k, layers=cfg.num_layers, attn_layers=layers,
            kernel=kernel, sequence_sharded=sharded, held=held_case,
            max_len=max_len, valid_rows=rows,
            rel_l2=steps, rel_l2_pinned=pinned, routing_flips=flips,
            state_rel_l2=state_l2, state_max_rel_l2=state_max,
            argmax_agree=agree, tokens_equal=tokens_equal,
            mesh_s=t_mesh, one_process_s=t_one, bound=TP_BOUND,
            ranks=ranks,
            launches=sum(rk["launches"][kernel] for rk in ranks
                         if kernel),
            partial_launches=sum(rk["launches"][partial_key]
                                 for rk in ranks),
            merge_launches=sum(rk["launches"]["merge_partials"]
                               for rk in ranks),
            max_abs_err=max(rk["held"]["max_abs_err"] for rk in ranks),
            moe_layers_held=sum(rk["held"]["moe_layers"] for rk in ranks),
            moe_max_abs_err=max(rk["held"]["moe_max_abs_err"]
                                for rk in ranks),
            bound_us={kern: [rk["held"]["bound_us"][kern] for rk in ranks]
                      for kern in ranks[0]["held"]["bound_us"]},
            device_us_per_launch={
                kern: [rk["profile"][kern]["device_us_per_launch"]
                       for rk in ranks if kern in rk["profile"]]
                for kern in ("k_gqa_split", "k_mla", "k_partial", "k_merge",
                             "k_merge_partials")})
        r = res[tag]
        moe = (f", MoE layers held {r['moe_layers_held']} (max abs "
               f"err {r['moe_max_abs_err']:.3e})" if moe_layers
               else "")
        pin = ("" if pinned is None else
               f", experts pinned {[f'{x:.3e}' for x in pinned]} "
               f"({flips} (layer, slot, token) expert sets flipped "
               f"unpinned)")
        state = ("" if state_l2 is None else
                 f", {'/'.join(state_leaf)} shards' rel L2 max a layer by "
                 f"rank {[f'{max(x):.3e}' for x in state_l2]}")
        kern = ("no decode kernel" if kernel is None else
                f"{kernel} launches {r['launches']} (partials "
                f"{r['partial_launches']}, cross-rank merges "
                f"{r['merge_launches']}), held max abs err "
                f"{r['max_abs_err']:.3e}")
        print(f"  tp_serve {tag} (1, {k}), {cfg.num_layers} layers, "
              f"{max_len} cache rows"
              + (f" by sequence (held step's valid rows by rank {rows})"
                 if sharded else "") + ": logits rel L2 "
              f"a step {[f'{x:.3e}' for x in steps]}{pin}{state} ("
              + (f"bound {TP_BOUND}" if held_case else "not held")
              + f"), argmax agree {agree:.3f}, tokens equal "
              f"{tokens_equal:.3f}; {kern}{moe}; device us a launch "
              f"by rank {r['device_us_per_launch']}, bound (bytes) "
              f"{r['bound_us']}; mesh {t_mesh:.1f} s, "
              f"one process {t_one:.1f} s [{card}]", flush=True)
        for line in run.stdout.splitlines():
            if line.startswith("[serve]") or line.startswith("[ranks]"):
                print(f"    {line}", flush=True)
        for f in os.listdir(out_dir):
            if f.startswith(f"{tag}_"):
                os.remove(os.path.join(out_dir, f))
    shutil.rmtree(out_dir, ignore_errors=True)
    print("phase tp_serve: ok", flush=True)
    return res


# ---------------------------------------------------------------- tp_train
# Training on the model axis: the training launcher under torchrun, 4
# ranks on this card, FSDP2 over data × tensor parallelism over model.
TRAIN_TP_MESH = (2, 2)
TRAIN_TP_ARGS = ("--arch", "deepseek-7b", "--full", "--layers",
                 str(MESH_LAYERS), "--dtype", "float32", "--remat",
                 "--steps", str(MESH_STEPS), "--batch", "4", "--seq",
                 str(TRAIN_SEQ), "--model", str(TRAIN_TP_MESH[1]))
TRAIN_TP_LOSS = 1e-5            # rtol of a step's loss
TRAIN_TP_UPDATE = 1e-2          # ‖p_mesh − p_one‖ / ‖p_one − p_init‖


def tp_train_config():
    """``TRAIN_TP_ARGS``' model: DeepSeek-LLM-7B at full width, cut to
    ``MESH_LAYERS``, f32 activations."""
    from repro_torch.configs.registry import get_config
    return get_config("deepseek-7b").replace(num_layers=MESH_LAYERS,
                                            dtype="float32")


def train_worker(argv) -> int:
    """One rank of phase tp_train under ``torchrun``: rank 0 first runs
    the launcher's steps in one process on the card (the same seed,
    config, batches and hyperparameters) and keeps its losses, its
    parameters after the last step and each leaf's movement on the host;
    then every rank runs ``repro_torch.launch.train.main(argv)``, each
    step timed and its model-axis collective bytes recorded
    (``TensorParallel.moved``); after it every parameter is gathered whole
    (``full_tensor``) and rank 0 measures it against its one-process
    leaf. Writes ``<out>.rank<r>.json``; any failure raises."""
    import faulthandler
    import json as _json
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.training import trainer
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = argv[argv.index("--out") + 1]
    argv = argv[:argv.index("--out")]
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local % torch.cuda.device_count())
    ref = {}
    if rank == 0:
        ref = _one_process_train()
    held = dict(rank=rank, steps=[], losses=[], bytes=[])
    st = {}
    shard = trainer.fsdp_shard

    def keep(model, mesh):
        st["model"] = shard(model, mesh)
        return st["model"]
    trainer.fsdp_shard = keep
    make = launch_train.make_train_step

    def timed(*a, **kw):
        step = make(*a, **kw)

        def run(model, opt, batch, i):
            model.tp.moved = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, batch, i)
            held["losses"].append(float(m["loss"]))
            torch.cuda.synchronize()
            held["steps"].append(time.perf_counter() - t0)
            held["bytes"].append(dict(model.tp.moved))
            model.tp.moved = None
            return model, opt, m
        return run
    launch_train.make_train_step = timed
    destroy = dist.destroy_process_group
    dist.destroy_process_group = lambda *a, **kw: None
    ops.reset_kernel_launches()
    try:
        launch_train.main(argv)
    finally:
        dist.destroy_process_group = destroy
        trainer.fsdp_shard = shard
        launch_train.make_train_step = make
    held["kernel_launches"] = {k: v for k, v in
                               ops.kernel_launches().items() if v}
    from repro_torch.launch.sharding import gather_whole
    worst = {}
    with torch.no_grad():
        for name, p in st.pop("model").named_parameters():
            full = gather_whole(p)
            if rank == 0:
                want = ref["final"].pop(name).to(full.device)
                d = float((full - want).norm())
                worst[name] = (d / ref["moved"][name] if ref["moved"][name]
                               else 0.0 if d == 0 else float("inf"))
                del want
            del full
    if rank == 0:
        held.update(one_losses=ref["losses"], one_steps=ref["steps"],
                    update_rel_l2=worst)
    dist.barrier()
    destroy()
    with open(f"{out}.rank{rank}.json", "w") as f:
        _json.dump(held, f)
    return 0


def _one_process_train():
    """``TRAIN_TP_ARGS``' run in one process on the card, with no mesh:
    its config, seed-0 weights, batches (the launcher's ``lm_batches``,
    seed 0) and hyperparameters (its default lr, warm-up and remat) →
    losses, step seconds, final parameters on the host and ‖final −
    initial‖ a leaf."""
    import torch
    from repro_torch.models.transformer import init_model
    from repro_torch.training import (TrainHParams, adamw_init,
                                      make_train_step)
    cfg = tp_train_config()
    model = init_model(cfg, seed=0, device="cuda")
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in model.named_parameters()}
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, TrainHParams(
        base_lr=3e-4, warmup=max(MESH_STEPS // 10, 1),
        total_steps=MESH_STEPS, remat=True))
    losses, secs = [], []
    for i, b in enumerate(lm_batches_for(cfg, 4, TRAIN_SEQ, MESH_STEPS,
                                         seed=0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b, i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    final = {k: p.detach().to("cpu", copy=True)
             for k, p in model.named_parameters()}
    moved = {k: float((final[k] - init.pop(k)).norm()) for k in final}
    del model, opt, step
    free_card()
    return dict(losses=losses, steps=secs, final=final, moved=moved)


def phase_tp_train(card):
    """The training launcher on the model axis (``python -m
    repro_torch.launch.train --model 2`` under torchrun, ``train_worker``
    in each rank, 4 ranks on this card over gloo): the (2, 2) mesh's
    losses and parameters after step 3 held to rank 0's one-process run,
    each rank's model-axis collective bytes a step held to the dry run's
    count, the step times printed."""
    import shutil
    import statistics
    import tempfile
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    cfg = tp_train_config()
    out_dir = tempfile.mkdtemp(prefix="tp-train-")
    out = os.path.join(out_dir, "tp_train")
    world = TRAIN_TP_MESH[0] * TRAIN_TP_MESH[1]
    free_card()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), os.path.join(HERE, "chip_smoke.py"),
         "--train-worker", *TRAIN_TP_ARGS, "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    try:
        # the dry run on the host while the ranks start and train
        t1 = time.perf_counter()
        rec = dryrun.lower_combo(
            "deepseek-7b", ShapeSpec("train_4k", TRAIN_SEQ, 4, "train"),
            mesh=make_abstract_mesh(TRAIN_TP_MESH, ("data", "model")),
            cfg=cfg, verbose=False)
        t_dry = time.perf_counter() - t1
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t_run = time.perf_counter() - t0
    want = {op: v for op, v in
            rec["model_axis_collective_bytes_per_device"].items() if v}
    check(want.get("all-reduce", 0) > 0, f"tp_train: dry run {want}")
    check(proc.returncode == 0, f"tp_train: exit {proc.returncode}\n"
          f"{stdout[-3000:]}\n{stderr[-5000:]}")
    check("[ranks] world 4, backend gloo" in stdout
          and "mesh=(data 2, model 2) fsdp x tp" in stdout,
          f"tp_train: {stdout[-2000:]}")
    ranks = []
    for r in range(world):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    losses, one = r0["losses"], r0["one_losses"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, one)]
    worst = max(r0["update_rel_l2"], key=r0["update_rel_l2"].get)
    upd = r0["update_rel_l2"][worst]
    check(len(losses) == MESH_STEPS and max(loss_rel) <= TRAIN_TP_LOSS,
          f"tp_train: losses {losses} vs one process {one}")
    check(upd <= TRAIN_TP_UPDATE,
          f"tp_train: parameters after step {MESH_STEPS}: {worst} differs "
          f"by {upd:.3e} of its update > {TRAIN_TP_UPDATE}")
    for rk in ranks:
        check(not rk["kernel_launches"],
              f"tp_train rank {rk['rank']}: kernels {rk['kernel_launches']}")
        for i, got in enumerate(rk["bytes"]):
            got = {op: v for op, v in got.items() if v}
            check(got == want, f"tp_train rank {rk['rank']} step {i}: "
                  f"model-axis bytes {got} != dry run's {want}")
    res = dict(mesh=list(TRAIN_TP_MESH), layers=MESH_LAYERS, losses=losses,
               one_process_losses=one, loss_rel=loss_rel,
               update_rel_l2_worst=[worst, upd],
               update_rel_l2=r0["update_rel_l2"],
               step_s=r0["steps"], one_process_step_s=r0["one_steps"],
               step_s_median=statistics.median(r0["steps"][1:]),
               model_axis_bytes=want,
               collective_bytes=rec["collective_bytes_per_device"],
               dryrun_s=t_dry, run_s=t_run, bound_loss=TRAIN_TP_LOSS,
               bound_update=TRAIN_TP_UPDATE)
    print(f"phase tp_train: ok  deepseek-7b {MESH_LAYERS} layers f32 at "
          f"(2, 2), 4 x {TRAIN_SEQ}: losses {losses} vs one process {one} "
          f"(rel {[f'{x:.2e}' for x in loss_rel]}, bound {TRAIN_TP_LOSS}); "
          f"params after step {MESH_STEPS}: worst {worst} {upd:.3e} of its "
          f"update (bound {TRAIN_TP_UPDATE}); model-axis bytes a step "
          f"{want} on every rank = dry run's; FSDP2 + model axis "
          f"{rec['collective_bytes_per_device']}; step s {r0['steps']} "
          f"(median of 2-3 {res['step_s_median']:.3f}), one process "
          f"{r0['one_steps']}; torchrun {t_run:.1f} s, dry run "
          f"{t_dry:.1f} s  [{card}]", flush=True)
    for line in stdout.splitlines():
        if line.startswith(("[train]", "[ranks]", "step ")):
            print(f"    {line}", flush=True)
    return res


# name: (K slabs or None for no mesh, double_buffer, index dtype, oracle)
SHARD_MGRS = {"a": (None, False, "float32", None),
              "b": (1, True, "float32", "a"),
              "c": (2, None, "float32", "a"),
              "d": (4, None, "float32", "a"),
              "e0": (None, False, "int8", None),
              "e": (4, None, "int8", "e0")}
SHARD_TICKS = 3
TRACE_PAD = 64          # sleeps heading a trace, for the events it loses
DVM_ROWS, DVM_BLOCK, DVM_QUERIES = 16 * N, N, 8


class SlabLaunches:
    """Inside the context, every launch of #1 and #3 by the wrappers of
    ``kernels.similarity`` (their ``_launch`` and ``_launch_scan``, so the
    wrappers' launch counts stay theirs) is captured with its operands,
    one a slab when sharded; ``hold()`` then holds each to its plain
    version and clears the capture."""

    def __enter__(self):
        from repro_torch.kernels import similarity
        self.sim, self.fused, self.scans = similarity, [], []
        self.f0, self.s0 = similarity._launch, similarity._launch_scan

        def fused(q, x, v, t, *, tau, n_topk):
            self.fused.append((q, x, v, t, n_topk, tau))
            return self.f0(q, x, v, t, tau=tau, n_topk=n_topk)

        def scan(q, x, v, *, tau):
            out = self.s0(q, x, v, tau=tau)
            self.scans.append((q, x, v, tau, out))
            return out
        similarity._launch, similarity._launch_scan = fused, scan
        return self

    def __exit__(self, *exc):
        self.sim._launch, self.sim._launch_scan = self.f0, self.s0

    def hold(self, label, totals):
        """Each captured launch against its plain version: #1 by
        ``hold_fused`` (a stage-1 launch's dummy zero target undrawn), #3
        by ``_scan_check``; adds to ``totals``' counts, shapes and error."""
        from repro_torch.kernels import ref
        for j, (q, x, v, t, k, tau) in enumerate(self.fused):
            err, _, _ = hold_fused(f"{label} #1 launch {j}", q, x, v, t, k,
                                   draws=bool(t.any()), tau=tau)
            totals["fused"] += 1
            totals["err"] = max(totals["err"], err)
            totals["shapes"].add(("#1", *q.shape, x.shape[1], t.shape[-1]))
        for j, (q, x, v, tau, out) in enumerate(self.scans):
            want = ref.similarity_scan_stack_ref(q, x, v, tau=tau)
            err = _scan_check(f"{label} #3 launch {j}", out, want,
                              ref.as_valid_mask(v, x.shape[1])[:, None, :],
                              tau=tau)
            totals["scan"] += 1
            totals["err"] = max(totals["err"], err)
            totals["shapes"].add(("#3", *q.shape, x.shape[1]))
        self.fused, self.scans = [], []


def same_results(got, want, label):
    check(len(got) == len(want), f"{label}: {len(got)} != {len(want)}")
    for j, (x, y) in enumerate(zip(got, want)):
        check(x.draws.tolist() == y.draws.tolist()
              and x.frame_ids.tolist() == y.frame_ids.tolist()
              and x.n_drawn == y.n_drawn,
              f"{label} query {j}: draws {x.draws} vs {y.draws}, frames "
              f"{x.frame_ids} vs {y.frame_ids}")


def same_fronts(mgr, oracle, label):
    """Each session's front rows bit-equal to the oracle's (compared by
    session: the slots differ at K > 1)."""
    import torch
    names = ("emb", "members", "member_count", "index_frame") + (
        ("emb_scale",) if mgr.cfg.index_dtype == "int8" else ())
    for sid in mgr.sessions:
        for name in names:
            a = mgr.arena.slot_view(name, mgr[sid].memory.slot)
            b = oracle.arena.slot_view(name, oracle[sid].memory.slot)
            check(torch.equal(a, b), f"{label}: session {sid} {name}")


def shard_group(mgr, fused=True, seed=9, sids=range(S)):
    """One akr group of 8 queries a session of ``sids`` (``fused=False``:
    the dense scan)."""
    from repro_torch.core.queryplan import QuerySpec
    qe = unit_queries_np(8 * len(sids), D, seed)
    return mgr.execute(mgr.plan([QuerySpec(sid=sids[j // 8],
                                           embedding=qe[j])
                                 for j in range(8 * len(sids))]),
                       fused=fused)


def check_stream_order(mgr, label):
    """A fused launch queued behind a ~100 ms sleep on the query stream,
    then two double-buffered flushes that rewrite row 0 of every session
    with its first query (the second flush writes the set the queued
    launch reads): the launch's answer must be the one taken before the
    flushes, bit for bit. Without the flush waiting on the swap's event
    the second flush would land first."""
    import numpy as np
    import torch
    from repro_torch.core.memory import arena_fused_retrieve
    a = mgr.arena
    q = torch.from_numpy(unit_queries_np(S * Q, D, 17).reshape(S, Q, D)
                         ).cuda()
    tg = torch.rand((S, Q, T), generator=torch.Generator("cuda")
                    .manual_seed(3), device="cuda")
    lanes = mgr.scan_lanes(sorted(mgr.sessions))
    check(None not in lanes, f"{label}: a free slot")
    ql = torch.stack([q[s] for s in lanes])
    tl = torch.stack([tg[s] for s in lanes])
    want = [x.cpu() for x in arena_fused_retrieve(a, ql, tl, TAU, K)]
    torch.cuda._sleep(200_000_000)
    queued = arena_fused_retrieve(a, ql, tl, TAU, K)
    for flush in range(2):
        with a.deferred_appends():
            for sid in sorted(mgr.sessions):
                m = mgr[sid].memory
                row = q[sid, flush].cpu().numpy()[None]
                a.append(m.slot, m.head, row,
                         np.zeros((1, m.member_cap), np.int32),
                         np.ones((1,), np.int32),
                         np.asarray([flush], np.int32), m.window)
    got = [x.cpu() for x in queued]
    check(all(torch.equal(x, y) for x, y in zip(got, want)),
          f"{label}: a launch queued before the flushes saw their rows")
    after = arena_fused_retrieve(a, ql, tl, TAU, K)
    check(not torch.equal(after.topk_i.cpu(), want[3]),
          f"{label}: the rewritten rows do not show after the flushes")


def shard_tier(dev, card):
    """Phase 13's tier configuration on a 4-slab arena against the
    unsharded tier manager: 16 sessions filled by ``insert_batch`` with 2
    × 128 rows each (``tier_rows_np``; every session consolidates), then
    the akr, sampling and topk groups, two-stage; equal results, every
    #1 launch held."""
    import numpy as np
    from repro_torch.core.session import SessionManager, VenusConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_memory_mesh
    cfg = VenusConfig(memory_capacity=128, eviction="consolidate",
                      coarse_capacity=32, coarse_block=16, coarse_topb=4)
    mgrs = {"oracle": SessionManager(cfg, None, D, device="cuda"),
            "k4": SessionManager(cfg, None, D,
                                 mesh=make_memory_mesh(4, [dev] * 4))}
    n_rows = 2 * cfg.memory_capacity
    data = [tier_rows_np(sid, n_rows, D) for sid in range(S)]
    for m in mgrs.values():
        for sid in range(S):
            m.create_session(sid)
        for lo in range(0, n_rows, 32):
            r = np.arange(lo, lo + 32)
            with m.arena.deferred_appends():
                for sid in range(S):
                    m[sid].memory.insert_batch(
                        data[sid][r], scene_ids=list(r // TIER_SCENE_ROWS),
                        index_frames=4 * r + 1,
                        member_lists=[range(4 * i, 4 * i + 4) for i in r])
        for sid in range(S):
            m[sid].stats["frames_seen"] = 4 * n_rows
        check(m.arena.has_consolidated(), "shard tier: no history")
    totals = dict(fused=0, scan=0, err=0.0, shapes=set())
    res = {}
    for name, m in mgrs.items():
        m.reset_io_stats(include_memories=False)
        ops.reset_scan_counts()
        with SlabLaunches() as cap:
            res[name], _ = run_queries(m, S, D, coarse=True, text=False)
        cap.hold(f"shard tier {name}", totals)
        c = ops.scan_counts()
        check(m.io_stats["two_stage_groups"] == 3
              and m.io_stats["stack_rebuilds"] == 0,
              f"shard tier {name}: {m.io_stats}")
        if name == "k4":
            check(m.io_stats["sharded_group_scans"] == 3
                  and c["sharded_stack_launches"] == 3,
                  f"shard tier k4: stage 1 once a slab: {c}")
    for g in res["oracle"]:
        same_results(res["k4"][g], res["oracle"][g], f"shard tier {g}")
    print(f"phase shard[tier]: ok  {S} sessions x {n_rows} rows, 3 "
          f"two-stage groups equal to the unsharded tier manager's; "
          f"{totals['fused']} #1 launches held (max abs err "
          f"{totals['err']:.3e})  [{card}]", flush=True)
    return dict(held=totals["fused"], max_abs_err=totals["err"])


def shard_edges(worlds, card):
    """The edge slab shapes on a 4-slab arena (double-buffered, as a mesh
    makes it) against an unsharded manager with the same sessions, each
    step one tick of 64 frames of the main worlds: 3 sessions (S = 4, so
    S/K = 1, and slab 3 one virgin slot: all-invalid); 2 more (a block of
    growth, S = 8: slab 3 two virgin slots); the fifth closed (slab 2 a
    released and a virgin slot). After each step the fronts are
    bit-equal, an akr group and a ``fused=False`` group give equal
    answers, and every #1 and #3 launch (one a slab) is held to its
    plain version; among them a one-slot slab and an all-invalid slab of
    each kernel."""
    import torch
    from repro_torch.core.session import SessionManager, VenusConfig
    from repro_torch.data.video import PixelEmbedder
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_memory_mesh
    dev = torch.device("cuda", 0)
    mgrs = {"oracle": SessionManager(VenusConfig(), PixelEmbedder(dim=D), D,
                                     device="cuda"),
            "k4": SessionManager(VenusConfig(), PixelEmbedder(dim=D), D,
                                 mesh=make_memory_mesh(4, [dev] * 4))}
    totals = dict(fused=0, scan=0, err=0.0, shapes=set())
    seen = set()
    steps = (("3 sessions", (0, 1, 2), (), 4), ("5 sessions", (3, 4), (), 8),
             ("the fifth closed", (), (4,), 8))
    for t, (label, opened, closed, n_slots) in enumerate(steps):
        for m in mgrs.values():
            for sid in opened:
                m.create_session(sid)
            for sid in closed:
                m.close_session(sid)
            live = sorted(m.sessions)
            m.ingest_tick({sid: worlds[sid].frames[64 * t:64 * (t + 1)]
                           for sid in live})
            m.flush()
        a = mgrs["k4"].arena
        check(a.n_sessions == n_slots, f"shard edges ({label}): "
              f"{a.n_sessions} slots, free {a.free_slots}, virgin "
              f"{a.virgin_slots}")
        same_fronts(mgrs["k4"], mgrs["oracle"], f"shard edges ({label})")
        res = {}
        for name, m in mgrs.items():
            with SlabLaunches() as cap:
                res[name] = [shard_group(m, fused=f, seed=60 + t, sids=live)
                             for f in (True, False)]
            if name == "k4":
                for kern, launches in (("#1", cap.fused), ("#3", cap.scans)):
                    for q, x, v, *_ in launches:
                        if q.shape[0] == 1:
                            seen.add((kern, "one slot"))
                        if not bool(ref.as_valid_mask(v, x.shape[1]).any()):
                            seen.add((kern, "all-invalid"))
            cap.hold(f"shard edges ({label}) {name}", totals)
        for f, group in enumerate(("akr", "dense")):
            same_results(res["k4"][f], res["oracle"][f],
                         f"shard edges ({label}) {group}")
    want = {(k, e) for k in ("#1", "#3") for e in ("one slot", "all-invalid")}
    check(seen == want, f"shard edges: slab shapes launched {sorted(seen)}")
    print(f"phase shard[edges]: ok  4 slabs of 1 and 2 slots, virgin and "
          f"released slots, all-invalid slabs: {totals['fused']} #1 and "
          f"{totals['scan']} #3 launches held (max abs err "
          f"{totals['err']:.3e})  [{card}]", flush=True)
    return dict(held_fused=totals["fused"], held_scan=totals["scan"],
                max_abs_err=totals["err"])


def shard_dvm(dev, card):
    """``DistributedVenusMemory`` over 4 slabs of one card: 131,072 rows
    × 768 f32 (16 streams × 8192), inserted in blocks of 8192, then 8
    queries near 8 of its rows. Each query's candidates' probabilities
    against the plain dense softmax over all rows restricted to the
    candidates (renormalised over them: the contract of the top-M
    gather; the candidates' dense mass is printed), the global argmax a
    candidate, every per-shard #4 launch held to its plain version,
    ``scatter_bytes`` of a block equal in a memory of a quarter the
    capacity, and zero mass from an empty index."""
    import numpy as np
    import torch
    from repro_torch.core.distributed_memory import DistributedVenusMemory
    from repro_torch.kernels import ref, similarity
    from repro_torch.launch.mesh import make_memory_mesh
    mesh = make_memory_mesh(4, [dev] * 4)
    mem = DistributedVenusMemory(DVM_ROWS, D, mesh, top_m=64)
    small = DistributedVenusMemory(DVM_ROWS // 4, D, mesh, top_m=64)
    rng = np.random.default_rng(31)
    keep = []
    t_ins = 0.0
    for lo in range(0, DVM_ROWS, DVM_BLOCK):
        block = rng.standard_normal((DVM_BLOCK, D), dtype=np.float32)
        if lo == 0:
            keep = block[:DVM_QUERIES].copy()
            small.insert(block)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mem.insert(block)
        torch.cuda.synchronize()
        t_ins += time.perf_counter() - t0
        if lo == 0:
            check(mem.io_stats["scatter_bytes"]
                  == small.io_stats["scatter_bytes"]
                  == DVM_BLOCK * (4 * D + 5),
                  f"dvm: scatter bytes {mem.io_stats} {small.io_stats}")
    del small
    queries = keep + 0.3 * rng.standard_normal(keep.shape, dtype=np.float32)
    per = DVM_ROWS // 4
    x_all = torch.cat(mem._emb)                        # global id order
    v_all = torch.cat(mem._valid)
    orig = similarity._launch_scan_2d
    launches = []

    def capture(q, x, v, *, tau):
        out = orig(q, x, v, tau=tau)
        launches.append((q, x, v, tau, out))
        return out
    err, search_s, mass = 0.0, [], []
    for j, qv in enumerate(queries):
        similarity._launch_scan_2d = capture
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, probs = mem.search(qv, tau=TAU)
            torch.cuda.synchronize()
            search_s.append(time.perf_counter() - t0)
        finally:
            similarity._launch_scan_2d = orig
        sims, m, l = ref.similarity_scan_ref(
            torch.from_numpy(qv)[None].cuda(), x_all, v_all, tau=TAU)
        dense = ref.scan_probs(sims, m, l, v_all[None], TAU)[0]
        gids = (ids % 4) * per + ids // 4
        live = probs > 0
        pd = dense[gids[live]]
        mass.append(float(pd.sum()))
        want = pd / pd.sum()
        check(torch.allclose(probs[live], want, rtol=1e-4, atol=1e-5),
              f"dvm query {j}: max abs err "
              f"{float((probs[live] - want).abs().max())}")
        err = max(err, float((probs[live] - want).abs().max()))
        check(int(dense.argmax()) in set(gids[live].tolist()),
              f"dvm query {j}: the dense argmax is not a candidate")
    for j, (q, x, v, tau, out) in enumerate(launches):
        want = ref.similarity_scan_ref(q, x, v, tau=tau)
        err4 = _scan_check(f"dvm #4 launch {j}", tuple(t[None] for t in out),
                           tuple(t[None] for t in want), v[None, None, :],
                           tau=tau)
        err = max(err, err4)
    check(len(launches) == 4 * DVM_QUERIES, f"dvm: {len(launches)} #4 "
          f"launches for {DVM_QUERIES} searches over 4 shards")
    empty = DistributedVenusMemory(4 * 1024, D, mesh, top_m=64)
    _, p0 = empty.search(queries[0], tau=TAU)
    check(float(p0.abs().sum()) == 0.0, "dvm: an empty index has mass")
    # the lane order (lax.top_k's: a stable descending sort of the shard)
    # against torch.topk on one shard's scores, A B B A
    sims = ref.similarity_scan_ref(torch.from_numpy(queries[0])[None].cuda(),
                                   mem._emb[0], mem._valid[0], tau=1.0)[0]
    sc = torch.where(mem._valid[0], sims[0], -torch.inf)
    sort_ms, topk_ms = [], []
    for fn in ("sort", "topk", "topk", "sort"):
        if fn == "sort":
            sort_ms.append(cuda_ms(lambda: ref.topk_lowest_lane(sc, 64),
                                   reps=50))
        else:
            topk_ms.append(cuda_ms(lambda: torch.topk(sc, 64), reps=50))
    out = dict(rows=DVM_ROWS, insert_s=t_ins, search_s=search_s,
               candidate_dense_mass=mass, max_abs_err=err,
               launches=len(launches), lane_sort_ms=sort_ms,
               torch_topk_ms=topk_ms)
    print(f"  shard[dvm] lanes of one shard ({per} rows, top 64; CUDA "
          f"events, 50 calls, A B B A): stable sort (lax.top_k's order) "
          f"{[round(x, 5) for x in sort_ms]} ms, torch.topk "
          f"{[round(x, 5) for x in topk_ms]} ms  [{card}]", flush=True)
    print(f"phase shard[dvm]: ok  {DVM_ROWS} x {D} f32 over 4 slabs, "
          f"inserted in {DVM_ROWS // DVM_BLOCK} blocks in {t_ins:.3f} s; "
          f"search (s, host clock) {[round(s, 6) for s in search_s]}; "
          f"candidates' dense mass {min(mass):.3e}-{max(mass):.3e}; "
          f"{len(launches)} #4 launches held (max abs err {err:.3e})  "
          f"[{card}]", flush=True)
    del mem, x_all, v_all
    return out


def phase_shard(worlds, card):
    """The sharded, double-buffered memory path on one card, its slabs
    on ``cuda:0`` K times (the per-slab code a box with K cards runs):
    16 streams of the main worlds in 3 ticks of 64 frames at d = 768 and
    capacity 8192, embedded by ``PixelEmbedder(dim=768)`` (the embedder
    does not touch sharding), into the managers of ``SHARD_MGRS``: (a)
    no mesh, single buffer, the oracle; (b) a K = 1 mesh, double
    buffered; (c) K = 2; (d) K = 4; (e) K = 4 int8 against (e0), an
    unsharded int8 oracle. Before each tick an akr group on (a)-(d), equal
    answers; after it each session's front rows bit-equal to its
    oracle's. Then the akr, sampling and topk groups and one
    ``fused=False`` akr group: equal draws, frame ids and n_drawn; one
    ``sharded_stack_launches`` a group, ``shard_gather_bytes`` of a fused
    group under one f32 (S, Q, cap) tensor, no restack, a double flush a
    append and a carry. Every #1 and #3 launch (one a slab) held to its
    plain version. Then the stream order (``check_stream_order``), the
    tier at K = 4 (``shard_tier``), the edge slab shapes
    (``shard_edges``) and ``DistributedVenusMemory``
    (``shard_dvm``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.session import SessionManager, VenusConfig
    from repro_torch.data.video import PixelEmbedder
    from repro_torch.kernels import ops, similarity
    from repro_torch.launch.mesh import make_memory_mesh
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    mgrs = {}
    for name, (k, db, dtype, _) in SHARD_MGRS.items():
        mesh = None if k is None else make_memory_mesh(k, [dev] * k)
        mgrs[name] = m = SessionManager(
            VenusConfig(index_dtype=dtype), PixelEmbedder(dim=D), D,
            mesh=mesh, double_buffer=db,
            device="cuda" if mesh is None else None)
        for sid in range(S):
            m.create_session(sid)
    sharded = [n for n, v in SHARD_MGRS.items() if v[0] is not None]
    totals = dict(fused=0, scan=0, err=0.0, shapes=set())
    tick_s = {n: [] for n in mgrs}
    group_s = {n: [] for n in mgrs}
    for t in range(SHARD_TICKS):
        pre = {}
        with SlabLaunches() as cap:
            for n in ("a", "b", "c", "d"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pre[n] = shard_group(mgrs[n], seed=40 + t)
                group_s[n].append(time.perf_counter() - t0)
        cap.hold(f"shard tick {t}", totals)
        for n in ("b", "c", "d"):
            same_results(pre[n], pre["a"], f"shard ({n}) before tick {t}")
        chunks = {sid: w.frames[64 * t:64 * (t + 1)]
                  for sid, w in enumerate(worlds)}
        for n, m in mgrs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.ingest_tick(chunks)
            torch.cuda.synchronize()
            tick_s[n].append(time.perf_counter() - t0)
        for n in sharded:
            same_fronts(mgrs[n], mgrs[SHARD_MGRS[n][3]],
                        f"shard ({n}) after tick {t}")
    for n, m in mgrs.items():
        m.flush()
    for n in sharded:
        same_fronts(mgrs[n], mgrs[SHARD_MGRS[n][3]], f"shard ({n}) flushed")
    rows = [mgrs["a"][s].memory.size for s in range(S)]
    io_arena = {n: dict(mgrs[n].arena.io_stats) for n in mgrs}
    results, counts, launch = {}, {}, {}
    for n, m in mgrs.items():
        m.reset_io_stats(include_memories=False)
        ops.reset_scan_counts()
        ops.reset_kernel_launches()
        with SlabLaunches() as cap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[n], qtimes = run_queries(m, S, D, text=False)
            group_s[n] += [qtimes[g] for g in ("akr", "sampling", "topk")]
            counts[n] = ops.scan_counts()
            t0 = time.perf_counter()
            results[n]["dense"] = shard_group(m, fused=False)
            torch.cuda.synchronize()
            group_s[n].append(time.perf_counter() - t0)
        launch[n] = ops.kernel_launches()
        if n == "d":     # one slab launch of the akr group, by CUDA events
            q, x, v, tg, k_, tau = cap.fused[0]
            slab_ms = device_ms(
                lambda: similarity.fused_retrieve_scan_stack(
                    q, x, v, tg, tau=tau, n_topk=k_))
        cap.hold(f"shard ({n})", totals)
        k = SHARD_MGRS[n][0] or 1
        c = counts[n]
        check(launch[n]["fused_retrieve"] == 3 * k
              and launch[n]["similarity_scan_stack"] == k,
              f"shard ({n}): one launch a slab a group: {launch[n]}")
        check(m.io_stats["stack_rebuilds"] == 0, f"shard ({n}): restack")
        if k > 1:
            check(c["sharded_stack_launches"] == 3
                  and m.io_stats["sharded_group_scans"] == 4,
                  f"shard ({n}): one sharded launch a group: {c} "
                  f"{m.io_stats}")
            check(0 < c["shard_gather_bytes"] / 3
                  < S * 8 * m.arena.capacity * 4,
                  f"shard ({n}): gather bytes {c['shard_gather_bytes']}")
        else:
            check(c["sharded_stack_launches"] == 0
                  and m.io_stats["sharded_group_scans"] == 0,
                  f"shard ({n}): K = 1 is the single launch: {c}")
        if SHARD_MGRS[n][1] is not False:
            io = io_arena[n]
            check(io["double_flushes"] == io["appends"] > 0
                  and io["carry_rows"] > 0, f"shard ({n}): {io}")
    for n in sharded:
        o = SHARD_MGRS[n][3]
        for g in results[o]:
            same_results(results[n][g], results[o][g], f"shard ({n}) {g}")
    check_results(mgrs["d"], S, {g: results["d"][g] for g in
                                 ("akr", "sampling", "topk")}, "shard (d)")
    # #1's device time a slab launch in (d)'s akr group, by the profiler.
    # Late in the script a trace loses its first 8 device events (PERF.md
    # §6), so 64 short sleeps head the trace and take that loss; three
    # traces that still lose a launch, or hold no device event, fail the
    # phase
    trace, lost = None, "no device event"
    for _ in range(3):
        before = similarity.fused_retrieve_scan_stack.launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            shard_group(mgrs["d"], seed=77)
            torch.cuda.synchronize()
        try:
            trace = kernel_in_trace(
                prof, similarity.fused_retrieve_scan_stack.launches - before,
                ("k_scores<", "k_finish"), "shard (d) akr")
        except RuntimeError as e:
            lost = str(e)
            print(f"  {lost}: traced again", flush=True)
            continue
        if trace is not None:
            break
    check(trace is not None, f"shard (d): 3 traces of the akr group, the "
          f"last with {lost}")
    for n in ("b", "d"):
        check_stream_order(mgrs[n], f"shard ({n}) order")
    gather = {n: counts[n]["shard_gather_bytes"] / 3 for n in sharded
              if SHARD_MGRS[n][0] > 1}
    rounded = lambda d: {n: [round(x, 4) for x in v] for n, v in d.items()}
    print(f"phase shard: ingest ticks (s) {rounded(tick_s)}  query groups "
          f"(s; 3 before the ticks, akr, sampling, topk, dense) "
          f"{rounded(group_s)}  shard_gather_bytes a fused group {gather}  "
          f"[{card}]", flush=True)
    print(f"  #1 a slab launch of (d)'s akr group: {1e3 * slab_ms:.2f} device "
          f"us (CUDA events, 20 launches behind a sleep); in the group "
          f"(profiler): {trace['launches']} slab launches, "
          f"{trace['device_us_per_launch']:.2f} device us a launch",
          flush=True)
    del mgrs, results
    torch.cuda.empty_cache()
    tier = shard_tier(dev, card)
    edges = shard_edges(worlds, card)
    dvm = shard_dvm(dev, card)
    out = dict(tick_s=tick_s, group_s=group_s, rows=rows,
               shard_gather_bytes=gather, trace=trace, slab_device_ms=slab_ms,
               arena=io_arena,
               held_fused=totals["fused"], held_scan=totals["scan"],
               shapes=sorted(map(str, totals["shapes"])),
               max_abs_err=totals["err"], launches=launch, tier=tier,
               edges=edges, dvm=dvm, phase_s=time.perf_counter() - t_phase)
    print(f"phase shard: ok  K = 1 (double-buffered), 2, 4 and 4 int8 "
          f"answer like their oracles; fronts bit-equal every tick; "
          f"{totals['fused']} #1 and {totals['scan']} #3 launches held "
          f"(max abs err {totals['err']:.3e}); phase {out['phase_s']:.1f} s"
          f"  [{card}]", flush=True)
    return out


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

    elapsed()
    # 2-4, 10. each kernel against its plain version
    fused = phase_fused(gen)
    stages = phase_fused_stages(gen, card)
    sim = phase_similarity(gen)
    scene = phase_scene(frames65)
    clus = phase_cluster()
    dec = phase_decode(gen)

    elapsed()
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
        if None not in (times["scene_trace"], times["fused_trace"]):
            break
        del mgr, results
    check(None not in (times["scene_trace"], times["fused_trace"]),
          "main: 3 traces of the ingest or the queries held no device event")
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    counts = ops.scan_counts()
    check(launches["fused_retrieve"] == 4,
          f"one fused launch per group: {launches}")
    check(launches["scene_score"] > 0, f"scene score launched: {launches}")
    check(launches["cluster_partition"] == sum(
        mgr[s].stats["partitions"] for s in range(S)),
        f"one cluster launch a partition: {launches}")
    check(counts["fused_draw_launches"] == 4, f"scan counts {counts}")
    check(mgr.io_stats["stack_rebuilds"] == 0, "stack_rebuilds == 0")
    check(mgr.arena.emb.shape == (S, cfg.memory_capacity, D),
          f"arena shape {tuple(mgr.arena.emb.shape)}")
    check_results(mgr, len(worlds), results, "main")
    st = times["scene_trace"]
    check(st["launches"] == launches["scene_score"],
          f"main trace: {st['launches']} scene launches in the ingest, "
          f"{launches['scene_score']} in the phase")
    ft = times["fused_trace"]
    check(ft["launches"] == launches["fused_retrieve"],
          f"main trace: {ft['launches']} fused launches in the queries, "
          f"{launches['fused_retrieve']} in the phase")
    for tag, tr, where in (("#2", st, "ingest's"), ("#1", ft, "queries'")):
        print(f"  {tag} in the main phase (profiler): {tr['launches']} "
              f"launches, {tr['device_us']:.2f} device us = "
              f"{tr['device_us_per_launch']:.2f} a launch, "
              f"{100 * tr['share_of_traced_device']:.2f} % of the {where} "
              f"{tr['traced_device_us'] / 1e3:.2f} device ms", flush=True)
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
    # an index row of each session: the standing phase's embedding specs
    first_pass = [mgr[s].memory._emb[mgr[s].memory.size // 2].copy()
                  for s in range(S)]
    rows = [mgr[s].memory.size for s in range(S)]
    times["embed"] = dict(seconds=embedder.seconds, frames=n_emb,
                          frames_per_s=n_emb / embedder.seconds,
                          init_seconds=t_init)
    print(f"phase main: ok  launches {launches}  stack_rebuilds 0  "
          f"rows per session {rows}  MEM embed (venus-mem-large, bf16) "
          f"{embedder.seconds:.3f} s for {n_emb} frames = "
          f"{n_emb / embedder.seconds:.1f} frames/s (init {t_init:.2f} s) "
          f"[{card}]", flush=True)

    elapsed()
    # 6. the dense query path on the main manager
    dense = phase_dense(mgr, worlds, card)

    elapsed()
    # 11-12. serving: Venus retrieval feeding Qwen2-VL-7B, then MiniCPM3-4B
    serve = phase_serve(mgr, card, akr=(results["akr"],
                                        times["queries"]["akr"]))
    del mgr
    torch.cuda.empty_cache()
    serve_mla = phase_serve_mla(card)
    torch.cuda.empty_cache()

    elapsed()
    # 15-17. the MoE family and the dense zoo through the engine
    serve_moe = phase_serve_moe(card)
    serve_olmoe = phase_serve_olmoe(card)
    serve_zoo = phase_serve_zoo(card)

    elapsed()
    # 18-20. the rest of the zoo: the Mamba2 hybrid, RWKV6, Whisper
    serve_hybrid = phase_serve_hybrid(card)
    serve_rwkv = phase_serve_rwkv(card)
    serve_whisper = phase_serve_whisper(card)

    elapsed()
    # 7. the int8 arena
    ops.reset_kernel_launches()
    mgr8, res8, _ = run_main_path(
        worlds, VenusConfig(index_dtype="int8"), PixelEmbedder(dim=D), D,
        card, "main_int8")
    l8 = ops.kernel_launches()
    check(l8["fused_retrieve"] == 4 and l8["scene_score"] > 0,
          f"int8 launches {l8}")
    check(mgr8.io_stats["stack_rebuilds"] == 0, "int8 stack_rebuilds")
    check_results(mgr8, len(worlds), res8, "main_int8")
    print(f"phase main_int8: ok  launches {l8}", flush=True)
    del mgr8

    elapsed()
    # 26. the sharded, double-buffered memory path
    shard = phase_shard(worlds, card)
    torch.cuda.empty_cache()

    elapsed()
    # 13. the hierarchical tier through the entry points
    tier = phase_tier(embedder, card)
    tier_full = phase_tier_full(card)
    torch.cuda.empty_cache()

    elapsed()
    # 14. standing queries and the spill tier through the entry points
    standing = phase_standing(embedder, worlds, first_pass, card)
    torch.cuda.empty_cache()

    elapsed()
    # 8. MEM card vs CPU, and bf16 vs f32
    mem_out = phase_mem(mem, worlds[1].frames[:4])
    del mem, embedder

    elapsed()
    # 9. a small input through the card and through the plain versions
    parity = phase_parity()

    elapsed()
    # 21-25. training on the card, from an empty card
    free_card()
    train = phase_train(card)

    elapsed()
    # 27. FSDP2 on one card, and the dry run held to it
    ops.reset_kernel_launches()
    mesh_train = phase_mesh_train(card)
    launched = {k: v for k, v in ops.kernel_launches().items() if v}
    check(not launched, f"mesh_train launched kernels: {launched}")

    elapsed()
    # 28. serving on the model axis: torchrun ranks against one process
    free_card()
    tp_serve = phase_tp_serve(card)

    elapsed()
    # 29. training on the model axis: torchrun ranks against one process
    free_card()
    tp_train = phase_tp_train(card)

    elapsed()
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
        max_abs_err=max(v["max_abs_err"] for v in list(fused.values())
                        + [stages["stage1"], stages["stage2"], standing,
                           *standing["edges"].values()]),
        ms=fused["f32"]["ms"], device_ms=fused["f32"]["device_ms"],
        plain_ms=fused["f32"]["plain_ms"],
        bound_ms=fused["f32"]["bound_ms"], bound_by=fused["f32"]["bound_by"],
        all_rows_bound_ms=fused["f32"]["all_rows_bound_ms"],
        library_ms=None, int8_ms=fused["int8"]["ms"],
        int8_device_ms=fused["int8"]["device_ms"],
        int8_bound_ms=fused["int8"]["bound_ms"],
        int8_all_rows_bound_ms=fused["int8"]["all_rows_bound_ms"],
        windows_ms=fused["f32_windows"]["ms"],
        main_device_us_per_launch=ft["device_us_per_launch"],
        main_device_us=ft["device_us"],
        tier_launches=tier["launches"],
        tier_8192_launches=tier_full["launches"],
        standing_launches=standing["launches"],
        standing_device_us_per_launch=(
            standing["trace"]["device_us_per_launch"]
            if standing["trace"] else None),
        standing_bound_us=standing["bound_us"],
        standing_cases=[list(map(str, c)) for c in standing["shapes"]
                        + standing["edges"]["float32"]["shapes"]
                        + standing["edges"]["int8"]["shapes"]],
        **{f"{st}_{k}": stages[st][k] for st in ("stage1", "stage2")
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "max_abs_err")},
        stage2_gather_device_ms=stages["gather"]["device_ms"],
        shard_launches={n: v["fused_retrieve"]
                        for n, v in shard["launches"].items()},
        shard_device_us_per_launch=shard["trace"]["device_us_per_launch"],
        shard_slab_device_ms=shard["slab_device_ms"],
        shard_tier_held=shard["tier"]["held"],
        shard_edges_held=shard["edges"]["held_fused"]),
        dict(stack_row, shard_launches={
            n: v["similarity_scan_stack"]
            for n, v in shard["launches"].items()},
            shard_edges_held=shard["edges"]["held_scan"]),
        dict(scan_row("similarity_scan", "similarity_scan_2d.cu",
                      "src/repro/kernels/similarity.py:148", sim["2d"],
                      dl["similarity_scan"]),
             max_abs_err=max(v["max_abs_err"] for k, v in sim.items()
                             if k.startswith("2d")),
             int8_ms=sim["2d_int8"]["ms"],
             int8_device_ms=sim["2d_int8"]["device_ms"],
             int8_bound_ms=sim["2d_int8"]["bound_ms"],
             shard_dvm_launches=shard["dvm"]["launches"]),
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
             bound_by=scene["table"]["bound_by"], library_ms=None),
        dict(name="cluster_partition", route="cuda",
             source="src/repro_torch/kernels/csrc/cluster.cu",
             replaces="none: the reference's lax.scan "
                      "(src/repro/core/clustering.py)",
             launches=launches["cluster_partition"],
             max_abs_err=max(v["max_abs_err"] for n, v in clus.items()
                             if n != "launches"),
             ms=clus["t61"]["ms"], device_us=clus["t61"]["device_us"],
             plain_ms=clus["t61"]["plain_ms"],
             bound_ms=clus["t61"]["bound_ms"],
             bound_by=clus["t61"]["bound_by"], library_ms=None)]

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

    def tp_row(kernel):
        # tp_serve's cases whose decode runs ``kernel``
        cases = {a: r for a, r in tp_serve.items() if r["kernel"] == kernel}
        return dict(
            tp_serve_launches={a: r["launches"] for a, r in cases.items()},
            tp_serve_partial_launches={a: r["partial_launches"]
                                       for a, r in cases.items()},
            tp_serve_merge_launches={a: r["merge_launches"]
                                     for a, r in cases.items()},
            tp_serve_device_us_per_launch={
                a: r["device_us_per_launch"] for a, r in cases.items()},
            tp_serve_bound_us={a: r["bound_us"] for a, r in cases.items()},
            tp_serve_held_max_abs_err=max(r["max_abs_err"]
                                          for r in cases.values()))
    kernels += [
        dict(decode_row("gqa_decode", "decode_attention.cu",
                        "src/repro/kernels/decode_attention.py:96",
                        "gqa", serve["launches"]["gqa_decode"],
                        ("bf16", "bf16_softcap30", "bf16_mha", "f32",
                         "bf16_holes", "bf16_c2000", "bf16_g16",
                         "bf16_serve", "bf16_d80", "bf16_d64", "bf16_g32",
                         "bf16_d72", "f32_d6", "bf16_g128_d512")),
             serve_olmoe_launches=serve_olmoe["launches"]["gqa_decode"],
             serve_olmoe_device_us_per_launch=serve_olmoe[
                 "kernel_us_per_launch"],
             serve_zoo_launches={a: r["launches"]["gqa_decode"]
                                 for a, r in serve_zoo.items()},
             serve_zoo_device_us_per_launch={
                 a: r["kernel_us_per_launch"] for a, r in serve_zoo.items()},
             serve_hybrid_launches=serve_hybrid["launches"]["gqa_decode"],
             serve_hybrid_device_us_per_launch=serve_hybrid[
                 "kernel_us_per_launch"],
             serve_whisper_launches=serve_whisper["launches"]["gqa_decode"],
             serve_whisper_device_us_per_launch=serve_whisper[
                 "kernel_us_per_launch"],
             serve_held_max_abs_err=max(
                 [r["held"]["max_abs_err"] for r in (
                     serve_olmoe, serve_hybrid, serve_whisper,
                     *serve_zoo.values())]),
             **tp_row("gqa_decode")),
        dict(decode_row("mla_decode", "mla_decode.cu",
                        "src/repro/kernels/decode_attention.py:173",
                        "mla", serve_mla["launches"]["mla_decode"],
                        ("bf16", "f32", "bf16_holes", "bf16_c2000",
                         "bf16_serve", "bf16_dsv2", "bf16_dsv3",
                         "bf16_r30", "partials_minicpm3_bf16",
                         "partials_minicpm3_f32", "partials_dsv2_bf16",
                         "partials_dsv2_f32", "merge_minicpm3",
                         "merge_dsv2")),
             f32_source="src/repro_torch/kernels/csrc/decode_attention.cu",
             partial_device_ms=dec["mla_bf16"]["partial_device_ms"],
             serve_device_us_per_launch=serve_mla["mla_us_per_launch"],
             serve_moe_launches=serve_moe["launches"]["mla_decode"],
             serve_moe_device_us_per_launch=serve_moe[
                 "kernel_us_per_launch"],
             serve_held_max_abs_err=serve_moe["held"]["max_abs_err"],
             **tp_row("mla_decode"))]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, fused=fused,
                       fused_stages=stages, similarity=sim, scene=scene,
                       cluster=clus,
                       decode=dec, main=times, dense=dense, serve=serve,
                       serve_mla=serve_mla, serve_moe=serve_moe,
                       serve_olmoe=serve_olmoe, serve_zoo=serve_zoo,
                       serve_hybrid=serve_hybrid, serve_rwkv=serve_rwkv,
                       serve_whisper=serve_whisper,
                       mem=mem_out, tier=tier,
                       tier_8192=tier_full, standing=standing,
                       shard=shard, mesh_train=mesh_train,
                       tp_serve=tp_serve, tp_train=tp_train,
                       parity_tier=parity, **train), f, indent=1)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-worker"]:
        sys.exit(train_worker(sys.argv[2:]))
    sys.exit(main())
