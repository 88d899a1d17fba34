"""A closed loop of ingest ticks: each tick hands one chunk of every
camera to ``SessionManager.ingest_tick``, back to back.

Set-up builds MEM and the manager with the benchmark's weights and runs
``warm_ticks`` ticks (the streams' first chunks: every shape and kernel
the window uses). The window runs ticks until ``seconds`` have passed
and ends with the tick that crosses it; the frames come from a producer
one tick ahead (``world.TickProducer``). Spans: each tick's stages, as
``ingest_tick`` returns them, the wait for frames, the embedder's
calls."""

from __future__ import annotations

import gc
import sys
import time

import torch

from perfbench.checks import ingest as ingest_check
from perfbench.harness import Record
from perfbench.systems import venus_ingest
from perfbench.trace import DeviceTrace, Spans
from perfbench.world import CameraWorld, TickProducer


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: bool = False) -> Record:
    t_build = time.perf_counter()
    world = CameraWorld.from_traffic(traffic, seed, device)
    streams = world.streams
    mgr, emb = venus_ingest.build(cfg, seed, device, streams)
    _sync(device)
    t_warm = time.perf_counter()
    warm = traffic["warm_ticks"]
    for i in range(warm):
        mgr.ingest_tick(world.tick(i))
    producer = TickProducer(world, warm)
    _sync(device)
    print(f"setup: imports and start {t_build - t_start:.3f} s, MEM and "
          f"manager {t_warm - t_build:.3f} s, {warm} warm ticks "
          f"{time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    spans = Spans()
    ticks = []
    n_calls = len(emb.calls)
    try:
        setup_s = time.perf_counter() - t_start
        with DeviceTrace(trace, exclude=producer.stream) as tr:
            t0 = time.perf_counter()
            while True:
                tw = time.perf_counter()
                chunks = producer.get()
                a = time.perf_counter()
                spans.add("frames.wait", tw, a)
                st = mgr.ingest_tick(chunks)
                b = time.perf_counter()
                spans.add("ingest_tick", a, b)
                s1 = a + st["segment"]
                s2 = s1 + st["cluster"]
                spans.add("ingest_tick.segment", a, s1)
                spans.add("ingest_tick.cluster", s1, s2)
                spans.add("ingest_tick.embed_insert", s2, b)
                ticks.append({"t0": a, "t1": b, "wait": a - tw, **st})
                if b - t0 >= seconds:
                    break
            t1 = b
    finally:
        producer.close()
    peak = torch.cuda.max_memory_allocated() if torch.device(
        device).type == "cuda" else 0
    calls = emb.calls[n_calls:]
    for c0, c1, _ in calls:
        spans.add("embed_frames", c0, c1)
    chunk = traffic["cameras"]["chunk_frames"]
    res = traffic["cameras"]["resolution"]
    obs = {"ticks": ticks, "frames": len(ticks) * streams * chunk,
           "embed_calls": calls, "streams": streams, "chunk": chunk,
           "resolution": res, "wait_s": sum(t["wait"] for t in ticks)}
    print(f"window: {len(ticks)} ticks, {obs['frames']} frames, "
          f"{obs['wait_s']:.3f} s waiting for the frame generator",
          file=sys.stderr)
    rows = {s: venus_ingest.stored_rows(mgr, s) for s in range(streams)}
    n_chunks = warm + len(ticks)
    del mgr, emb
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = ingest_check.checks(cfg, traffic, world, rows, n_chunks, seed,
                                 device, control)
    return Record(cfg=cfg, traffic=traffic, setup_s=setup_s, t0=t0, t1=t1,
                  attempted=len(ticks), failed=0, obs=obs, spans=spans,
                  trace=tr if trace else None, memory_peak_bytes=peak,
                  checks=checks)
