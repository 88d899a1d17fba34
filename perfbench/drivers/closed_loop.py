"""A closed loop of clients, one a camera: a client asks its next
question (``mix.ClosedLoop``) as soon as its last answer is complete.
One thread submits every ready client's question in one
``VenusService.submit``, then runs one ``ServingEngine.step``. The
window ends with the step that crosses ``--seconds``; its tokens are
every token the engine produced in it."""

from __future__ import annotations

import time

from perfbench import mix
from perfbench.serving import ServeRun
from perfbench.trace import DeviceTrace


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: bool = False):
    sr = ServeRun(cfg, traffic, seed, device)
    loop = mix.ClosedLoop(traffic, seed, sr.world, sr.vocab, sr.seen_upto)
    sr.warm_up()
    setup_s = time.perf_counter() - t_start
    clients = {cam: None for cam in range(sr.world.streams)}
    attempted = 0
    with DeviceTrace(trace) as tr:
        t0 = time.perf_counter()
        while True:
            ready = [c for c, e in clients.items()
                     if e is None or e["req"].finished_at is not None]
            if ready:
                for c, e in zip(ready, sr.submit([loop.next(c)
                                                  for c in ready])):
                    clients[c] = e
                attempted += len(ready)
            sr.step()
            if sr.steps[-1]["t1"] - t0 >= seconds:
                break
        t1 = sr.steps[-1]["t1"]
    obs = {"tokens": sum(s["tokens"] for s in sr.steps)}
    return sr.finish(setup_s=setup_s, t0=t0, t1=t1,
                     trace=tr if trace else None, attempted=attempted,
                     failed=0, obs=obs, control=control)
