"""The program's own spans (``repro_torch.obs``) in a traced window,
and the device operations under them.

A traced run holds a ``torch.profiler`` session open over the window
(``trace.DeviceTrace``), and the program stores its spans while one is
open; spans and device operations are both on ``time.perf_counter()``.
An untraced run, or a program without the recorder, gives no spans, and
a reader then has nothing to read. ``DeviceTrace.ops`` is sorted by
start, so operations are found by bisection, not a scan a span."""

from __future__ import annotations

import bisect
from typing import List


def in_window(rec, name: str) -> List:
    """The spans named ``name`` that lie within the window."""
    if rec.trace is None:
        return []
    try:
        from repro_torch import obs
    except ImportError:
        return []
    return [s for s in obs.spans()
            if s.name == name and rec.t0 <= s.t0 and s.t1 <= rec.t1]


def ops_started(trace, spans) -> int:
    """Device operations that start inside one of the spans."""
    starts = [o[1] for o in trace.ops]
    return sum(bisect.bisect_right(starts, s.t1)
               - bisect.bisect_left(starts, s.t0) for s in spans)


def busy_s(trace, spans) -> float:
    """Seconds of the spans (disjoint) in which a device operation ran,
    each instant once."""
    merged: List[List[float]] = []
    for _, a, b in trace.ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    total = 0.0
    for s in spans:
        i = max(bisect.bisect_right(starts, s.t0) - 1, 0)
        while i < len(merged) and merged[i][0] < s.t1:
            total += max(0.0, min(merged[i][1], s.t1) - max(merged[i][0],
                                                           s.t0))
            i += 1
    return total


def idle_share(trace, spans) -> float:
    """Per cent of the spans' seconds with no device operation running
    (None without spans)."""
    secs = sum(s.seconds for s in spans)
    return 100.0 * (1.0 - busy_s(trace, spans) / secs) if secs > 0 else None
