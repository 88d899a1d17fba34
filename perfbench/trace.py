"""Host spans and the device trace of a window.

``Spans`` records the harness's own spans (name, start, end on the host
clock) around its calls into each layer of the program. ``DeviceTrace``
runs ``torch.profiler`` (device activity only) over the window and puts
every device operation on the host clock, through one marker kernel
launched at a known host time; it gives the device's busy seconds, the
time and count of kernels by name, the operations that took most time,
and the idle time by the host span it fell in.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class Spans:
    def __init__(self):
        self.items: List[Tuple[float, float, str]] = []
        self._starts: Optional[List[float]] = None

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((t0, t1, name))
        self._starts = None

    def label_at(self, t: float, depth: int = 16) -> str:
        """The latest-starting span that holds ``t`` among the ``depth``
        that start last before it (spans nest a few deep at most)."""
        if self._starts is None:
            self.items.sort()
            self._starts = [a for a, _, _ in self.items]
        i = bisect.bisect_right(self._starts, t)
        for a, b, name in reversed(self.items[max(0, i - depth):i]):
            if a <= t < b:
                return name
        return "between_spans"


class DeviceTrace:
    """Trace the device while the ``with`` block runs; ``enabled=False``
    makes it a no-op. Operations on the stream ``exclude`` (the traffic
    generator's own) are left out."""

    def __init__(self, enabled: bool, exclude=None):
        self.enabled = enabled
        self.exclude = exclude
        self.ops: List[Tuple[str, float, float]] = []     # name, t0, t1
        self._prof = None

    def __enter__(self):
        if not self.enabled:
            return self
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        if self.exclude is not None:
            with torch.cuda.stream(self.exclude):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        events.sort(key=lambda e: e.start_ns())
        marks = [e for e in events if "spin_kernel" in e.name()]
        if len(marks) < (2 if self.exclude is not None else 1):
            raise RuntimeError("the device trace holds no marker kernel")
        base = marks[0].start_ns()
        skip = ({marks[1].device_resource_id()} if self.exclude is not None
                else set())
        self.ops = [(e.name(),
                     self._mark_host + (e.start_ns() - base) / 1e9,
                     self._mark_host + (e.end_ns() - base) / 1e9)
                    for e in events if "spin_kernel" not in e.name()
                    and e.device_resource_id() not in skip]
        self.ops.sort(key=lambda o: o[1])
        self._prof = None
        return False

    # ------------------------------------------------------------ readings
    def within(self, t0: float, t1: float) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if o[1] >= t0 and o[2] <= t1]

    @staticmethod
    def covered(intervals: Sequence[Tuple[float, float]]) -> float:
        """Seconds covered by the intervals, each instant once."""
        total, end = 0.0, float("-inf")
        for a, b in sorted(intervals):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    def busy_s(self, t0: float, t1: float) -> float:
        return self.covered([(max(a, t0), min(b, t1)) for _, a, b in self.ops
                             if b > t0 and a < t1])

    def kernel(self, parts: Sequence[str], count: Sequence[str],
               t0: float, t1: float) -> Tuple[int, float]:
        """(launches, device seconds) of a hand-written kernel within [t0,
        t1]: the seconds covered by the operations whose names hold one
        of ``parts``, the launches counted by those whose names hold one
        of ``count`` (the part each launch runs once)."""
        ops = [o for o in self.within(t0, t1)
               if any(p in o[0] for p in parts)]
        n = sum(1 for o in ops if any(c in o[0] for c in count))
        return n, self.covered([(a, b) for _, a, b in ops])

    def top_ops(self, t0: float, t1: float, n: int = 10
                ) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.within(t0, t1):
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v] for k, v in top]

    def idle_by_span(self, spans: Spans, t0: float, t1: float, n: int = 10
                     ) -> List[List]:
        """Idle device seconds in [t0, t1], summed by the host span the
        host was in when each gap began; the ``n`` largest."""
        ivs = sorted((max(a, t0), min(b, t1)) for _, a, b in self.ops
                     if b > t0 and a < t1)
        by: Dict[str, float] = {}
        cur = t0
        for a, b in ivs + [(t1, t1)]:
            if a > cur:
                lab = spans.label_at(cur)
                by[lab] = by.get(lab, 0.0) + (a - cur)
            cur = max(cur, b)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]

