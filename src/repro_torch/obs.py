"""Spans of the port's own work, on the host clock.

``span(name, **attrs)`` times a block with two ``time.perf_counter()``
readings, always: the stage seconds the port hands back
(``SessionManager.ingest_tick``'s dict, ``ServingEngine.timings``,
``QueryResult.timings``, ``StandingRegistry.seconds``) are the durations
of their spans. While a ``torch.profiler`` session collects (the rule
``record_function`` follows), the span is also stored: its name, start
and end, the span that encloses it on its thread (``parent``) and its
attributes (request ids, session ids, the counts at that boundary).
``spans()`` returns what was stored, at most ``CAPACITY`` spans, the
oldest dropped first; ``clear()`` drops them. With no profiler running
a span costs its two clock readings and one flag read.

``perf_counter`` is the clock a device trace is laid on through a marker
kernel, so a stored span and the device operations launched inside it
line up with no conversion. No span synchronises the device: each ends
where its code already reads a result back.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 17

_stored: deque = deque(maxlen=CAPACITY)
_open = threading.local()


class Span:
    """One timed block; ``seconds`` is ``t1 - t0``. Attributes set
    inside the block (``set``) are stored with it."""

    __slots__ = ("name", "attrs", "t0", "t1", "parent", "_stored")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = 0.0
        self.parent: Optional[Span] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._stored = _profiler._is_profiler_enabled
        if self._stored:
            stack = _open.__dict__.setdefault("stack", [])
            self.parent = stack[-1] if stack else None
            stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self._stored:
            _open.stack.pop()
            _stored.append(self)
        return False


def span(name: str, **attrs) -> Span:
    """A ``with`` block timed as ``name``, stored while a profiler
    session collects."""
    return Span(name, attrs)


def spans() -> List[Span]:
    """The stored spans, in the order they ended."""
    return list(_stored)


def clear() -> None:
    _stored.clear()
