"""The readers of the program's spans (``program_spans.py`` and the nine
metrics on it), fed synthetic spans and a synthetic device trace: what
each reads, that spans outside the window are left out, and that each
reads nothing (None) with no spans, with no trace, and from a program
without the recorder."""

import statistics
import sys

import pytest

from perfbench import harness, program_spans
from perfbench.trace import DeviceTrace
from repro_torch import obs

T0, T1 = 100.0, 200.0


def _span(name, t0, t1, **attrs):
    s = obs.Span(name, attrs)
    s.t0, s.t1 = t0, t1
    return s


# each span family with one span outside the window, which no reader
# may count
SPANS = [
    _span("ingest.cluster", 101.0, 103.0),
    _span("ingest.cluster", 105.0, 106.0),
    _span("ingest.partition", 101.0, 102.0, sid=0, frames=10, clusters=2),
    _span("ingest.partition", 102.0, 103.0, sid=1, frames=30, clusters=3),
    _span("ingest.partition", 99.0, 100.5, sid=0, frames=50, clusters=1),
    _span("ingest.upload", 110.0, 110.5, sid=0, bytes=2_000_000_000),
    _span("ingest.upload", 111.0, 111.5, sid=1, bytes=1_000_000_000),
    _span("ingest.upload", 200.0, 201.0, sid=0, bytes=7),
    _span("ingest.embed", 120.0, 122.0, keyframes=300),
    _span("ingest.embed", 123.0, 124.0, keyframes=150),
    _span("ingest.embed", 50.0, 51.0, keyframes=999),
    _span("engine.decode", 130.0, 131.0, slots=16),
    _span("engine.decode", 132.0, 134.0, slots=16),
    _span("engine.decode", 199.5, 200.5, slots=16),
    _span("engine.prefill", 140.0, 140.1, rid=1, tokens=9, waited=0.5),
    _span("engine.prefill", 141.0, 141.3, rid=2, tokens=9, waited=0.1),
    _span("engine.prefill", 142.0, 142.2, rid=3, tokens=9, waited=0.2),
    _span("engine.prefill", 10.0, 20.0, rid=0, tokens=9, waited=9.0),
    _span("service.submit", 150.0, 150.6, rids=(1, 2), questions=2),
    _span("service.submit", 151.0, 151.4, rids=(3,), questions=1),
    _span("service.submit", 0.0, 1.0, rids=(0,), questions=1),
]

# device operations (name, start, end), sorted by start
OPS = [("k", 100.2, 101.5),      # reaches into the first cluster span
       ("k", 101.6, 101.8), ("k", 101.7, 102.2),   # overlapping
       ("k", 102.5, 102.6),
       ("k", 105.5, 107.0),      # runs past the second cluster span
       ("k", 105.6, 105.7),      # inside the one before it
       ("k", 130.1, 130.2), ("k", 130.3, 130.4), ("k", 132.0, 133.0),
       ("k", 133.5, 133.6), ("k", 199.6, 199.7)]


def _record(trace=True):
    tr = None
    if trace:
        tr = DeviceTrace(False)
        tr.ops = list(OPS)
    return harness.Record(cfg={}, traffic={}, setup_s=0.0, t0=T0, t1=T1,
                          attempted=1, failed=0, obs={}, spans=None,
                          trace=tr, memory_peak_bytes=0)


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(obs, "spans", lambda: list(SPANS))


# the cluster spans cover 3 s: the first is busy from 101.0 to 101.5 and
# from 101.6 to 102.2 and 102.5 to 102.6 (1.2 s), the second from 105.5
# to 106.0 (0.5 s); the decode spans cover 3 s, busy 0.2 + 1.1 s
WANT = {
    "cluster_launches_per_frame": 3 / 40,
    "cluster_idle_share": 100.0 * (1 - 1.7 / 3.0),
    "upload_gb_per_s": 3.0,
    "keyframes_embedded_per_s": 450 / 3.0,
    "decode_launches_per_step": 4 / 2,
    "decode_idle_share": 100.0 * (1 - 1.3 / 3.0),
    "prefill_s.describe": statistics.median([0.1, 0.3, 0.2]),
    "queue_wait_s.describe": 0.2,
    "submit_s.describe": 1.0 / 3,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_window_spans(spans, name):
    got = harness.load_module("metrics", name).read(_record())
    assert got == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_spans_or_trace(monkeypatch, name):
    read = harness.load_module("metrics", name).read
    monkeypatch.setattr(obs, "spans", lambda: [])
    assert read(_record()) is None
    monkeypatch.setattr(obs, "spans", lambda: list(SPANS))
    assert read(_record(trace=False)) is None
    # a program that has no recorder
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert read(_record()) is None


def test_busy_seconds_count_each_instant_once():
    tr = _record().trace
    one = [_span("s", 101.0, 103.0)]
    assert program_spans.busy_s(tr, one) == pytest.approx(1.2)
    assert program_spans.ops_started(tr, one) == 3
    # a span in a gap between operations
    assert program_spans.busy_s(tr, [_span("s", 103.0, 105.0)]) == 0.0
    assert program_spans.idle_share(tr, []) is None

