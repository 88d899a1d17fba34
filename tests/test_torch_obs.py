"""The port's span recorder (``repro_torch.obs``) on the CPU: what a small
ingest (with a standing query and an ad-hoc query) and a small
``VenusService`` submit plus engine steps record under
``torch.profiler``: names, nesting, request ids, the counts each span
carries, and the stage dicts read from the spans' durations; and that
with no profiler running nothing is stored while the dicts still fill.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.core.standing import STAGES
from repro_torch.data.video import PixelEmbedder, VideoWorld, WorldConfig
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.venus_service import StreamQuery, VenusService

DIM = 64
STAGE_SPANS = ("ingest.segment", "ingest.cluster", "ingest.embed_insert")


@pytest.fixture(autouse=True)
def _empty_recorder():
    obs.clear()
    yield
    obs.clear()


def _worlds():
    return [VideoWorld(WorldConfig(n_scenes=3, scene_len_min=6,
                                   scene_len_max=12, resolution=16, seed=s))
            for s in (3, 4)]


def _manager(worlds):
    mgr = SessionManager(VenusConfig(), PixelEmbedder(dim=DIM), DIM,
                         device="cpu")
    for _ in worlds:
        mgr.create_session()
    return mgr


def _chunks(worlds, tick, n=12):
    return {sid: w.frames[tick * n:(tick + 1) * n]
            for sid, w in enumerate(worlds)}


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_ingest_spans_nest_count_and_give_the_stage_seconds():
    worlds = _worlds()
    mgr = _manager(worlds)
    emb = PixelEmbedder(dim=DIM).embed_query("watch")
    mgr.register_standing(0, QuerySpec(sid=0, embedding=emb,
                                       strategy="topk", budget=2),
                          threshold=2.0)
    chunks = [_chunks(worlds, t) for t in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        before = time.perf_counter()
        stats = [mgr.ingest_tick(c) for c in chunks]
        res = mgr.query_specs([QuerySpec(sid=1, embedding=emb,
                                         strategy="topk", budget=3)])[0]
        after = time.perf_counter()
    spans = obs.spans()
    by = _by_name(spans)
    assert all(before <= s.t0 <= s.t1 <= after for s in spans)
    # each tick's stages, back to back at the top, give its dict
    for name, key in zip(STAGE_SPANS, ("segment", "cluster",
                                       "embed_insert")):
        assert [s.seconds for s in by[name]] == [st[key] for st in stats]
        assert all(s.parent is None for s in by[name])
    for child, parent in (("ingest.upload", "ingest.segment"),
                          ("ingest.partition", "ingest.cluster"),
                          ("ingest.embed", "ingest.embed_insert")):
        assert by[child] and all(s.parent.name == parent
                                 for s in by[child])
        for s in by[child]:
            assert s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1
    # the counts each span carries
    assert sum(s.attrs["bytes"] for s in by["ingest.upload"]) == sum(
        np.asarray(a, np.float32).nbytes for c in chunks for a in c.values())
    assert sorted({s.attrs["sid"] for s in by["ingest.upload"]}) == [0, 1]
    clustered = sum(st.pending_base for st in mgr.sessions.values())
    assert clustered > 0
    assert sum(s.attrs["frames"] for s in by["ingest.partition"]) == \
        clustered
    assert sum(s.attrs["clusters"] for s in by["ingest.partition"]) == sum(
        st.stats["clusters"] for st in mgr.sessions.values())
    rows = sum(st.memory.size for st in mgr.sessions.values())
    assert sum(s.attrs["keyframes"] for s in by["ingest.embed"]) == rows
    # the standing stages: each its span, their seconds the registry's
    ev = [by[f"standing.{n}"] for n in STAGES]
    assert all(len(e) == len(ev[0]) >= 1 for e in ev)
    assert all(s.parent.name == "ingest.embed_insert" for e in ev for s in e)
    assert {n: sum(s.seconds for s in e) for n, e in zip(STAGES, ev)} == \
        mgr.standing.seconds
    # an ad-hoc query: the result's timings are its spans' durations
    (qe,), (qs,), (qx,) = (by[n] for n in ("query.embed", "query.scan",
                                           "query.expand"))
    assert res.timings == {"embed_query": qe.seconds,
                           "similarity": qs.seconds,
                           "sample_expand": qx.seconds}
    assert qe.attrs["queries"] == 0 and qs.attrs["queries"] == 1


def test_no_profiler_stores_nothing_and_the_dicts_still_fill():
    worlds = _worlds()
    mgr = _manager(worlds)
    with obs.span("outside") as sp:
        st = mgr.ingest_tick(_chunks(worlds, 0))
    assert obs.spans() == []
    assert sp.seconds > 0 and sp.parent is None
    assert all(st[k] > 0 for k in ("segment", "cluster", "embed_insert"))
    assert st["segment"] + st["cluster"] + st["embed_insert"] <= sp.seconds


def test_recorder_nests_per_thread_and_stays_bounded(monkeypatch):
    monkeypatch.setattr(obs, "_stored", collections.deque(maxlen=4))
    other = {}

    def on_another_thread():
        with obs.span("t") as other["t"]:
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("a", rid=1) as a:
            with obs.span("b") as b:
                b.set(n=2)
                th = threading.Thread(target=on_another_thread)
                th.start()
                th.join(timeout=60)
        for _ in range(5):
            with obs.span("c"):
                pass
    assert not th.is_alive() and other["t"].parent is None
    assert b.parent is a and a.parent is None
    assert b.attrs == {"n": 2} and a.attrs == {"rid": 1}
    assert [s.name for s in obs.spans()] == ["c"] * 4


def test_service_spans_link_requests_to_their_prefill():
    worlds = _worlds()
    cfg = registry.get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
    torch.manual_seed(0)
    engine = ServingEngine(init_model(cfg, device="cpu"), batch_slots=2,
                           max_len=64, cache_dtype=torch.float32)
    svc = VenusService(_manager(worlds), engine, max_frames=2)
    svc.ingest_tick(_chunks(worlds, 0, n=24))
    svc.flush()
    rng = np.random.default_rng(0)
    qs = [StreamQuery(rid=10 + r, sid=r % 2, text=f"event{r}",
                      prompt_tokens=rng.integers(3, 500, size=5 + r),
                      max_new_tokens=3) for r in range(3)]
    with profile(activities=[ProfilerActivity.CPU]):
        before = time.perf_counter()
        reqs = svc.submit(qs)
        while engine.step():
            pass
        after = time.perf_counter()
    spans = obs.spans()
    by = _by_name(spans)
    assert all(before <= s.t0 <= s.t1 <= after for s in spans)
    (sub,) = by["service.submit"]
    assert sub.attrs == {"rids": (10, 11, 12), "questions": 3}
    assert all(r.submitted_at == sub.t0 for r in reqs)
    for n in ("query.embed", "query.scan", "query.expand"):
        assert by[n] and all(s.parent is sub for s in by[n])
    pre = by["engine.prefill"]
    assert sorted(s.attrs["rid"] for s in pre) == [10, 11, 12]
    for s in pre:
        r = reqs[s.attrs["rid"] - 10]
        assert s.attrs["tokens"] == len(r.tokens) + cfg.vision_tokens
        assert s.attrs["waited"] == s.t0 - sub.t0 > 0
        assert r.first_token_at == s.t1
    # the third request waits for a slot: its prefill comes after a decode
    assert pre[2].t0 > by["engine.decode"][0].t1
    assert engine.timings["prefill"] == [s.seconds for s in pre]
    assert engine.timings["decode"] == [s.seconds
                                        for s in by["engine.decode"]]
    assert [s.attrs["slots"] for s in by["engine.decode"]][0] == 2
    assert all(s.parent is None for s in pre + by["engine.decode"])
