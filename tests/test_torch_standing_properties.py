"""Property tests of the port's standing queries
(``repro_torch.core.standing``), the reference's
``tests/test_standing_properties.py`` run on the port's own twins, with
its ``max_examples``:

* replay equivalence — any register / unregister / tick sequence fires
  the identical alert stream (scores bit for bit) when replayed op for
  op on a fresh manager;
* readability at fire time — every alert's frame ids resolve through
  ``FrameStore.get`` when polled, and with the spill tier on, forever.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core.queryplan import QuerySpec  # noqa: E402
from repro_torch.core.session import (SessionManager,  # noqa: E402
                                      VenusConfig)
from repro_torch.data.video import PixelEmbedder  # noqa: E402

DIM = 32


def _unit(rows):
    rows = np.asarray(rows, np.float32)
    return rows / (np.linalg.norm(rows, axis=-1, keepdims=True) + 1e-12)


class ArrayEmbedder:
    """Managers fed by direct ``insert_batch`` calls embed nothing."""

    def embed_queries(self, texts):
        raise AssertionError("tests pass explicit embeddings")

    def embed_frames(self, frames, aux=None, frame_ids=None):
        raise AssertionError("tests insert rows directly")


def _insert(mgr, sid, rows, fid0):
    mem = mgr.sessions[sid].memory
    fids = np.arange(fid0, fid0 + len(rows))
    with mgr.arena.deferred_appends():
        return mem.insert_batch(rows, scene_ids=[0] * len(rows),
                                index_frames=fids,
                                member_lists=[[int(f)] for f in fids])


def _block_chunk(rng, n=16, hw=16, pool=8):
    """n identical frames of one block-structured scene, zero-centred at
    the embedder's pool scale."""
    blocks = rng.uniform(-1, 1, (hw // pool, hw // pool, 3)
                         ).astype(np.float32)
    frame = np.kron(blocks, np.ones((pool, pool, 1), np.float32))
    return np.broadcast_to(frame, (n,) + frame.shape).copy()




def _draw_ops(data):
    """A concrete op list, every array made up front, so a replay applies
    exactly the same inputs."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    ops = []
    for _ in range(data.draw(st.integers(3, 10))):
        kind = data.draw(st.sampled_from(["register", "unregister",
                                          "tick", "tick"]))
        if kind == "register":
            ops.append(("register", {
                "s": data.draw(st.integers(0, 1)),
                "emb": _unit(rng.normal(size=(1, DIM)))[0],
                "budget": data.draw(st.integers(1, 4)),
                "threshold": data.draw(st.sampled_from(
                    [-1.0, 0.2, 0.6, 0.9])),
                "hysteresis": data.draw(st.sampled_from([0.0, 0.1])),
                "cooldown": data.draw(st.integers(0, 2)),
            }))
        elif kind == "unregister":
            ops.append(("unregister", None))
        else:
            counts = [data.draw(st.integers(0, 5)) for _ in range(2)]
            ops.append(("tick", [_unit(rng.normal(size=(n, DIM)))
                                 if n else None for n in counts]))
    return ops


def _apply(ops):
    """The op list on a fresh port manager → the alert stream."""
    mgr = SessionManager(VenusConfig(memory_capacity=128, member_cap=8),
                         ArrayEmbedder(), embed_dim=DIM, device="cpu")
    sids = [mgr.create_session(), mgr.create_session()]
    fid = [0, 0]
    stream = []
    for kind, arg in ops:
        if kind == "register":
            sid = sids[arg["s"]]
            mgr.register_standing(
                sid, QuerySpec(sid=sid, embedding=arg["emb"],
                               strategy="topk", budget=arg["budget"]),
                threshold=arg["threshold"], hysteresis=arg["hysteresis"],
                cooldown_ticks=arg["cooldown"])
        elif kind == "unregister":
            if mgr.standing.entries:        # the lowest live id
                mgr.unregister_standing(min(mgr.standing.entries))
        else:
            phys = {}
            for s, rows in enumerate(arg):
                if rows is not None:
                    phys[sids[s]] = _insert(mgr, sids[s], rows, fid[s])
                    fid[s] += len(rows)
            if phys:
                for a in mgr.standing.evaluate(
                        mgr.sessions, {s: [p] for s, p in phys.items()},
                        mgr.io_stats):
                    stream.append((a.sid, a.spec_id, a.score,
                                   tuple(int(f) for f in a.frame_ids),
                                   a.tick))
    return stream, (mgr.io_stats["alerts_fired"],
                    mgr.io_stats["alerts_suppressed"])


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_replay_fires_identical_alert_stream(data):
    """Any register / unregister / tick sequence replayed op for op on a
    fresh manager fires the identical alert stream, scores bit for bit."""
    ops = _draw_ops(data)
    assert _apply(ops) == _apply(ops)


@settings(max_examples=8, deadline=None)
@given(data=st.data(), spill=st.booleans())
def test_alert_frame_ids_readable_at_fire_time(data, spill):
    """Target and noise scenes through the ingest path of a window-
    evicting session that trims its archive: every polled alert's frame
    ids resolve through ``FrameStore.get`` — host frames, or spill faults
    with the tier on; after the flush too, with spill."""
    tmp = tempfile.mkdtemp() if spill else None
    try:
        cfg = VenusConfig(max_partition_len=32, memory_capacity=64,
                          member_cap=8, eviction="sliding_window",
                          spill_dir=(os.path.join(tmp, "s") if spill
                                     else None),
                          spill_segment_frames=8,
                          host_retain=16 if spill else None)
        embedder = PixelEmbedder(dim=64)
        mgr = SessionManager(cfg, embedder, embed_dim=64, device="cpu")
        sid = mgr.create_session()
        target = _block_chunk(np.random.default_rng(
            data.draw(st.integers(0, 2**31 - 1))))
        mgr.register_standing(
            sid, QuerySpec(sid=sid, strategy="topk", budget=4,
                           embedding=np.asarray(
                               embedder.embed_frames(target)[0],
                               np.float32)),
            threshold=0.9, hysteresis=0.1)
        noise = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
        n_alerts = 0
        for _ in range(data.draw(st.integers(4, 8))):
            match = data.draw(st.booleans())
            mgr.ingest_tick({sid: target.copy() if match
                             else _block_chunk(noise)})
            for a in mgr.poll_alerts():
                n_alerts += 1
                got = mgr[sid].frames.get([int(f) for f in a.frame_ids])
                assert got.shape[0] == len(a.frame_ids)
        mgr.flush()
        for a in mgr.poll_alerts():
            n_alerts += 1
            ids = [int(f) for f in a.frame_ids]
            if spill:
                assert mgr[sid].frames.get(ids).shape[0] == len(ids)
        assert mgr.io_stats["alerts_fired"] == n_alerts
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
