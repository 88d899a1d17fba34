"""The port's two-tier host + disk ``FrameStore`` and its session wiring,
held against the JAX reference on the CPU:

* a spill-on ``trim`` demotes: frames go to npy segments and ``get``
  faults them back bit for bit through the LRU cache, with the
  reference's counters and segment names; a spill-off trim deletes;
* a ``spill_dir`` written by either package's ``FrameStore`` reopens in
  the other's with the same frames, bit for bit; reopening adopts the
  intact prefix (truncated, gapped and foreign files);
* ``VenusConfig(spill_dir=..., host_retain=...)`` bounds the host tier of
  every session, ``eviction="none"`` too, and every archived id reads
  back; ``cluster_merge``'s folded reservoirs and ``uniform`` draws read
  from disk; ``close_session`` releases both tiers;
* ``VenusService.io_stats()`` counts every demotion and fault, equal to
  the reference's.

Both packages get the same frames (numpy from a seeded generator, or the
same procedural world). The property over random append / trim / get
sequences is in ``tests/test_torch_spill_properties.py``.
"""

import os

import numpy as np
import pytest

from repro.core.memory import FrameStore as JStore
from repro.core.queryplan import QuerySpec as JSpec
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.data.video import PixelEmbedder as JPixel
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro.serving.venus_service import VenusService as JService
from repro_torch.core.memory import FrameStore
from repro_torch.core.queryplan import QuerySpec, build_plan
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.data.video import PixelEmbedder, VideoWorld, WorldConfig
from repro_torch.serving.venus_service import VenusService

CHUNK = 32


def _frames(seed, n, shape=(2, 2, 3)):
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32)


def _mgr(cfg):
    return SessionManager(cfg, PixelEmbedder(dim=64), embed_dim=64,
                          device="cpu")


def _jmgr(cfg):
    return JManager(cfg, JPixel(dim=64), embed_dim=64)


def _world(s=0, port=True):
    cfg = dict(n_scenes=4 + s, seed=50 + s)
    return (VideoWorld(WorldConfig(**cfg)) if port
            else JWorld(JWorldConfig(**cfg)))


def _chunk_at(w, t, chunk=CHUNK):
    lo = (t * chunk) % max(w.total_frames - chunk, 1)
    return np.asarray(w.frames[lo:lo + chunk], np.float32)


def _disk_usage(root) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


# ---------------------------------------------------------------- the store


def _roundtrip(cls, path):
    fs = cls(path, segment_frames=4, cache_segments=2)
    for i in range(5):
        fs.append(_frames(i, 7, (4, 4, 3)))
        fs.trim(len(fs) - 6)
    got = fs.get(list(range(len(fs))))
    return fs, got


def test_spill_roundtrip_matches_reference(tmp_path):
    """Demote, then fault every id back: the port's bytes, counters,
    bases and segment names are the reference's, and the frames are the
    appended ones bit for bit."""
    fs, got = _roundtrip(FrameStore, str(tmp_path / "t"))
    jfs, want = _roundtrip(JStore, str(tmp_path / "j"))
    assert got.tobytes() == want.tobytes() == np.concatenate(
        [_frames(i, 7, (4, 4, 3)) for i in range(5)]).tobytes()
    assert fs.retained == 6 and len(fs) == 35
    assert (fs.base, fs.trimmed, fs.spill_floor) == (29, 29, 0)
    assert fs.io_stats == jfs.io_stats
    assert fs.io_stats["spilled_frames"] == 29
    assert fs.io_stats["spilled_bytes"] == fs.disk_bytes == jfs.disk_bytes
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_segment_chunking_and_sync(tmp_path):
    for cls, name in ((FrameStore, "t"), (JStore, "j")):
        fs = cls(str(tmp_path / name), segment_frames=4)
        fs.append(np.arange(10 * 12, dtype=np.float32).reshape(10, 2, 2, 3))
        fs.trim(10)
        assert len(os.listdir(tmp_path / name)) == 3   # ceil(10 / 4)
        assert fs.sync() == 3 and fs.sync() == 0
        fs.trim(10)                                    # nothing to spill
        assert fs.sync() == 0
    assert sorted(os.listdir(tmp_path / "t")) == [
        "seg-000000000000-00004.npy", "seg-000000000004-00004.npy",
        "seg-000000000008-00002.npy"] == sorted(os.listdir(tmp_path / "j"))


def test_lru_cache_hit_and_fault_counters(tmp_path):
    stats = []
    for cls, name in ((FrameStore, "t"), (JStore, "j")):
        fs = cls(str(tmp_path / name), segment_frames=2, cache_segments=1)
        fs.append(np.arange(8 * 12, dtype=np.float32).reshape(8, 2, 2, 3))
        fs.trim(6)                          # segments [0,2) [2,4) [4,6)
        for i in (0, 1, 2, 0):              # fault, hit, fault, fault
            fs.get([i])
        stats.append(fs.io_stats)
    assert stats[0] == stats[1]
    assert (stats[0]["spill_faults"], stats[0]["spill_cache_hits"]) == (3, 1)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_dir_reopens_across_packages(tmp_path, writer):
    """A spill directory demoted by one package's store reopens in the
    other's: the same recovered base, every id bit for bit."""
    frames = _frames(1, 16, (3, 5, 3))
    write, read = ((JStore, FrameStore) if writer == "reference"
                   else (FrameStore, JStore))
    fs = write(str(tmp_path / "s"), segment_frames=4)
    fs.append(frames)
    fs.trim(13)
    fs.sync()
    back = read(str(tmp_path / "s"), segment_frames=4)
    assert (back.recovered_frames, back.dropped_segments) == (13, 0)
    assert back.base == len(back) == 13 and back.spill_floor == 0
    got = back.get(list(range(13)))
    assert got.dtype == np.float32
    assert got.tobytes() == frames[:13].tobytes()


def test_reopen_recovers_intact_segments(tmp_path):
    frames = _frames(1, 16)
    fs = FrameStore(str(tmp_path / "s0"), segment_frames=4)
    fs.append(frames)
    fs.trim(12)
    fs.sync()
    fs2 = FrameStore(str(tmp_path / "s0"), segment_frames=4)
    assert fs2.recovered_frames == 12 and fs2.dropped_segments == 0
    assert fs2.base == len(fs2) == 12 and fs2.spill_floor == 0
    assert fs2.get(list(range(12))).tobytes() == frames[:12].tobytes()


@pytest.mark.parametrize("cut", ["half", "empty"])
def test_reopen_detects_truncated_segment(tmp_path, cut):
    """The newest segment cut to half its bytes, or to none: the reopen
    adopts the intact prefix, deletes the short file and raises past the
    recovered base, as the reference's does; appends resume there."""
    frames = _frames(2, 16)
    for cls, name in ((FrameStore, "t"), (JStore, "j")):
        fs = cls(str(tmp_path / name), segment_frames=4)
        fs.append(frames)
        fs.trim(12)                         # [0,4) [4,8) [8,12)
        fs.sync()
        newest = tmp_path / name / sorted(os.listdir(tmp_path / name))[-1]
        with open(newest, "r+b") as f:
            f.truncate(os.path.getsize(newest) // 2 if cut == "half" else 0)
        fs2 = cls(str(tmp_path / name), segment_frames=4)
        assert fs2.recovered_frames == 8 and fs2.dropped_segments == 1
        assert fs2.base == len(fs2) == 8 and not newest.exists()
        assert fs2.get(list(range(8))).tobytes() == frames[:8].tobytes()
        with pytest.raises(IndexError):
            fs2.get([9])
        fs2.append(frames[:2])
        assert fs2.get([8, 9]).tobytes() == frames[:2].tobytes()


def test_reopen_ignores_gapped_and_foreign_files(tmp_path):
    frames = _frames(3, 12)
    fs = FrameStore(str(tmp_path / "s0"), segment_frames=4)
    fs.append(frames)
    fs.trim(12)
    fs.sync()
    segs = sorted(os.listdir(tmp_path / "s0"))
    os.remove(tmp_path / "s0" / segs[1])    # a gap at [4,8)
    (tmp_path / "s0" / "notes.txt").write_text("not a segment")
    fs2 = FrameStore(str(tmp_path / "s0"), segment_frames=4)
    assert fs2.recovered_frames == 4 and fs2.dropped_segments == 1
    assert fs2.get([0, 1, 2, 3]).tobytes() == frames[:4].tobytes()
    assert not (tmp_path / "s0" / segs[2]).exists()
    assert (tmp_path / "s0" / "notes.txt").exists()   # not ours: kept


def test_spill_off_contract_unchanged():
    fs = FrameStore()
    fs.append(np.ones((5, 2, 2, 3), np.float32))
    fs.trim(3)
    assert fs.spill_floor == fs.base == 3 and fs.trimmed == 3
    with pytest.raises(IndexError, match="trimmed from the archive"):
        fs.get([2])
    assert fs.sync() == 0 and fs.disk_bytes == 0
    assert fs.io_stats["spilled_frames"] == 0


def test_close_releases_disk(tmp_path):
    spill = tmp_path / "s0"
    fs = FrameStore(str(spill), segment_frames=2)
    fs.append(np.ones((6, 2, 2, 3), np.float32))
    fs.trim(4)
    fs.get([0])
    assert fs.disk_bytes > 0 and spill.exists()
    fs.close()
    assert fs.disk_bytes == 0 and fs.retained == 0 and not spill.exists()
    fs.close()                              # idempotent
    assert fs.io_stats["spilled_frames"] == 4   # kept for the fold


def test_config_validation_matches_reference(tmp_path):
    cases = [("requires spill_dir", dict(host_retain=64)),
             ("host_retain must be >= 1",
              dict(spill_dir=str(tmp_path), host_retain=0)),
             ("spill_segment_frames", dict(spill_segment_frames=0)),
             ("spill_cache_segments", dict(spill_cache_segments=-1))]
    for match, kw in cases:
        with pytest.raises(ValueError, match=match) as got:
            VenusConfig(**kw)
        with pytest.raises(ValueError) as want:
            JConfig(**kw)
        assert str(got.value) == str(want.value)
    VenusConfig(spill_dir=str(tmp_path), host_retain=64)


# ---------------------------------------------------------------- sessions


def _host_retain_run(make, world, root, retain=48):
    cfg = dict(max_partition_len=32, spill_dir=str(root), host_retain=retain,
               spill_segment_frames=16)
    mgr = make(cfg)
    sid = mgr.create_session()
    assert mgr[sid].memory.eviction.name == "none"
    frames = []
    t = 0
    while sum(len(c) for c in frames) < 4 * retain:
        frames.append(_chunk_at(world, t))
        t += 1
        mgr.ingest_tick({sid: frames[-1]})
        assert mgr[sid].frames.retained <= retain
    return mgr, np.concatenate(frames)


def test_none_session_host_retain_bounded_and_bit_identical(tmp_path):
    """An ``eviction="none"`` session ingesting ≥ 4 × ``host_retain``
    frames keeps ``retained`` within it while every archived id reads
    back bit for bit, each demotion and fault counted, no restack — with
    the reference's counters and segments."""
    mgr, frames = _host_retain_run(
        lambda kw: _mgr(VenusConfig(**kw)), _world(), tmp_path / "t")
    jmgr, _ = _host_retain_run(
        lambda kw: _jmgr(JConfig(**kw)), _world(port=False), tmp_path / "j")
    fs = mgr[0].frames
    assert len(fs) == len(frames) >= 4 * 48 and fs.retained <= 48
    assert (fs.io_stats["spilled_frames"] == fs.trimmed
            == len(fs) - fs.retained > 0)
    ids = list(range(len(fs)))
    assert fs.get(ids).tobytes() == frames.tobytes()
    assert (fs.io_stats["spill_faults"] + fs.io_stats["spill_cache_hits"]
            == fs.trimmed)
    assert fs.io_stats["spill_faults"] >= 1
    jfs = jmgr[0].frames
    jfs.get(ids)
    assert fs.io_stats == jfs.io_stats
    assert mgr.io_stats == jmgr.io_stats
    assert mgr[0].stats == jmgr[0].stats
    assert mgr.io_stats["archive_trimmed_frames"] == fs.trimmed
    assert mgr.io_stats["stack_rebuilds"] == 0
    assert os.listdir(tmp_path / "t" / "session-00000") and sorted(
        os.listdir(tmp_path / "t" / "session-00000")) == sorted(
        os.listdir(tmp_path / "j" / "session-00000"))


def test_cluster_merge_folded_reservoirs_fault_from_disk(tmp_path):
    """Under ``cluster_merge`` and a small ``host_retain``, reservoirs
    reference frames the host tier demoted: their reads fault from disk
    bit for bit, on a recycled arena slot too."""
    cfg = VenusConfig(max_partition_len=32, memory_capacity=16,
                      eviction="cluster_merge", spill_dir=str(tmp_path),
                      host_retain=40, spill_segment_frames=8)
    mgr = _mgr(cfg)
    w = _world()

    def drive(sid):
        frames = []
        for t in range(8):
            frames.append(_chunk_at(w, t))
            mgr.ingest_tick({sid: frames[-1]})
        frames = np.concatenate(frames)
        fs = mgr[sid].frames
        lo = mgr[sid].memory.min_live_frame()
        assert lo < fs.base, (lo, fs.base)  # past live references
        assert fs.get([lo]).tobytes() == frames[lo].tobytes()
        res = mgr.query(sid, "anything",
                        query_emb=np.full(64, 0.125, np.float32))
        assert fs.get(res.frame_ids).tobytes() == \
            frames[res.frame_ids].tobytes()
        return fs

    fs = drive(mgr.create_session())
    assert fs.io_stats["spill_faults"] >= 1
    mgr.close_session(0)
    sid2 = mgr.create_session()             # recycles the slot
    assert mgr.arena.io_stats["slot_reuses"] == 1
    drive(sid2)
    assert mgr.io_stats["stack_rebuilds"] == 0


def test_churn_disk_usage_returns_to_baseline(tmp_path):
    """create → ingest → close leaks neither RSS nor disk: the spill
    segments go with the session, and its counters fold into
    ``closed_frame_stats``."""
    cfg = VenusConfig(max_partition_len=32, spill_dir=str(tmp_path),
                      host_retain=32, spill_segment_frames=8)
    mgr = _mgr(cfg)
    w = _world()
    for _ in range(3):
        sid = mgr.create_session()
        frames = []
        for t in range(5):
            frames.append(_chunk_at(w, t))
            mgr.ingest_tick({sid: frames[-1]})
        fs = mgr[sid].frames
        assert fs.disk_bytes > 0 and _disk_usage(tmp_path) > 0
        assert fs.get(list(range(len(fs)))).tobytes() == \
            np.concatenate(frames).tobytes()
        mgr.close_session(sid)
        assert _disk_usage(tmp_path) == 0
        assert not os.listdir(tmp_path)
    assert mgr.io_stats["sessions_closed"] == 3
    assert mgr.closed_frame_stats["spilled_frames"] > 0


def test_uniform_rejected_without_spill_legal_with(tmp_path):
    w = _world()
    mgr = _mgr(VenusConfig(max_partition_len=32, memory_capacity=16,
                           eviction="sliding_window"))
    jmgr = _jmgr(JConfig(max_partition_len=32, memory_capacity=16,
                         eviction="sliding_window"))
    for m, spec in ((mgr, QuerySpec), (jmgr, JSpec)):
        sid = m.create_session()
        m.ingest_tick({sid: _chunk_at(w, 0)})
    with pytest.raises(ValueError) as got:
        mgr.plan([QuerySpec(sid=sid, text="x", strategy="uniform")])
    with pytest.raises(ValueError) as want:
        jmgr.plan([JSpec(sid=sid, text="x", strategy="uniform")])
    assert str(got.value) == str(want.value)
    assert f"session {sid}" in str(got.value)
    assert "sliding_window" in str(got.value)
    # window eviction with spill: legal, and every draw reads from disk
    mgr3 = _mgr(VenusConfig(max_partition_len=32, memory_capacity=16,
                            eviction="sliding_window",
                            spill_dir=str(tmp_path), host_retain=40))
    sid3 = mgr3.create_session()
    frames = []
    for t in range(6):
        frames.append(_chunk_at(w, t))
        mgr3.ingest_tick({sid3: frames[-1]})
    res = mgr3.query_specs([QuerySpec(
        sid=sid3, strategy="uniform", budget=8,
        embedding=np.full(64, 0.125, np.float32))])[0]
    fs = mgr3[sid3].frames
    assert fs.base > 0 and len(res.frame_ids) > 0
    assert fs.get(res.frame_ids).tobytes() == \
        np.concatenate(frames)[res.frame_ids].tobytes()
    # without sessions, build_plan has no gate
    build_plan([QuerySpec(sid=sid, text="x", strategy="uniform")], mgr.cfg)


def _service_run(svc, make_world, root):
    w = make_world()
    sid = svc.create_stream()
    for t in range(5):
        svc.ingest_tick({sid: _chunk_at(w, t)})
    fs = svc.manager[sid].frames
    fs.get(list(range(len(fs))))
    before = svc.io_stats()
    svc.close_stream(sid)
    return before, svc.io_stats()


def test_service_io_stats_accounts_spill(tmp_path):
    """``io_stats`` counts every demotion and fault, stays monotonic across
    a close while the disk gauge drops to 0: the reference's numbers."""
    kw = dict(max_partition_len=32, host_retain=32, spill_segment_frames=8)
    got = _service_run(VenusService(_mgr(VenusConfig(
        spill_dir=str(tmp_path / "t"), **kw)), None), _world,
        tmp_path / "t")
    want = _service_run(JService(_jmgr(JConfig(
        spill_dir=str(tmp_path / "j"), **kw)), None),
        lambda: _world(port=False), tmp_path / "j")
    keys = ("spilled_frames", "spilled_bytes", "spill_faults",
            "spill_cache_hits", "spill_disk_bytes", "archive_trimmed_frames")
    for g, w in zip(got, want):
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
    before, after = got
    assert before["spilled_frames"] == before["archive_trimmed_frames"] > 0
    assert before["spill_faults"] >= 1 and before["spill_disk_bytes"] > 0
    assert after["spilled_frames"] == before["spilled_frames"]
    assert after["spill_disk_bytes"] == 0
