"""The port's lifecycle pieces held against the JAX reference on the CPU:
eviction by ``cluster_merge`` (the reference's four cases of
``tests/test_lifecycle.py``), the merge threshold, the per-memory
expansion API, and the aux-model prompts (paper Eq. 2) through
``SessionManager`` with the MEM embedder.

Both packages take the same numpy inputs. Host mirrors, counters, draws
and frame ids must be equal: the merge arithmetic is the same numpy, and
the reservoir picks are exact integers. MEM embeddings are products
summed in another order: allclose at rtol 1e-5 / atol 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.venus_mem import smoke_config as jsmoke_config
from repro.core import memory as jmemory
from repro.core.aux_models import DetectorStub as JDetector
from repro.core.aux_models import OCRStub as JOCR
from repro.core.aux_models import build_aux_prompt as jbuild_aux_prompt
from repro.core.pipeline import MEMEmbedder as JEmbedder
from repro.core.queryplan import QuerySpec as JSpec
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.data.video import OracleEmbedder as JOracle
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro.models.mem import MEM as JMEM
from repro_torch.configs.venus_mem import smoke_config
from repro_torch.core import memory as tmemory
from repro_torch.core.aux_models import (DetectorStub, OCRStub,
                                         build_aux_prompt)
from repro_torch.core.convert import mem_params_from_numpy
from repro_torch.core.pipeline import MEMEmbedder
from repro_torch.core.queryplan import QuerySpec
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.data.video import OracleEmbedder, VideoWorld, WorldConfig
from repro_torch.models.mem import MEM

MIRRORS = ("_emb", "_members", "_member_count", "_index_frame", "_head",
           "_size")


def _memory(pkg, *args, **kw):
    if pkg is tmemory:
        kw["device"] = "cpu"
    return pkg.VenusMemory(*args, **kw)


def _insert(mem, rows, fids, members):
    mem.insert_batch(np.asarray(rows, np.float32),
                     scene_ids=[0] * len(fids), index_frames=fids,
                     member_lists=members)


def _assert_same_memory(tm, jm):
    for f in MIRRORS:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    assert tm.io_stats == jm.io_stats


# ---------------------------------------------------------------------------
# cluster_merge: the reference's four cases, in both packages
# ---------------------------------------------------------------------------


def _merge_folds(pkg):
    """An evictee similar to a survivor donates its reservoir before it
    leaves; a dissimilar one is dropped (two memories)."""
    rng = np.random.default_rng(3)
    cap, dim = 4, 8
    mem = _memory(pkg, cap, dim, member_cap=8, eviction="cluster_merge")
    base = rng.normal(0, 1, (dim,)).astype(np.float32)
    other = rng.normal(0, 1, (dim,)).astype(np.float32)
    rows = np.stack([base, other, base + 1e-3, -other])
    _insert(mem, rows, [10, 11, 12, 13], [[10, 100], [11], [12], [13]])
    _insert(mem, rng.normal(0, 1, (1, dim)), [14], [[14]])
    fids = mem.expand_draws_device(np.asarray([2] * 8), np.ones(8, bool),
                                   seed=1)
    mem2 = _memory(pkg, cap, dim, member_cap=8,
                   eviction=pkg.get_eviction_policy("cluster_merge"))
    _insert(mem2, rows, [10, 11, 12, 13], [[10], [11], [12], [13]])
    _insert(mem2, rows[:1] * 0.5, [14], [[14]])
    _insert(mem2, rng.normal(0, 1, (1, dim)), [15], [[15]])
    return [mem, mem2], fids


def _merge_none_above(pkg):
    """No survivor clears the threshold: plain sliding window."""
    rng = np.random.default_rng(9)
    mem = _memory(pkg, 4, 8, member_cap=8,
                  eviction=pkg.get_eviction_policy("cluster_merge",
                                                   threshold=0.999))
    _insert(mem, np.eye(8)[:4], [10, 11, 12, 13],
            [[10, 100], [11], [12], [13]])
    _insert(mem, rng.normal(0, 1, (2, 8)), [14, 15], [[14], [15]])
    return [mem], None


def _merge_need_exceeds(pkg):
    """One batch overruns the live window: nothing to fold into, and the
    window moves as a sliding window's does."""
    rng = np.random.default_rng(10)
    cap, dim, n = 8, 8, 13
    first = rng.normal(0, 1, (3, dim))
    rows = rng.normal(0, 1, (n, dim))
    out = []
    for policy in ("cluster_merge", "sliding_window"):
        mem = _memory(pkg, cap, dim, member_cap=4, eviction=policy)
        _insert(mem, first, [0, 1, 2], [[0], [1], [2]])
        _insert(mem, rows, list(range(3, 3 + n)),
                [[i] for i in range(3, 3 + n)])
        out.append(mem)
    return out, None


MERGE_CASES = {"folds": _merge_folds, "no_survivor": _merge_none_above,
               "need_exceeds_window": _merge_need_exceeds}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_cluster_merge_matches_reference(case):
    tmems, tfids = MERGE_CASES[case](tmemory)
    jmems, jfids = MERGE_CASES[case](jmemory)
    for tm, jm in zip(tmems, jmems):
        _assert_same_memory(tm, jm)
    if case == "folds":
        np.testing.assert_array_equal(tfids, jfids)
        mem, mem2 = tmems
        assert mem.io_stats["reservoir_merges"] == 1
        assert set(mem._members[2, :3].tolist()) == {12, 10, 100}
        assert {10, 100} <= set(int(f) for f in tfids) | {12}
        assert mem2.io_stats["evicted_rows"] == 2
    elif case == "no_survivor":
        mem, = tmems
        assert mem.io_stats["evicted_rows"] == 2
        assert mem.io_stats["reservoir_merges"] == 0
    else:
        merged, window = tmems
        assert merged.window == window.window and merged.size == 8
        np.testing.assert_array_equal(merged._emb, window._emb)


def _clustered(rng, n, centres):
    rows = centres[rng.integers(0, len(centres), n)]
    rows = rows + 0.05 * rng.normal(size=rows.shape)
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


def test_cluster_merge_on_recycled_slot_matches_reference():
    """The reference's fourth case: a recycled arena slot folds only
    into its new tenant's survivors. Two sessions fill past capacity,
    one closes, a new one takes its slot and fills past capacity too;
    both packages merge alike, and the queries over the recycled slot
    agree. Rows go in directly, a tick each (no clustering)."""
    rng = np.random.default_rng(31)
    centres = rng.normal(size=(6, 32))
    feeds = [_clustered(rng, 40, centres) for _ in range(3)]
    kw = dict(memory_capacity=16, member_cap=8, eviction="cluster_merge")
    j = JManager(JConfig(**kw), None, embed_dim=32)
    t = SessionManager(VenusConfig(**kw), None, embed_dim=32, device="cpu")

    def feed(m, sid, rows, fid0):
        for lo in range(0, len(rows), 5):
            fids = list(range(fid0 + lo, fid0 + min(lo + 5, len(rows))))
            with m.arena.deferred_appends():
                _insert(m[sid].memory, rows[lo:lo + 5], fids,
                        [[f, f + 500] for f in fids])

    for m in (j, t):
        for sid in (0, 1):
            m.create_session(sid)
            feed(m, sid, feeds[sid], 1000 * sid)
        m.close_session(1)
        m.create_session(2)
        feed(m, 2, feeds[2], 2000)
        feed(m, 0, feeds[2][::-1], 3000)
    assert t[2].memory.slot == 1
    for sid in (0, 2):
        _assert_same_memory(t[sid].memory, j[sid].memory)
        assert t[sid].memory.io_stats["reservoir_merges"] > 0
    assert t.arena.io_stats["slot_reuses"] == 1
    qe = centres[:4].astype(np.float32)
    sids = [0, 2, 2, 0]
    for kw in (dict(), dict(budget=8, use_akr=False)):
        got = t.query_batch_cross(sids, query_embs=qe, **kw)
        want = j.query_batch_cross(sids, query_embs=qe, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
            np.testing.assert_array_equal(a.draws, b.draws)
            assert a.n_drawn == b.n_drawn


@pytest.mark.parametrize("threshold", [0.0, -0.5, 1.5, 0.5, 1.0, None])
def test_merge_threshold_matches_reference(threshold):
    """(0, 1] or a ValueError, in ``get_eviction_policy`` and from
    ``VenusConfig.merge_threshold`` into the session's policy."""
    for policy in ("cluster_merge", "consolidate"):
        if threshold is not None and not 0 < threshold <= 1:
            for pkg in (tmemory, jmemory):
                with pytest.raises(ValueError, match="threshold"):
                    pkg.get_eviction_policy(policy, threshold=threshold)
            continue
        got = tmemory.get_eviction_policy(policy, threshold=threshold)
        want = jmemory.get_eviction_policy(policy, threshold=threshold)
        assert (got.name, got.threshold) == (want.name, want.threshold)
        mgr = SessionManager(VenusConfig(memory_capacity=8, eviction=policy,
                                         merge_threshold=threshold,
                                         coarse_capacity=4, coarse_block=4),
                             OracleEmbedder(VideoWorld(WorldConfig()),
                                            dim=8), embed_dim=8,
                             device="cpu")
        assert mgr[mgr.create_session()].memory.eviction.threshold == \
            want.threshold
    pol = tmemory.ConsolidationEviction(threshold=0.7)
    assert tmemory.get_eviction_policy(pol) is pol


# ---------------------------------------------------------------------------
# the per-memory expansion API
# ---------------------------------------------------------------------------


def _expansion_memory(pkg):
    """A memory whose reservoirs hold 0 to 12 members (some sampled down
    to member_cap 8 by the reservoir's rng), wrapped once."""
    rng = np.random.default_rng(12)
    mem = _memory(pkg, 16, 8, member_cap=8, eviction="sliding_window",
                  seed=4)
    for start in (0, 12):
        fids = list(range(start, start + 12))
        members = [list(range(100 * f, 100 * f + (f % 13))) for f in fids]
        _insert(mem, rng.normal(0, 1, (12, 8)), fids, members)
    return mem


@pytest.mark.parametrize("method", ["expand_draws", "expand_draws_batch",
                                    "expand_draws_device",
                                    "_expand_draws_loop"])
def test_expansion_api_matches_reference(method):
    tm, jm = _expansion_memory(tmemory), _expansion_memory(jmemory)
    _assert_same_memory(tm, jm)
    rng = np.random.default_rng(5)
    draws = rng.integers(-1, 16, size=(3, 40))
    valid = rng.random((3, 40)) < 0.8
    for seed in (0, 7):
        if method == "expand_draws_batch":
            got = tm.expand_draws_batch(draws, valid, seed=seed)
            want = jm.expand_draws_batch(draws, valid, seed=seed)
        else:
            got = [getattr(tm, method)(d, v, seed=seed)
                   for d, v in zip(draws, valid)]
            want = [getattr(jm, method)(d, v, seed=seed)
                    for d, v in zip(draws, valid)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert len(a) > 0
    assert tm.io_stats == jm.io_stats
    # every path agrees with the loop, draw for draw
    loop = [tm._expand_draws_loop(d, v, seed=3)
            for d, v in zip(draws, valid)]
    for a, b in zip(tm.expand_draws_batch(draws, valid, seed=3), loop):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.index_frames([0, 5, 15]),
                                  jm.index_frames([0, 5, 15]))
    for a, b in zip(tm.members_table(), jm.members_table()):
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# aux-model prompts (paper Eq. 2) through the session manager
# ---------------------------------------------------------------------------


def test_aux_prompts_match_reference():
    w = VideoWorld(WorldConfig(n_scenes=2, seed=1))
    for f in range(0, w.total_frames, 7):
        ann = w.annotations(f)
        assert build_aux_prompt([OCRStub(), DetectorStub()], None, ann) == \
            jbuild_aux_prompt([JOCR(), JDetector()], None, ann)
    assert build_aux_prompt([OCRStub()], None, None) == ""


def _f32(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype="float32"),
        vision=dataclasses.replace(cfg.vision, dtype="float32"))


def test_session_manager_aux_models_match_reference():
    """``SessionManager(aux_models=, annotation_fn=)`` on MEM at smoke
    width in float32 with the reference's weights: each index frame is
    embedded with its OCR and detector prompt, the same rows as the
    reference's (allclose), the same reservoirs and frame ids."""
    jcfg = _f32(jsmoke_config())
    jmem = JMEM(jcfg)
    params = jmem.init(jax.random.key(0))
    tmem = MEM.init(_f32(smoke_config()), device="cpu")
    tmem.load_state_dict(mem_params_from_numpy(jax.tree.map(np.asarray,
                                                            params)))
    wcfg = dict(n_scenes=5, seed=21)
    jw, tw = JWorld(JWorldConfig(**wcfg)), VideoWorld(WorldConfig(**wcfg))
    cfg = dict(memory_capacity=64)
    j = JManager(JConfig(**cfg), JEmbedder(jmem, params), embed_dim=64,
                 aux_models=[JOCR(), JDetector()],
                 annotation_fn=jw.annotations)
    t = SessionManager(VenusConfig(**cfg), MEMEmbedder(tmem), embed_dim=64,
                       aux_models=[OCRStub(), DetectorStub()],
                       annotation_fn=tw.annotations, device="cpu")
    plain = SessionManager(VenusConfig(**cfg), MEMEmbedder(tmem),
                           embed_dim=64, device="cpu")
    for m, w in ((j, jw), (t, tw), (plain, tw)):
        m.create_session(0)
        m.ingest_tick({0: w.frames})
        m.flush()
    assert t[0].stats == j[0].stats
    jm, tm = j[0].memory, t[0].memory
    for f in MIRRORS[1:]:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    np.testing.assert_allclose(tm._emb, jm._emb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.arena.emb.numpy(), np.asarray(j.arena.emb),
                               rtol=1e-5, atol=1e-5)
    # the prompts reached the embeddings: without them the rows differ
    n = tm.size
    assert any(tw.annotations(int(f))["text"] for f in tm._index_frame[:n])
    assert np.abs(plain[0].memory._emb[:n] - tm._emb[:n]).max() > 1e-3
    qe = np.asarray(JEmbedder(jmem, params).embed_queries(
        ["a red car", "text: exit", "objects: dog", "person walking"]))
    for strategy, budget in (("akr", None), ("sampling", 8), ("topk", 4)):
        got = t.execute(t.plan([QuerySpec(sid=0, embedding=q,
                                          strategy=strategy, budget=budget)
                                for q in qe]))
        want = j.execute(j.plan([JSpec(sid=0, embedding=q, strategy=strategy,
                                       budget=budget) for q in qe]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
            assert a.n_drawn == b.n_drawn
