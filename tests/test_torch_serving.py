"""The PyTorch port's serving path held against the JAX reference on the
CPU, at smoke width with the reference's own weights (``Transformer.init``
as numpy, carried across by ``model_params_from_numpy``), in float32:

* the model: prefill → decode parity and right-padded prefill, for
  qwen2-vl-7b (with vision embeddings, M-RoPE) and minicpm3-4b (MLA with
  query LoRA, tied embeddings); logits at rtol/atol 1e-4;
* the continuous-batching engine: 5 requests over 2 slots, greedy, the
  same generated tokens as the reference's engine. Every step's top-1 /
  top-2 logit gap must be above ``GAP`` (20x the largest logit difference
  seen between the packages), so a near-tie fails loudly instead of
  flipping a token;
* ``VenusService.answer`` over two streams driven by ``OracleEmbedder``:
  the same frame ids and the same generated tokens;
* ``VenusService.io_stats()`` and the surfaces under it (manager, arena,
  memories): the reference's key sets, and its values on ported paths.
"""

import jax
import jax.numpy as jnp
import time

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.session import SessionManager as JManager
from repro.core.session import VenusConfig as JConfig
from repro.data.video import OracleEmbedder as JOracle
from repro.data.video import VideoWorld as JWorld
from repro.data.video import WorldConfig as JWorldConfig
from repro.models.transformer import Transformer as JTransformer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.venus_service import StreamQuery as JQuery
from repro.serving.venus_service import VenusService as JService
from repro_torch.configs import registry as tregistry
from repro_torch.core.convert import model_params_from_numpy
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.data.video import OracleEmbedder, VideoWorld, WorldConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import prng
from repro_torch.models.transformer import init_model
from repro_torch.serving import (Request, ServingEngine, StreamQuery,
                                 VenusService, make_prefill_step,
                                 make_serve_step)

LOGITS = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4
# io_stats values the port counts otherwise (ROADMAP Queue 3), by
# use_arena: the reference counts the pow2 bucket rows of each padded
# scatter, the port the rows it writes
IO_STATS_NOT_EQUAL = {
    True: frozenset({"arena_appended_rows"}),
    False: frozenset({"mem_appended_rows", "mem_appended_member_rows"})}
ARCHS = ["qwen2-vl-7b", "minicpm3-4b"]


@pytest.fixture(autouse=True)
def _reset_port_counters():
    tops.reset_scan_counts()
    tops.reset_kernel_launches()
    yield


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    """(reference model, its params, port model with the same weights),
    both in float32. The reference model's ``apply`` runs under
    ``jax.jit`` (one compile per shape and mode instead of one per
    primitive)."""
    arch = request.param
    jcfg = jregistry.get_smoke_config(arch).replace(dtype="float32")
    tcfg = tregistry.get_smoke_config(arch).replace(dtype="float32")
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    jm.apply = jax.jit(jm.apply, static_argnames=("mode",))
    return jm, params, tm


def _vision(cfg, rng, b):
    if cfg.family != "vlm":
        return {}, {}
    ve = (rng.standard_normal((b, cfg.vision_tokens, cfg.d_model))
          * 0.02).astype(np.float32)
    return {"vision_embeds": jnp.asarray(ve)}, {
        "vision_embeds": torch.from_numpy(ve)}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


# ---------------------------------------------------------------------------
# (c) the model: prefill → decode parity, right-padded prefill
# ---------------------------------------------------------------------------


def test_prefill_decode_parity(twin):
    """The port's version of tests/test_models.py::
    test_prefill_decode_parity: prefill then decode logits equal the
    reference's (rtol/atol 1e-4) and the port's own train-mode logits
    (rtol/atol 1e-3, the reference test's bound)."""
    jm, params, tm = twin
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    b, s, extra = 2, 20, 4
    tok = rng.integers(0, cfg.vocab_size, (b, s + extra)).astype(np.int32)
    jkw, tkw = _vision(cfg, rng, b)
    nv = cfg.vision_tokens if cfg.family == "vlm" else 0
    full, _, _ = tm.apply(torch.from_numpy(tok), mode="train", **tkw)
    jc = jm.init_cache(b, s + extra + nv, dtype=jnp.float32)
    tc = tm.init_cache(b, s + extra + nv, dtype=torch.float32)
    jl, jc, _ = jm.apply(params, jnp.asarray(tok[:, :s]), mode="prefill",
                         cache=jc, **jkw)
    tl, tc, _ = tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                         cache=tc, **tkw)
    _close(tl, jl)
    assert tc["pos"].tolist() == [s + nv] * b
    for t in range(extra):
        step = tok[:, s + t:s + t + 1]
        jl, jc, _ = jm.apply(params, jnp.asarray(step), mode="decode",
                             cache=jc)
        tl, tc, _ = tm.apply(torch.from_numpy(step), mode="decode",
                             cache=tc)
        _close(tl, jl)
        np.testing.assert_allclose(tl[:, 0].numpy(),
                                   full[:, nv + s + t].numpy(),
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if "mrope_delta" in jc:
        np.testing.assert_array_equal(tc["mrope_delta"].numpy(),
                                      np.asarray(jc["mrope_delta"]))


def test_prompt_lengths_padding_equivalence(twin):
    """The port's version of tests/test_models.py::
    test_prompt_lengths_padding_equivalence: right-padded prefill with
    prompt_lengths equals exact-length prefill, and decode continues
    identically; the padded run matches the reference's."""
    jm, params, tm = twin
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    padded = np.pad(tok, ((0, 0), (0, 19)))
    jkw, tkw = _vision(cfg, rng, 1)
    n = 13 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    c1, c2 = (tm.init_cache(1, 96, torch.float32) for _ in range(2))
    exact, c1, _ = tm.apply(torch.from_numpy(tok), mode="prefill", cache=c1,
                            **tkw)
    pad, c2, _ = tm.apply(torch.from_numpy(padded), mode="prefill", cache=c2,
                          prompt_lengths=torch.tensor([n]), **tkw)
    np.testing.assert_allclose(exact.numpy(), pad.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(c2["pos"][0]) == n
    jc = jm.init_cache(1, 96, dtype=jnp.float32)
    jpad, jc, _ = jm.apply(params, jnp.asarray(padded), mode="prefill",
                           cache=jc, prompt_lengths=jnp.asarray([n]), **jkw)
    _close(pad, jpad)
    nxt = np.asarray([[5]], np.int32)
    d1, _, _ = tm.apply(torch.from_numpy(nxt), mode="decode", cache=c1)
    d2, _, _ = tm.apply(torch.from_numpy(nxt), mode="decode", cache=c2)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5, atol=1e-5)
    jd, _, _ = jm.apply(params, jnp.asarray(nxt), mode="decode", cache=jc)
    _close(d2, jd)


# ---------------------------------------------------------------------------
# (d) the engine against the reference's engine
# ---------------------------------------------------------------------------


def _spy_gaps(eng):
    """Record the top-1/top-2 logit gap of every active row the engine's
    model produces (prefill rows and the active slots of decode steps)."""
    gaps = []
    apply = eng.model.apply

    def spy(*args, **kw):
        active = [i for i, r in enumerate(eng._slot_req) if r is not None]
        out = apply(*args, **kw)
        rows = out[0][:, -1] if kw.get("mode") == "prefill" else \
            out[0][active, -1]
        top = torch.topk(rows.to(torch.float32), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return out
    eng.model.apply = spy
    return gaps, lambda: delattr(eng.model, "apply")


def test_engine_matches_reference_engine(twin):
    jm, params, tm = twin
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(5):
        toks = rng.integers(3, cfg.vocab_size, size=int(rng.integers(4, 30)))
        ve = None
        if cfg.family == "vlm":
            ve = (rng.standard_normal((cfg.vision_tokens, cfg.d_model))
                  * 0.02).astype(np.float32)
        reqs.append((i, toks, ve))
    jeng = JEngine(jm.cfg, params, batch_slots=2, max_len=128,
                   cache_dtype=jnp.float32)
    want = jeng.run([JRequest(rid=i, tokens=t, max_new_tokens=5,
                              vision_embeds=ve) for i, t, ve in reqs])
    teng = ServingEngine(tm, batch_slots=2, max_len=128,
                         cache_dtype=torch.float32)
    gaps, unspy = _spy_gaps(teng)
    got = teng.run([Request(rid=i, tokens=t, max_new_tokens=5,
                            vision_embeds=ve) for i, t, ve in reqs])
    unspy()
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(5))
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.rid
        assert a.finished_at >= a.first_token_at >= a.submitted_at
    assert len(teng.timings["prefill"]) == 5
    assert teng.timings["decode"] and min(teng.timings["decode"]) > 0


def test_gumbel_noise_follows_jax():
    """The sampling noise: ``jax.random.gumbel``'s bits exactly (the
    uniforms are equal), the logs within 2 ulps (numpy's vs XLA's)."""
    k = prng.key(123)
    want = np.asarray(jax.random.gumbel(jax.random.key(123), (3, 700)))
    got = prng.gumbel(k, 3 * 700).reshape(3, 700)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=3e-7)


def test_sampling_follows_the_reference_key_chain(twin):
    """temperature > 0: the engine splits its key every step as the
    reference does and draws by Gumbel-max with the reference's bits, so
    the sampled tokens are the reference engine's."""
    jm, params, tm = twin
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(3, tm.cfg.vocab_size, size=9)) for i in range(3)]
    want = JEngine(jm.cfg, params, batch_slots=2, max_len=64,
                   cache_dtype=jnp.float32, temperature=0.8, seed=4).run(
        [JRequest(rid=i, tokens=t, max_new_tokens=5) for i, t in reqs])
    got = ServingEngine(tm, batch_slots=2, max_len=64,
                        cache_dtype=torch.float32, temperature=0.8,
                        seed=4).run(
        [Request(rid=i, tokens=t, max_new_tokens=5) for i, t in reqs])
    assert [a.generated for a in got] == [b.generated for b in want]


def test_short_cache_takes_the_ring_tail_like_the_reference(qwen):
    """A cache shorter than vision tokens + prompt (max_len 24 < 16 + up
    to 30 tokens): prefill keeps the prompt's ring-consistent tail and
    decode continues as a 24-row sliding window, in both packages alike
    (the reference's behaviour, ROADMAP Queue 3)."""
    jcfg, params, tm = qwen
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(3, jcfg.vocab_size, size=int(rng.integers(
        12, 30))), (rng.standard_normal((16, jcfg.d_model)) * 0.02).astype(
            np.float32)) for i in range(3)]
    want = JEngine(jcfg, params, batch_slots=2, max_len=24,
                   cache_dtype=jnp.float32).run(
        [JRequest(rid=i, tokens=t, max_new_tokens=4, vision_embeds=ve)
         for i, t, ve in reqs])
    teng = ServingEngine(tm, batch_slots=2, max_len=24,
                         cache_dtype=torch.float32)
    assert teng.cache["dense"]["k"].shape[2] == 24
    gaps, unspy = _spy_gaps(teng)
    got = teng.run([Request(rid=i, tokens=t, max_new_tokens=4,
                            vision_embeds=ve) for i, t, ve in reqs])
    unspy()
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    assert [a.generated for a in got] == [b.generated for b in want]


def test_insert_slot_fills_one_batch_row(qwen):
    """``Transformer.insert_slot`` writes a batch-1 cache into one slot:
    axis 0 of ``pos`` and ``mrope_delta``, axis 1 of the stacked layers'
    leaves, and nothing else."""
    tm = qwen[2]
    cache = tm.init_cache(3, 16, torch.float32)
    one = tm.init_cache(1, 16, torch.float32)
    for t in [one["pos"], one["mrope_delta"], *one["dense"].values()]:
        t.fill_(5)
    tm.insert_slot(cache, one, 1)
    assert set(cache) == {"pos", "mrope_delta", "dense"}
    for k in ("pos", "mrope_delta"):
        assert cache[k].tolist() == [0, 5, 0]
    for v in cache["dense"].values():
        assert bool((v[:, 1] == 5).all())
        assert not bool(v[:, 0].any()) and not bool(v[:, 2].any())


def test_step_factories(twin):
    """make_prefill_step / make_serve_step: last-token logits, then one
    greedy token per slot against the cache, positions advancing."""
    _, _, tm = twin
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 9)))
    ve = None
    if cfg.family == "vlm":
        ve = torch.randn(2, cfg.vision_tokens, cfg.d_model) * 0.02
    logits, cache = make_prefill_step(tm, 64)(tok, ve)
    assert cache["dense"][next(iter(cache["dense"]))].dtype == torch.bfloat16
    assert logits.shape == (2, 1, cfg.vocab_size)
    nxt, cache = make_serve_step(tm)(torch.argmax(logits, -1), cache)
    assert nxt.shape == (2,) and nxt.dtype == torch.int32
    n = 9 + (cfg.vision_tokens if ve is not None else 0)
    assert cache["pos"].tolist() == [n + 1, n + 1]


# ---------------------------------------------------------------------------
# (e) VenusService: retrieval → vision embeddings → engine
# ---------------------------------------------------------------------------


class _Router:
    """One embedder per stream: frames go to their world's oracle (each
    tick holds one stream's chunk)."""

    def __init__(self, oracles):
        self.oracles, self.sid = oracles, 0

    def embed_frames(self, frames, aux_texts=None, frame_ids=None):
        return self.oracles[self.sid].embed_frames(
            frames, aux_texts, frame_ids=frame_ids)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jregistry.get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
    tcfg = tregistry.get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(3))
    tm = init_model(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params)))
    return jcfg, params, tm


def test_venus_service_matches_reference(qwen):
    jcfg, params, tm = qwen
    wcfgs = [dict(n_scenes=3, seed=31), dict(n_scenes=3, seed=32)]
    jworlds = [JWorld(JWorldConfig(**w)) for w in wcfgs]
    tworlds = [VideoWorld(WorldConfig(**w)) for w in wcfgs]
    joracles = [JOracle(w, dim=64) for w in jworlds]
    toracles = [OracleEmbedder(w, dim=64) for w in tworlds]

    jr, tr = _Router(joracles), _Router(toracles)
    jsvc = JService(JManager(JConfig(), jr, embed_dim=64),
                    JEngine(jcfg, params, batch_slots=2, max_len=128,
                            cache_dtype=jnp.float32), max_frames=2)
    tsvc = VenusService(SessionManager(VenusConfig(), tr, embed_dim=64,
                                       device="cpu"),
                        ServingEngine(tm, batch_slots=2, max_len=128,
                                      cache_dtype=torch.float32),
                        max_frames=2)
    for sid, (jw, tw) in enumerate(zip(jworlds, tworlds)):
        assert jsvc.create_stream() == tsvc.create_stream() == sid
        jr.sid = tr.sid = sid     # one tick, then the flush of its tail
        jsvc.ingest_tick({sid: jw.frames})
        tsvc.ingest_tick({sid: tw.frames})
        jsvc.flush()
        tsvc.flush()

    rng = np.random.default_rng(0)
    jq, tq = [], []
    for r in range(3):
        sid = r % 2
        wq = jworlds[sid].make_queries(3, seed=9)[r]
        emb = joracles[sid].embed_query(wq)
        prompt = rng.integers(3, jcfg.vocab_size, size=8)
        for out, cls in ((jq, JQuery), (tq, StreamQuery)):
            out.append(cls(rid=r, sid=sid, text=wq.text,
                           prompt_tokens=prompt, query_emb=emb,
                           max_new_tokens=3))
    want = jsvc.answer(jq)
    gaps, unspy = _spy_gaps(tsvc.engine)
    execute, began = tsvc.manager.execute, []

    def timed_execute(plan, **kw):
        began.append(time.perf_counter())
        return execute(plan, **kw)
    tsvc.manager.execute = timed_execute
    got = tsvc.answer(tq)
    del tsvc.manager.execute
    unspy()
    # TTFT counts from before retrieval
    assert len(began) == 1
    assert all(r.submitted_at <= began[0] < r.first_token_at for r in got)
    assert min(gaps) > GAP, f"near-tie: top-1/top-2 gap {min(gaps)}"
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        assert len(a.frame_ids) > 0
    assert [r.rid for r in got] == [0, 1, 2]
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.rid
        np.testing.assert_allclose(a.vision_embeds.numpy(), b.vision_embeds,
                                   rtol=1e-5, atol=1e-5)
    stats = tsvc.io_stats()
    assert stats["stack_rebuilds"] == 0
    assert stats["kops_fused_draw_launches"] == 1       # one plan, one group
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsvc.poll_alerts()


@pytest.mark.parametrize("use_arena", [True, False])
def test_io_stats_match_reference(use_arena):
    """Both services report the same io_stats keys at every point, and
    equal values on the ported paths after ingest, a query, more ingest
    and a stream close (arena slots, or detached memories that upload
    their buffers at the query and append in place after it)."""
    from repro.kernels import ops as jops
    wcfgs = [dict(n_scenes=3, seed=41), dict(n_scenes=3, seed=42)]
    jworlds = [JWorld(JWorldConfig(**w)) for w in wcfgs]
    tworlds = [VideoWorld(WorldConfig(**w)) for w in wcfgs]
    jr = _Router([JOracle(w, dim=64) for w in jworlds])
    tr = _Router([OracleEmbedder(w, dim=64) for w in tworlds])
    jsvc = JService(JManager(JConfig(), jr, embed_dim=64,
                             use_arena=use_arena), None)
    tsvc = VenusService(SessionManager(VenusConfig(), tr, embed_dim=64,
                                       use_arena=use_arena, device="cpu"),
                        None)
    jops.reset_scan_counts()

    def same(stage):
        js, ts = jsvc.io_stats(), tsvc.io_stats()
        assert sorted(ts) == sorted(js), (stage, set(ts) ^ set(js))
        diff = {k: (ts[k], js[k]) for k in js
                if ts[k] != js[k] and k not in IO_STATS_NOT_EQUAL[use_arena]}
        assert not diff, (stage, diff)

    half = [len(w.frames) // 2 for w in jworlds]
    for sid in range(2):
        assert jsvc.create_stream() == tsvc.create_stream() == sid
        jr.sid = tr.sid = sid
        jsvc.ingest_tick({sid: jworlds[sid].frames[:half[sid]]})
        tsvc.ingest_tick({sid: tworlds[sid].frames[:half[sid]]})
    same("ingest")
    emb = [jr.oracles[s].embed_query(jworlds[s].make_queries(1, seed=5)[0])
           for s in range(2)]
    for svc, cls in ((jsvc, JQuery), (tsvc, StreamQuery)):
        qs = [cls(rid=s, sid=s, text="", prompt_tokens=np.zeros(1, np.int32),
                  query_emb=emb[s]) for s in range(2)]
        svc.manager.execute(svc.plan(qs))
    same("query")
    rows = sum(tsvc.manager[s].memory.size for s in range(2))
    for sid in range(2):
        jr.sid = tr.sid = sid
        jsvc.ingest_tick({sid: jworlds[sid].frames[half[sid]:]})
        tsvc.ingest_tick({sid: tworlds[sid].frames[half[sid]:]})
    jsvc.flush()
    tsvc.flush()
    same("ingest after the query")
    added = sum(tsvc.manager[s].memory.size for s in range(2)) - rows
    ts = tsvc.io_stats()
    if not use_arena:       # the rows written, each once, into both copies
        assert ts["mem_appended_rows"] == ts["mem_appended_member_rows"] \
            == added > 0
    jsvc.close_stream(1)
    tsvc.close_stream(1)
    same("close")
    ts = tsvc.io_stats()
    assert ts["mem_scans"] == 0 and ts["kops_fused_draw_launches"] == 1
    assert ts["sessions_closed"] == 1 and ts["mem_appended_rows"] > 0
    if use_arena:
        assert ts["stack_rebuilds"] == 0 and ts["arena_shards"] == 1
    else:
        assert ts["mem_full_uploads"] == ts["mem_member_uploads"] == 2
