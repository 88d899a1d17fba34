"""Serving on the model axis on the CPU: four gloo processes under one
``torchrun --standalone`` place the smoke GQA decoders (qwen2-vl-7b with
M-RoPE and vision tokens, glm4-9b with partial RoPE) on ``("data",
"model")`` meshes of (2, 2) and (1, 4) and serve them, in float32
activations and caches; this process holds what they wrote against the
reference's tables, against the port in one process and against the
reference's own serve step.

At (2, 2) the two KV heads divide the model axis: each rank keeps its
heads and its heads' cache, the batch splits over ``data``. At (1, 4)
they do not: ``wk`` and ``wv`` (64 columns) split through a 32-wide head
(16 columns a rank), the cache splits by its sequence, prefill runs
sequence-parallel through the hook, and decode merges every rank's #5
partials (their plain versions here). Logits within rtol 1e-5 / atol
1e-5 of one process, greedy tokens equal; the reference's weights
carried over by ``core.convert`` give the reference's logits within its
cross-framework bound (1e-4, ``tests/test_torch_serving.py``) and its
``make_serve_step``'s tokens.

Also here, in this process: the plain versions of ``gqa_decode(...,
partials=True)`` and ``merge_partials`` against ``gqa_decode`` (shards
with no valid row included), the sequence-parallel core's rows against
the whole attention's, and the cache writes of a sequence shard against
the whole cache's rows."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import attention as A
from repro_torch.models.params import meta_model
from repro_torch.models.transformer import init_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-vl-7b", "glm4-9b")
MESHES = ((2, 2), (1, 4))
CASES = [(m, a) for m in MESHES for a in ARCHS]
SLOTS, MAX_LEN, STEPS = 2, 64, 4
CLOSE = dict(rtol=1e-5, atol=1e-5)
REF_CLOSE = dict(rtol=1e-4, atol=1e-4)
N_REQ, MAX_NEW = 3, 4

# Each rank: every mesh × arch from seed 0 (``init_model(mesh=)``), its
# placements, teacher-forced logits, the engine's greedy tokens, and the
# calls into the sequence-parallel hook and #5's partials; then the
# reference's weights (``ref.pt``) on (1, 4) through ``make_serve_step``.
# Rank 0 writes one npz.
SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_ranks, make_abstract_mesh, \
    to_device_mesh
from repro_torch.launch import serve
from repro_torch.launch.sharding import is_placed
from repro_torch.models import attention as A
from repro_torch.models.transformer import Transformer, init_model
from repro_torch.serving.engine import (Request, ServingEngine,
                                        make_serve_step)

out, ref_state = sys.argv[1], sys.argv[2]
SLOTS, MAX_LEN, STEPS, N_REQ, MAX_NEW = (int(a) for a in sys.argv[3:8])
torch.set_num_threads(1)
init_ranks("cpu")
rank = dist.get_rank()
calls = {"seq_shard": 0, "partials": 0}
hook, decode = A._seq_shard, ops.decode_attention


def seq_shard(q, k, v, tp):
    calls["seq_shard"] += 1
    return hook(q, k, v, tp)


def decode_attention(*a, partials=False, **kw):
    calls["partials"] += partials
    return decode(*a, partials=partials, **kw)


A._seq_shard, A.kops.decode_attention = seq_shard, decode_attention


def requests(cfg):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQ):
        r = Request(rid=i, tokens=rng.integers(3, cfg.vocab_size, size=int(
            rng.integers(8, 40))), max_new_tokens=MAX_NEW)
        if cfg.family == "vlm":
            r.vision_embeds = rng.normal(0, 0.02, (cfg.vision_tokens,
                                                   cfg.d_model)).astype(
                                                       np.float32)
        reqs.append(r)
    return reqs


def placements(tree, prefix=""):
    got = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            got.update(placements(v, name + "/"))
        else:
            assert is_placed(v), name
            got[name] = str(tuple(v.placements))
    return got


res = {}
for mesh in ((2, 2), (1, 4)):
    dm = to_device_mesh(make_abstract_mesh(mesh, ("data", "model")), "cpu")
    for arch in ("qwen2-vl-7b", "glm4-9b"):
        tag = f"{mesh[0]}x{mesh[1]}_{arch}"
        cfg = get_smoke_config(arch).replace(dtype="float32")
        model = init_model(cfg, seed=0, device="cpu", mesh=dm)
        for name, p in model.named_parameters():
            assert is_placed(p), name
            res[f"{tag}/param/{name}"] = str(tuple(p.placements))
        for name, pl in placements(model.init_cache(SLOTS, MAX_LEN)).items():
            res[f"{tag}/cache/{name}"] = pl
        calls.update(seq_shard=0, partials=0)
        _, _, logits = serve.teacher_forced(model, cfg, batch=SLOTS,
                                            max_len=MAX_LEN, steps=STEPS)
        res[f"{tag}/logits"] = logits
        res[f"{tag}/calls"] = np.array([calls["seq_shard"],
                                        calls["partials"]])
        done = ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                             cache_dtype=torch.float32).run(requests(cfg))
        res[f"{tag}/tokens"] = np.array([r.generated for r in done])

# the reference's weights on (1, 4): teacher-forced logits and two
# steps of make_serve_step after a bf16-cache prefill
cfg = get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
g = torch.Generator().manual_seed(0)
model = Transformer(cfg, g)
model.load_state_dict(torch.load(ref_state))
dm = to_device_mesh(make_abstract_mesh((1, 4), ("data", "model")), "cpu")
step = make_serve_step(model, mesh=dm)
_, _, logits = serve.teacher_forced(model, cfg, batch=SLOTS, max_len=MAX_LEN,
                                    steps=STEPS)
res["ref/logits"] = logits
tok, lens, fed, vision = serve.teacher_inputs(cfg, batch=SLOTS, steps=STEPS)
full = tok[:, :8]
cache = model.init_cache(SLOTS, MAX_LEN, torch.bfloat16)
_, cache, _ = model.apply(torch.from_numpy(full), mode="prefill",
                          cache=cache,
                          vision_embeds=torch.from_numpy(vision))
nxt, steps = torch.from_numpy(fed[0]), []
for _ in range(2):
    nxt, cache = step(nxt, cache)
    steps.append(nxt.numpy())
    nxt = nxt[:, None]
res["ref/serve_tokens"] = np.stack(steps)
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(arch):
    return get_smoke_config(arch).replace(dtype="float32")


@pytest.fixture(scope="module")
def twin():
    """The reference's smoke qwen2-vl-7b weights (``Transformer.init``,
    key 0), its jitted ``apply`` and ``make_serve_step``, and the same
    weights as the port's state dict."""
    import jax
    from repro.configs import registry as jregistry
    from repro.models.transformer import Transformer as JTransformer
    from repro.serving.engine import make_serve_step as jmake_serve_step
    from repro_torch.core.convert import model_params_from_numpy
    jcfg = jregistry.get_smoke_config("qwen2-vl-7b").replace(dtype="float32")
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.key(0))
    state = model_params_from_numpy(_f32("qwen2-vl-7b"),
                                    jax.tree.map(np.asarray, params))
    return (jax.jit(jm.apply, static_argnames=("mode",)), jm, params,
            jax.jit(jmake_serve_step(jcfg)), state)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, twin):
    """One ``torchrun --standalone`` of 4 gloo processes → its npz."""
    tmp = tmp_path_factory.mktemp("tp")
    script, out, state = (str(tmp / n) for n in ("tp.py", "tp.npz",
                                                  "ref.pt"))
    with open(script, "w") as f:
        f.write(SCRIPT)
    torch.save(twin[-1], state)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", script, out, state,
         *map(str, (SLOTS, MAX_LEN, STEPS, N_REQ, MAX_NEW))],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "[ranks] world 4, backend gloo" in run.stdout
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_process():
    """The port in one process: per arch, teacher-forced logits and the
    engine's greedy tokens (the same seeds and requests as the ranks)."""
    from repro_torch.serving.engine import Request, ServingEngine
    out = {}
    for arch in ARCHS:
        cfg = _f32(arch)
        model = init_model(cfg, seed=0, device="cpu")
        _, _, logits = tserve.teacher_forced(model, cfg, batch=SLOTS,
                                             max_len=MAX_LEN, steps=STEPS)
        rng = np.random.default_rng(0)
        reqs = []
        for i in range(N_REQ):
            r = Request(rid=i, tokens=rng.integers(
                3, cfg.vocab_size, size=int(rng.integers(8, 40))),
                max_new_tokens=MAX_NEW)
            if cfg.family == "vlm":
                r.vision_embeds = rng.normal(
                    0, 0.02, (cfg.vision_tokens, cfg.d_model)).astype(
                        np.float32)
            reqs.append(r)
        done = ServingEngine(model, batch_slots=SLOTS, max_len=MAX_LEN,
                             cache_dtype=torch.float32).run(reqs)
        out[arch] = (logits, np.array([r.generated for r in done]))
    return out


def _tag(mesh, arch):
    return f"{mesh[0]}x{mesh[1]}_{arch}"


class _Names:                 # to_placements reads only the dim names
    mesh_dim_names = ("data", "model")


@pytest.mark.parametrize("mesh,arch", CASES)
def test_params_placed_by_the_tables(ranks, mesh, arch):
    """Every parameter's placements are ``to_placements(param_spec(...,
    mode="serve"))`` of the reference's tables, leaf for leaf — at (1, 4)
    ``wk``/``wv`` split through a head."""
    model = meta_model(_f32(arch))
    specs = shd.param_specs(model, make_abstract_mesh(mesh, ("data",
                                                             "model")),
                            mode="serve")
    tag = _tag(mesh, arch)
    got = {k.split("/param/")[1]: str(v) for k, v in ranks.items()
           if k.startswith(f"{tag}/param/")}
    assert set(got) == set(specs)
    for name, spec in specs.items():
        assert got[name] == str(tuple(shd.to_placements(spec, _Names()))), \
            name
    if mesh == (1, 4):
        assert specs["blocks.0.attn.wk"] == shd.P(None, "model")
        assert model.blocks[0].attn["wk"].shape[1] // 4 < _f32(arch).head_dim


@pytest.mark.parametrize("mesh,arch", CASES)
def test_cache_placed_by_the_tables(ranks, mesh, arch):
    """Every cache leaf's placements are ``cache_specs``': the KV heads
    over ``model`` at (2, 2), the sequence at (1, 4); the batch over
    ``data``."""
    model = meta_model(_f32(arch))
    cache = model._cache_tree(SLOTS, MAX_LEN, torch.float32, "meta")
    specs = shd.cache_specs(cache, make_abstract_mesh(mesh, ("data",
                                                             "model")))
    tag = _tag(mesh, arch)
    want = {}

    def walk(tree, spec, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, spec[k], f"{prefix}{k}/")
            else:
                want[f"{prefix}{k}"] = str(tuple(shd.to_placements(
                    spec[k], _Names())))
    walk(cache, specs)
    got = {k.split("/cache/")[1]: str(v) for k, v in ranks.items()
           if k.startswith(f"{tag}/cache/")}
    assert got == want
    seq = "(Shard(dim=1), Shard(dim=2))"
    heads = "(Shard(dim=1), Shard(dim=3))"
    assert got["dense/k"] == (seq if mesh == (1, 4) else heads)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_logits_match_one_process(ranks, one_process, mesh, arch):
    """Prefill and 4 teacher-forced decode steps: the mesh's logits
    within rtol/atol 1e-5 of one process's."""
    got = ranks[f"{_tag(mesh, arch)}/logits"]
    want = one_process[arch][0]
    assert got.shape == want.shape == (1 + STEPS, SLOTS,
                                       _f32(arch).vocab_size)
    np.testing.assert_allclose(got, want, **CLOSE)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_greedy_tokens_match_one_process(ranks, one_process, mesh, arch):
    """The engine's greedy tokens (3 requests over 2 slots) equal one
    process's."""
    got = ranks[f"{_tag(mesh, arch)}/tokens"]
    np.testing.assert_array_equal(got, one_process[arch][1])
    assert got.shape == (N_REQ, MAX_NEW)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_sequence_parallel_paths_run_where_heads_do_not_divide(ranks, mesh,
                                                               arch):
    """At (1, 4) the teacher-forced run went through the hook (one call a
    layer at prefill) and #5's partials (one a layer a decode step);
    at (2, 2) through neither."""
    seq, partials = ranks[f"{_tag(mesh, arch)}/calls"]
    layers = _f32(arch).num_layers
    if mesh == (1, 4):
        assert (seq, partials) == (layers, layers * STEPS)
    else:
        assert (seq, partials) == (0, 0)


def test_reference_serve_step_on_the_mesh(ranks, twin):
    """The reference's weights on (1, 4): teacher-forced logits within
    the reference's bound of its own ``apply``, and two greedy steps of
    the port's ``make_serve_step(mesh=)`` the tokens of the reference's
    ``make_serve_step`` after the same bf16-cache prefill."""
    import jax.numpy as jnp
    japply, jm, params, jstep, _ = twin
    cfg = _f32("qwen2-vl-7b")
    tok, lens, fed, vision = tserve.teacher_inputs(cfg, batch=SLOTS,
                                                   steps=STEPS)
    nv = vision.shape[1]
    cache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
    logits, cache, _ = japply(params, jnp.asarray(tok), mode="prefill",
                              cache=cache, vision_embeds=jnp.asarray(vision),
                              prompt_lengths=jnp.asarray(lens + nv))
    want = [np.asarray(logits[:, -1])]
    for t in range(STEPS):
        logits, cache, _ = japply(params, jnp.asarray(fed[t]), mode="decode",
                                  cache=cache)
        want.append(np.asarray(logits[:, -1]))
    np.testing.assert_allclose(ranks["ref/logits"], np.stack(want),
                               **REF_CLOSE)
    cache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.bfloat16)
    _, cache, _ = japply(params, jnp.asarray(tok[:, :8]), mode="prefill",
                         cache=cache, vision_embeds=jnp.asarray(vision))
    nxt, steps = jnp.asarray(fed[0]), []
    for _ in range(2):
        nxt, cache = jstep(params, nxt, cache)
        steps.append(np.asarray(nxt))
        nxt = nxt[:, None]
    np.testing.assert_array_equal(ranks["ref/serve_tokens"], np.stack(steps))


# ------------------------------------------------ plain partials and merge


def _decode_case(seed, b=3, c=96, h=8, hkv=2, d=32):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((b, 1, h, d), (b, c, hkv, d), (b, c, hkv, d)))
    return q, k, v


@pytest.mark.parametrize("shards,softcap", [(1, 0.0), (4, 0.0), (3, 30.0)])
def test_partials_of_shards_merge_to_decode_attention(shards, softcap):
    """The plain partials of each sequence shard, merged in rank order,
    give ``gqa_decode`` over the whole cache (rtol 1e-5 / atol 1e-6) —
    with a sequence whose valid rows all lie in the first shard, so the
    later shards have none, and one with every row valid."""
    q, k, v = _decode_case(shards)
    b, c = k.shape[:2]
    valid = torch.arange(c)[None] < torch.tensor([1, 20, c])[:, None]
    kw = dict(scale=0.17, softcap=softcap, q_per_kv=4)
    want = tdecode.gqa_decode(q, k, v, valid, **kw)
    n = -(-c // shards)
    parts = [tdecode.gqa_decode(q, k[:, i:i + n], v[:, i:i + n],
                                valid[:, i:i + n], partials=True, **kw)
             for i in range(0, c, n)]
    for m, l, acc in parts:
        assert m.shape == l.shape == (b, 8, 1) and acc.shape == (b, 8, 1, 32)
    m, l, acc = (torch.cat([p[i] for p in parts], dim=2) for i in range(3))
    got = tdecode.merge_partials(m, l, acc, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert tdecode.gqa_decode.launches == tdecode.merge_partials.launches == 0


def test_all_invalid_shard_weighs_nothing_and_all_invalid_gives_mean():
    """A shard with no valid row of a sequence is the empty part (m =
    -1e30, l = 0, acc = 0): beside a valid part it weighs exactly
    nothing. A sequence with no valid row anywhere still gives the mean
    of v through ``gqa_decode`` over its whole cache; its shards' empty
    parts merge to 0 (decode never has such a sequence)."""
    q, k, v = _decode_case(7, b=2, c=64)
    none = torch.zeros((2, 32), dtype=torch.bool)
    m, l, acc = ref.decode_partials_ref(q, k[:, 32:], v[:, 32:], none,
                                        scale=0.2, q_per_kv=4)
    assert torch.all(m == -1e30) and torch.all(l == 0)
    assert torch.all(acc == 0)
    ok = torch.ones((2, 32), dtype=torch.bool)
    p0 = ref.decode_partials_ref(q, k[:, :32], v[:, :32], ok, scale=0.2,
                                 q_per_kv=4)
    merged = ref.merge_partials_ref(
        *(torch.cat([a, b_], dim=2) for a, b_ in zip(p0, (m, l, acc))),
        torch.float32)
    alone = ref.merge_partials_ref(*p0, torch.float32)
    assert torch.equal(merged, alone)
    valid = torch.zeros((2, 64), dtype=torch.bool)
    p1 = ref.decode_partials_ref(q, k[:, :32], v[:, :32], valid[:, :32],
                                 scale=0.2, q_per_kv=4)
    both = ref.merge_partials_ref(
        *(torch.cat([a, b_], dim=2) for a, b_ in zip(p1, (m, l, acc))),
        torch.float32)
    assert torch.all(both == 0)
    mean = v.mean(1).repeat_interleave(4, dim=1)[:, None]
    torch.testing.assert_close(tdecode.gqa_decode(
        q, k, v, valid, scale=0.2, q_per_kv=4), mean, rtol=1e-5, atol=1e-6)


class _Ranks:
    """A stand-in ``TensorParallel`` for rank ``rank`` of ``size`` (the
    hook and the cache helpers read only these)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    seq_bounds = shd.TensorParallel.seq_bounds


@pytest.mark.parametrize("window", [0, 5])
def test_sequence_parallel_rows_equal_the_whole_attention(window):
    """Each rank's rows from the hook (``_seq_shard`` with a model's
    ``TensorParallel``), attended with their offset into the causal (and
    sliding) mask, are the whole attention's rows; k and v pass whole."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 14, hh, 8, generator=g) for hh in (4, 2, 2))
    lengths = torch.tensor([14, 9])
    want = A._sdpa_causal_chunked(q, k, v, 0.3, 0.0, 2, window, lengths)
    rows = []
    for r in range(4):
        tp = _Ranks(r, 4)
        qr, kr, vr = A._seq_shard(q, k, v, tp)
        assert kr is k and vr is v
        lo, hi = tp.seq_bounds(14)
        assert qr.shape[1] == hi - lo
        rows.append(A._sdpa_causal_chunked(qr, k, v, 0.3, 0.0, 2, window,
                                           lengths, q_offset=lo))
    torch.testing.assert_close(torch.cat(rows, 1), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("c", [16, 6])
def test_cache_writes_of_a_sequence_shard(c):
    """Prefill and decode writes into rows [lo, lo + C/R) of a C-row ring
    (a rank's shard) equal the whole cache's rows there — a prompt longer
    than the ring (C = 6) included — and decode writes only the sequences
    whose slot the shard holds."""
    g = torch.Generator().manual_seed(5)
    new = torch.randn(3, 10, 2, 4, generator=g)
    tok = torch.randn(3, 1, 2, 4, generator=g)
    pos = torch.tensor([10, 13, 3])
    whole = torch.zeros(3, c, 2, 4)
    A._fill_cache(whole, new)
    A._decode_slots(whole, tok, pos)
    n = c // 2
    for lo in (0, n):
        part = torch.zeros(3, n, 2, 4)
        A._fill_cache(part, new, lo, c)
        A._decode_slots(part, tok, pos, lo, c)
        assert torch.equal(part, whole[:, lo:lo + n])
