"""The port's ``DistributedVenusMemory`` held to the dense path of the JAX
reference (``repro.kernels.ref.similarity_ref``) on the CPU: the
reference's four cases, at K = 1 and at K = 4 shards (a mesh naming the
CPU four times)."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.core.distributed_memory import DistributedVenusMemory
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import make_memory_mesh

SHARDS = [1, 4]


def _mesh(k):
    return make_memory_mesh(k, devices=["cpu"] * k)


@pytest.mark.parametrize("k", SHARDS)
def test_distributed_search_matches_dense(k):
    dim, n = 16, 48
    rng = np.random.default_rng(0)
    embs = rng.normal(0, 1, (n, dim)).astype(np.float32)
    mem = DistributedVenusMemory(64, dim, _mesh(k), top_m=64)
    mem.insert(embs)
    q = rng.normal(0, 1, (dim,)).astype(np.float32)
    tops.reset_scan_counts()
    ids, probs = mem.search(q, tau=0.1)
    ids, probs = ids.numpy(), probs.numpy()
    assert tops.scan_counts()["similarity"] == k     # one #4 a shard
    assert ids.shape == probs.shape == (k * min(64, 64 // k),)
    _, dense = jref.similarity_ref(jnp.asarray(q)[None], jnp.asarray(embs),
                                   tau=0.1, valid=jnp.ones((n,), bool))
    dense = np.asarray(dense[0])
    got = {int(i): float(p) for i, p in zip(ids, probs)
           if np.isfinite(p) and int(i) < n and p > 0}
    assert len(got) == n                  # top_m covers every valid row
    for i, p in got.items():
        np.testing.assert_allclose(p, dense[i], rtol=1e-4, atol=1e-5,
                                   err_msg=str(i))
    assert int(np.argmax(dense)) in got


@pytest.mark.parametrize("k", SHARDS)
def test_distributed_insert_capacity_and_ids(k):
    mem = DistributedVenusMemory(8, 4, _mesh(k), top_m=8)
    mem.insert(np.eye(4, dtype=np.float32))
    assert mem.size == 4
    orders = sorted(mem.global_id_to_insert_order(g) for g in range(8))
    assert orders == list(range(8))       # a bijection on [0, 8)
    with pytest.raises(RuntimeError):
        mem.insert(np.zeros((5, 4), np.float32))
    # round-robin: insert order s sits in shard s % K
    ids, probs = mem.search(np.eye(4, dtype=np.float32)[2], tau=0.1)
    assert int(ids[int(probs.argmax())]) == 2


@pytest.mark.parametrize("k", SHARDS)
def test_empty_index_returns_zero_mass(k):
    """An empty (or all-invalid) index returns all-zero probabilities —
    never a uniform distribution over garbage ids — and the non-empty
    case still sums to one."""
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (16,)).astype(np.float32)
    mem = DistributedVenusMemory(64, 16, _mesh(k), top_m=8)
    ids, probs = mem.search(q, tau=0.1)
    assert probs.shape == ids.shape
    np.testing.assert_array_equal(probs.numpy(), 0.0)
    mem.insert(rng.normal(0, 1, (5, 16)).astype(np.float32))
    _, probs = mem.search(q, tau=0.1)
    np.testing.assert_allclose(float(probs.sum()), 1.0, rtol=1e-5)


@pytest.mark.parametrize("k", SHARDS)
def test_insert_scatter_is_capacity_independent(k):
    """An insert writes its rows in place, one write a shard: identical
    inserts into a 16× larger memory count identical bytes, and the
    buffers are the same tensors after it."""
    rng = np.random.default_rng(2)
    dim, n = 16, 8
    rows = rng.normal(0, 1, (n, dim)).astype(np.float32)
    small = DistributedVenusMemory(64, dim, _mesh(k), top_m=8)
    large = DistributedVenusMemory(1024, dim, _mesh(k), top_m=8)
    small.insert(rows)
    before = [x.data_ptr() for x in large._emb]
    large.insert(rows)
    expect = n * (dim * 4 + 1 + 4)     # rows f32 + valid bool + pos i32
    assert small.io_stats["scatter_bytes"] == expect
    assert large.io_stats["scatter_bytes"] == expect
    assert small.io_stats["scatter_rows"] == n
    assert large.io_stats["inserts"] == 1
    assert [x.data_ptr() for x in large._emb] == before


@pytest.mark.parametrize("k", SHARDS)
def test_search_lanes_follow_lax_top_k(k):
    """The candidates come in ``lax.top_k``'s order — descending, ties to
    the lowest lane, the invalid (-inf) padding lanes included — shard by
    shard: five rows equal e0 and one at cos 0.894 to it, queried with
    e0. The reference's class raises on this JAX, so the lanes are held
    to ``jax.lax.top_k`` over the shard's own scores."""
    import jax
    import torch
    dim, cap, m = 8, 128, 8
    e0 = np.eye(dim, dtype=np.float32)[0]
    near = e0 + 0.5 * np.eye(dim, dtype=np.float32)[1]     # cos 0.894
    rows = np.stack([e0, e0, e0, near, e0, e0])
    mem = DistributedVenusMemory(cap, dim, _mesh(k), top_m=m)
    mem.insert(rows)
    ids, _ = mem.search(e0, tau=0.1)
    per = cap // k
    want = []
    for j in range(k):
        sims, _ = tops.similarity(torch.from_numpy(e0)[None], mem._emb[j],
                                  tau=1.0, valid=mem._valid[j])
        s = torch.where(mem._valid[j], sims[0], -torch.inf).numpy()
        _, lanes = jax.lax.top_k(jnp.asarray(s), min(m, per))
        want.append(np.asarray(lanes) + j * per)
    gids = torch.from_numpy(np.concatenate(want).astype(np.int64))
    np.testing.assert_array_equal(ids.numpy(),
                                  mem.insert_orders(gids).numpy())
    if k == 1:
        np.testing.assert_array_equal(ids.numpy()[:8],
                                      [0, 1, 2, 4, 5, 3, 6, 7])
