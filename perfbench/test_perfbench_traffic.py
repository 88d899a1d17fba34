"""The traffic generator: deterministic for a seed, lengths in their
ranges, the same work for every seed; the camera world made again chunk
by chunk."""

import numpy as np
import pytest
import torch

from perfbench import harness, mix
from perfbench.world import CameraWorld

DESCRIBE = harness.load_json("traffic", "describe-closed.json")


def world(seed, streams=4, r=16):
    return CameraWorld(seed=seed, mix_seed=5, streams=streams, resolution=r,
                       chunk=8, scene_len=(6, 12), device="cpu")


def closed_loop(seed, n=64, traffic=DESCRIBE):
    loop = mix.ClosedLoop(traffic, seed, world(seed, 16), 1000, 64)
    return [loop.next(c % 16) for c in range(n)]


def test_closed_loop_is_deterministic_per_seed():
    a, b = closed_loop(2**31 + 5), closed_loop(2**31 + 5)
    assert [(q.sid, q.text, q.prompt.tolist(), q.max_new_tokens)
            for q in a] == [(q.sid, q.text, q.prompt.tolist(),
                             q.max_new_tokens) for q in b]
    c = closed_loop(7)
    assert [q.text for q in a] != [q.text for q in c]


def test_every_seed_offers_the_same_work():
    # a whole pool: every client's sequence of lengths, dealt by the seed
    n = DESCRIBE["pool"]
    a, b = closed_loop(1, n), closed_loop(3**20, n)
    for key in (lambda q: len(q.prompt), lambda q: q.max_new_tokens):
        assert sorted(map(key, a)) == sorted(map(key, b))
    assert [q.max_new_tokens for q in a] != [q.max_new_tokens for q in b]


@pytest.mark.parametrize("key", ["prompt_tokens", "answer_tokens"])
def test_lengths_in_their_ranges_and_long_tailed(key):
    spec = DESCRIBE[key]
    x = mix.lengths(spec, 4000, np.random.default_rng(0))
    assert x.min() >= spec["min"] and x.max() <= spec["max"]
    assert np.mean(x) > np.median(x)          # the tail is long


def test_closed_loop_questions_cycle_the_pool():
    loop = mix.ClosedLoop(DESCRIBE, 9, world(9, 16), 1000, 64)
    qs = [loop.next(c % 16) for c in range(40)]
    lo, hi = DESCRIBE["answer_tokens"]["min"], DESCRIBE["answer_tokens"]["max"]
    assert all(lo <= q.max_new_tokens <= hi for q in qs)
    assert all(32 <= len(q.prompt) <= 128 for q in qs)
    assert [q.sid for q in qs] == [c % 16 for c in range(40)]


def test_world_chunks_are_made_again_alike():
    w1, w2 = world(21), world(21)
    a = w1.tick(3)
    for s in range(4):
        assert torch.equal(w2.render(s, 3), torch.from_numpy(a[s]))
    f = w2.frames(1, [25, 2, 30])
    assert torch.equal(f[0], w1.render(1, 3)[1])
    assert torch.equal(f[1], w1.render(1, 0)[2])


def test_world_scene_shapes_are_the_mix_dealt_by_the_seed():
    a, b = world(1), world(2)
    la = sorted(tuple(a._timeline(s, 200).lengths[:5]) for s in range(4))
    lb = sorted(tuple(b._timeline(s, 200).lengths[:5]) for s in range(4))
    assert la == lb
    assert not torch.equal(a.render(0, 0), b.render(0, 0))
