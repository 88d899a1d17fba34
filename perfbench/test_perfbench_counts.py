"""The benchmark's operation and byte counts against counts made by hand
at small shapes."""

import pytest

from perfbench import counts

TOWER = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
         "intermediate_size": 16}
MEM = {"vision_config": dict(TOWER, image_size=8, patch_size=4),
       "text_config": dict(TOWER, text_max_len=3), "projection_dim": 4}
DEC = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 6,
       "vocab_size": 10}


def test_causal_attention_counts_pairs():
    # 3 tokens: 6 (query, key) pairs, 2 heads of 4, q·k and p·v
    assert counts.causal_attention_flops(3, 2, 4) == 2 * 2 * 2 * 4 * 6


def test_mem_frame_flops_by_hand():
    n, d, ff = 4, 8, 16               # (8 / 4)² patches of a frame
    patch = 2 * n * 4 * 4 * 3 * d
    per_tok = 2 * (4 * d * d + 2 * d * ff)
    attn = 2 * 2 * 2 * 4 * (n * (n + 1) // 2)
    want = patch + 2 * (n * per_tok + attn) + 2 * d * 4
    assert counts.mem_frame_flops(MEM) == pytest.approx(want)


def test_mem_text_flops_by_hand():
    n, d, ff = 3, 8, 16
    per_tok = 2 * (4 * d * d + 2 * d * ff)
    attn = 2 * 2 * 2 * 4 * 6
    want = 5 * (2 * (n * per_tok + attn) + 2 * d * 4)
    assert counts.mem_text_flops(MEM, 5) == pytest.approx(want)


def test_decoder_flops_by_hand():
    d, hd, h, hkv, ff, v, L = 8, 2, 4, 2, 6, 10, 2
    per_tok = 2 * (d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * ff)
    n = 5
    prefill = L * (n * per_tok + 2 * 2 * h * hd * n * (n + 1) / 2) + 2 * d * v
    assert counts.prefill_flops(DEC, n) == pytest.approx(prefill)
    step = sum(L * (per_tok + 2 * 2 * h * hd * c) + 2 * d * v for c in (3, 7))
    assert counts.decode_flops(DEC, [3, 7]) == pytest.approx(step)


def test_kernel_bytes_by_hand():
    # #2: 4 frames of 2x3 and the one before, f32, φ written
    assert counts.scene_score_bytes(4, 2, 3) == 5 * 2 * 3 * 3 * 4 + 4 * 4
    # #5: 2 sequences of 3 and 7 rows, bf16: q and out, k and v rows
    assert counts.gqa_decode_bytes(DEC, [3, 7]) == (
        2 * 2 * 4 * 2 * 2 + 10 * 2 * 2 * 2 * 2)
    assert counts.gqa_decode_flops(DEC, [3, 7]) == 2 * 2 * 4 * 2 * 10


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_s(3.35e12) == pytest.approx(1.0)
    assert counts.roofline_s(0.0, 989e12) == pytest.approx(1.0)
    assert counts.roofline_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
