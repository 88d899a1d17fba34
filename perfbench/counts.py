"""The benchmark's own count of the work a cell does, from the
configuration's shapes and the traffic's real sizes only: floating-point
operations (2 a multiply-add; causal attention counts the keys each
query reads) and the least bytes a kernel must move (each input byte
read once, each output byte written once). The same whatever kernel
does the work, so a later change moves the time and not the count.

Peaks are one NVIDIA H100 SXM's published dense rates at 700 W."""

from __future__ import annotations

from typing import Iterable

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _tower_token_flops(d: int, heads: int, kv_heads: int, head_dim: int,
                       d_ff: int, gated: bool) -> float:
    """One token through one block's products, attention's excluded."""
    qkvo = d * (heads + 2 * kv_heads) * head_dim + heads * head_dim * d
    mlp = (3 if gated else 2) * d * d_ff
    return 2.0 * (qkvo + mlp)


def causal_attention_flops(n: int, heads: int, head_dim: int) -> float:
    """q·k and p·v over a causal n-token sequence: n(n+1)/2 pairs."""
    return 2.0 * 2.0 * heads * head_dim * n * (n + 1) / 2


def mem_frame_flops(cfg: dict) -> float:
    """One frame through MEM's vision side: the patch projection, the
    tower over its patches, the projection into the shared space."""
    v = cfg["vision_config"]
    d, h, p = v["hidden_size"], v["num_attention_heads"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    per_layer = (n * _tower_token_flops(d, h, h, d // h,
                                        v["intermediate_size"], False)
                 + causal_attention_flops(n, h, d // h))
    return (2.0 * n * p * p * 3 * d + v["num_hidden_layers"] * per_layer
            + 2.0 * d * cfg["projection_dim"])


def mem_text_flops(cfg: dict, n_texts: int) -> float:
    """``n_texts`` texts through MEM's text tower at its fixed length."""
    t = cfg["text_config"]
    d, h, n = t["hidden_size"], t["num_attention_heads"], t["text_max_len"]
    per_layer = (n * _tower_token_flops(d, h, h, d // h,
                                        t["intermediate_size"], False)
                 + causal_attention_flops(n, h, d // h))
    return n_texts * (t["num_hidden_layers"] * per_layer
                      + 2.0 * d * cfg["projection_dim"])


def _decoder_token_flops(m: dict) -> float:
    return m["num_hidden_layers"] * _tower_token_flops(
        m["hidden_size"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"], m["intermediate_size"], True)


def prefill_flops(m: dict, n: int) -> float:
    """A prefill of ``n`` tokens (vision tokens included) and the head
    over its last position."""
    return (n * _decoder_token_flops(m)
            + m["num_hidden_layers"] * causal_attention_flops(
                n, m["num_attention_heads"], m["head_dim"])
            + 2.0 * m["hidden_size"] * m["vocab_size"])


def decode_flops(m: dict, contexts: Iterable[int]) -> float:
    """One decode step of the sequences whose new token reads
    ``contexts`` keys each (itself included)."""
    per = _decoder_token_flops(m) + 2.0 * m["hidden_size"] * m["vocab_size"]
    att = 2.0 * 2.0 * m["num_attention_heads"] * m["head_dim"]
    return sum(per + m["num_hidden_layers"] * att * c for c in contexts)


def scene_score_bytes(frames: int, height: int, width: int) -> float:
    """One #2 launch over a chunk of ``frames`` f32 RGB frames scored
    against the frame before it: the frames and that one read, φ
    written."""
    return (frames + 1) * height * width * 3 * 4.0 + frames * 4.0


def gqa_decode_bytes(m: dict, contexts: Iterable[int], elt: int = 2
                     ) -> float:
    """One #5 launch (one layer of one decode step): each sequence's q,
    its valid key and value rows, its context written."""
    h, hkv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                  m["head_dim"])
    contexts = list(contexts)
    return (2.0 * len(contexts) * h * hd * elt
            + sum(contexts) * 2.0 * hkv * hd * elt)


def gqa_decode_flops(m: dict, contexts: Iterable[int]) -> float:
    return 2.0 * 2.0 * m["num_attention_heads"] * m["head_dim"] * sum(contexts)


def roofline_s(bytes_moved: float, flops: float = 0.0) -> float:
    """The least time the chip could take: the larger of the two
    bounds."""
    return max(bytes_moved / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
