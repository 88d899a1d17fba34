"""GQA attention, train/prefill form (no cache), as the reference computes
it: logits in f32 from operands in the model dtype, masked with -1e30,
softmax in f32, probabilities cast to the model dtype for the value
product, the context cast back. Written as explicit products and a
softmax — ``F.scaled_dot_product_attention`` rounds differently and is a
library kernel. The decode form (a hand-written kernel) and the caches
come with the serving slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30
# query-chunked causal attention: chunks of SDPA_Q_CHUNK queries see only
# their causal key range (read at call time, as in the reference)
SDPA_Q_CHUNK = 512


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def causal_window_mask(s_q: int, s_k: int, window: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """(s_q, s_k) bool mask; query i attends key j iff
    j <= i+offset and (window == 0 or i+offset - j < window)."""
    qi = torch.arange(s_q, device=device)[:, None] + offset
    kj = torch.arange(s_k, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= (qi - kj) < window
    return m


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
             ) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, h * hd, dtype=dtype),
         "wk": dense_init(gen, d, hkv * hd, dtype=dtype),
         "wv": dense_init(gen, d, hkv * hd, dtype=dtype),
         "wo": dense_init(gen, h * hd, d, dtype=dtype)}
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_scale"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _position_embed(cfg: ModelConfig, q, k, positions):
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
    elif cfg.pos_type == "mrope":
        raise NotImplementedError(
            "M-RoPE belongs to the serving slice of the port (ROADMAP.md)")
    # "learned" / "none": positions handled at the embedding layer.
    return q, k


def _sdpa(q, k, v, mask, scale, softcap, q_per_kv):
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D'), mask: (Sq,Sk) or (B,Sq,Sk).
    The f32 products of model-dtype operands are exact, so upcasting them
    is the reference's f32-accumulated product."""
    b, sq, h, dq = q.shape
    hkv = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, q_per_kv, dq).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]              # (B,Hkv,1,D,Sk)
    logits = torch.matmul(qg.to(f32), kt.to(f32)) * scale   # (B,Hkv,G,Sq,Sk)
    logits = _softcap(logits, softcap)
    if mask.dim() == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    vt = v.permute(0, 2, 1, 3)[:, :, None]              # (B,Hkv,1,Sk,D')
    ctx = torch.matmul(probs.to(q.dtype).to(f32), vt.to(f32))
    return (ctx.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])
            .to(q.dtype))


def _sdpa_causal_chunked(q, k, v, scale, softcap, q_per_kv, window,
                         kv_lengths):
    """Causal SDPA over query chunks; the same math as ``_sdpa`` with a
    causal(+window)(+kv_lengths) mask, with each chunk's fully masked key
    range skipped."""
    b, sq, h, dq = q.shape
    sk = k.shape[1]
    cq = SDPA_Q_CHUNK
    dev = q.device
    if sq <= cq or sq % cq != 0 or sq != sk:
        mask = causal_window_mask(sq, sk, window, device=dev)
        if kv_lengths is not None:
            mask = mask[None] & (torch.arange(sk, device=dev)[None, None, :]
                                 < kv_lengths[:, None, None])
        return _sdpa(q, k, v, mask, scale, softcap, q_per_kv)

    outs = []
    for i in range(sq // cq):
        q_lo = i * cq
        # earliest key any query in this chunk can see (chunk-aligned)
        k_lo = 0
        if window:
            k_lo = max(0, ((q_lo - window + 1) // cq) * cq)
        k_hi = q_lo + cq                            # causal bound
        mask = causal_window_mask(cq, k_hi - k_lo, window,
                                  offset=q_lo - k_lo, device=dev)
        if kv_lengths is not None:
            kpos = torch.arange(k_lo, k_hi, device=dev)
            mask = mask[None] & (kpos[None, None, :]
                                 < kv_lengths[:, None, None])
        outs.append(_sdpa(q[:, q_lo:q_lo + cq], k[:, k_lo:k_hi],
                          v[:, k_lo:k_hi], mask, scale, softcap, q_per_kv))
    return torch.cat(outs, dim=1)


def gqa_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  mode: str = "train",
                  kv_lengths: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Causal self-attention over x (B, S, d) in "train" or "prefill"
    mode without a cache → (B, S, d)."""
    if mode not in ("train", "prefill"):
        raise NotImplementedError(
            f"attention mode {mode!r} (with a KV cache) belongs to the "
            f"serving slice of the port (ROADMAP.md)")
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, hkv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    q, k = _position_embed(cfg, q, k, positions)
    scale = 1.0 / (hd ** 0.5)
    ctx = _sdpa_causal_chunked(q, k, v, scale, cfg.attn_logit_softcap,
                               cfg.q_per_kv, cfg.sliding_window, kv_lengths)
    return ctx.reshape(b, s, h * hd) @ p["wo"].to(dt)
