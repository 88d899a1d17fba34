"""Attention blocks: GQA (with its ring cache) and MLA, as the reference
computes them: logits in f32 from operands in the model dtype, masked
with -1e30, softmax in f32, probabilities cast to the model dtype for the
value product, the context cast back. Train/prefill attention is written
as explicit products and a softmax — ``F.scaled_dot_product_attention``
rounds differently and is a library kernel. Decode goes through
``kernels.ops`` to the hand-written decode kernels.

Cache conventions (the reference's):

* GQA cache: ``{"k": (B, C, Hkv, D), "v": (B, C, Hkv, D)}`` with
  ``C = min(max_len, window or max_len)``, indexed by ``pos % C``; keys
  are stored after RoPE, so slot order does not matter to the softmax.
* MLA cache: ``{"ckv": (B, C, kv_lora), "krope": (B, C, rope_dim)}`` —
  the latent cache; decode uses the matrix-absorbed form, so heads are
  never materialised per cache token.

``mode``: "train" (no cache), "prefill" (fills cache[0:S]), "decode"
(S == 1, attends to the cache at ``cache_pos``). Where the reference
returns new cache arrays, the port writes the given cache tensors in
place and returns them.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       rms_norm)

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


# ===========================================================================
# GQA
# ===========================================================================


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


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, c, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, c, hkv, hd), dtype=dtype,
                             device=device)}


def _position_embed(cfg: ModelConfig, q, k, positions, mrope_positions):
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
    elif cfg.pos_type == "mrope":
        assert mrope_positions is not None, "mrope needs (3,B,S) positions"
        q = apply_mrope(q, mrope_positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
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


def _fill_cache(buf: torch.Tensor, new: torch.Tensor) -> None:
    """Prefill: write the prompt's rows (B, S, ...) into the cache buffer
    (B, C, ...) in place — rows [0, S) when C >= S, else the ring-
    consistent tail (token t at slot t % C). A cache shorter than the
    prompt takes the tail even without a sliding window, as in the
    reference."""
    s, c = new.shape[1], buf.shape[1]
    if c >= s:
        buf[:, :s].copy_(new)
    else:
        buf.copy_(torch.roll(new[:, s - c:], s % c, dims=1))


def _decode_slots(buf: torch.Tensor, new: torch.Tensor,
                  cache_pos: torch.Tensor) -> None:
    """Decode: write each sequence's new row (B, 1, ...) at slot
    ``cache_pos % C`` of its cache, in place."""
    b, c = buf.shape[0], buf.shape[1]
    slot = torch.remainder(cache_pos.to(torch.long), c)
    buf[torch.arange(b, device=buf.device), slot] = new[:, 0].to(buf.dtype)


def _decode_valid(cache_pos: torch.Tensor, c: int) -> torch.Tensor:
    """(B, C) written slots: all of them once the ring is full."""
    n_written = torch.clamp(cache_pos + 1, max=c)
    return (torch.arange(c, device=cache_pos.device)[None, :]
            < n_written[:, None])


def gqa_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  mrope_positions: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  mode: str = "train",
                  kv_lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Causal self-attention over x (B, S, d) → ((B, S, d), cache)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, hkv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    q, k = _position_embed(cfg, q, k, positions, mrope_positions)
    scale = 1.0 / (hd ** 0.5)

    if mode in ("train", "prefill"):
        ctx = _sdpa_causal_chunked(q, k, v, scale, cfg.attn_logit_softcap,
                                   cfg.q_per_kv, cfg.sliding_window,
                                   kv_lengths)
        if mode == "prefill" and cache is not None:
            _fill_cache(cache["k"], k)
            _fill_cache(cache["v"], v)
        else:
            cache = None
        return ctx.reshape(b, s, h * hd) @ p["wo"].to(dt), cache

    # ---- decode: s == 1; cache_pos (B,) per-slot token counts ----------
    assert cache is not None and cache_pos is not None
    _decode_slots(cache["k"], k, cache_pos)
    _decode_slots(cache["v"], v, cache_pos)
    valid = _decode_valid(cache_pos, cache["k"].shape[1])
    ctx = kops.decode_attention(
        q, cache["k"].to(dt), cache["v"].to(dt), valid, scale=scale,
        softcap=cfg.attn_logit_softcap, q_per_kv=cfg.q_per_kv)
    return ctx.reshape(b, 1, h * hd) @ p["wo"].to(dt), cache


# ===========================================================================
# MLA (Multi-head Latent Attention)
# ===========================================================================


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
             ) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dev = gen.device
    p = {}
    if m.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, m.q_lora_rank, dtype=dtype)
        p["q_norm"] = torch.ones((m.q_lora_rank,), dtype=dtype, device=dev)
        p["w_uq"] = dense_init(gen, m.q_lora_rank, h * m.qk_head_dim,
                               dtype=dtype)
    else:
        p["w_q"] = dense_init(gen, d, h * m.qk_head_dim, dtype=dtype)
    p["w_dkv"] = dense_init(gen, d, m.kv_lora_rank, dtype=dtype)
    p["kv_norm"] = torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev)
    p["w_kr"] = dense_init(gen, d, m.qk_rope_head_dim, dtype=dtype)
    p["w_uk"] = dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim,
                           dtype=dtype)
    p["w_uv"] = dense_init(gen, m.kv_lora_rank, h * m.v_head_dim,
                           dtype=dtype)
    p["wo"] = dense_init(gen, h * m.v_head_dim, d, dtype=dtype)
    return p


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    m = cfg.mla
    c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {"ckv": torch.zeros((batch, c, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, c, m.qk_rope_head_dim), dtype=dtype,
                                 device=device)}


def _mla_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """The shared projections → q_nope, q_rope, ckv, k_rope."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dt = x.dtype
    if m.q_lora_rank:
        cq = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
        q = (cq @ p["w_uq"].to(dt)).reshape(b, s, h, m.qk_head_dim)
    else:
        q = (x @ p["w_q"].to(dt)).reshape(b, s, h, m.qk_head_dim)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        theta=cfg.rope_theta)
    ckv = rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"].to(dt))[:, :, None, :], positions,
                        theta=cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  cache: Optional[dict] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  mode: str = "train",
                  kv_lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA over x (B, S, d) → ((B, S, d), cache): the expanded-head form
    for train/prefill, the matrix-absorbed latent form for decode."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dt = x.dtype
    scale = 1.0 / (m.qk_head_dim ** 0.5)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, positions)

    if mode in ("train", "prefill"):
        k_nope = (ckv @ p["w_uk"].to(dt)).reshape(b, s, h,
                                                  m.qk_nope_head_dim)
        v = (ckv @ p["w_uv"].to(dt)).reshape(b, s, h, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        ctx = _sdpa_causal_chunked(q, k, v, scale, 0.0, 1,
                                   cfg.sliding_window, kv_lengths)
        if mode == "prefill" and cache is not None:
            _fill_cache(cache["ckv"], ckv)
            _fill_cache(cache["krope"], k_rope)
        else:
            cache = None
        return ctx.reshape(b, s, h * m.v_head_dim) @ p["wo"].to(dt), cache

    # ---- decode: matrix-absorbed latent attention; cache_pos (B,) -------
    assert cache is not None and cache_pos is not None
    _decode_slots(cache["ckv"], ckv, cache_pos)
    _decode_slots(cache["krope"], k_rope, cache_pos)
    valid = _decode_valid(cache_pos, cache["ckv"].shape[1])
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)      # (B,1,H,R)
    ctx_lat = kops.mla_decode_attention(
        q_abs, q_rope, cache["ckv"].to(dt), cache["krope"].to(dt), valid,
        scale=scale)                                          # (B,1,H,R)
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, h, m.v_head_dim)
    ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, w_uv)
    return ctx.reshape(b, 1, h * m.v_head_dim) @ p["wo"].to(dt), cache
