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

Cross attention (the Whisper decoder's) has no cache: every call
projects the encoder output to keys and values again, as the reference
does.

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
from repro_torch.launch.sharding import model_copy
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


def _rope(cfg: ModelConfig, x, positions, mrope_positions):
    """x (B, S, H, D) rotated at ``positions`` (B, S), or for M-RoPE at
    ``mrope_positions`` (3, B, S); "learned" / "none": positions are
    handled at the embedding layer."""
    if cfg.pos_type == "rope":
        return apply_rope(x, positions, theta=cfg.rope_theta,
                          fraction=cfg.rope_fraction)
    if cfg.pos_type == "mrope":
        assert mrope_positions is not None, "mrope needs (3,B,S) positions"
        return apply_mrope(x, mrope_positions, theta=cfg.rope_theta,
                           sections=cfg.mrope_sections)
    return x


# Sequence-parallel attention (the reference's §Perf iteration C): where
# the heads do not divide the model axis, q is sharded over its sequence
# on that axis and k, v replicated, so attention stays shard-local. A
# model placed on the model axis (``launch.sharding.tp_shard``) takes it
# at train and prefill wherever its KV heads do not divide the axis: the
# hook gets the model's ``TensorParallel`` and plain local tensors, and
# the core runs on this rank's rows with their offset into the mask and
# the RoPE tables.


def _seq_shard(q, k, v, tp):
    """q (B, S, H, D) → this model rank's rows of its sequence
    (``tp.seq_bounds(S)``); k and v whole (every rank holds them)."""
    lo, hi = tp.seq_bounds(q.shape[1])
    return q[:, lo:hi], k, v


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
                         kv_lengths, q_offset: int = 0):
    """Causal SDPA over query chunks; the same math as ``_sdpa`` with a
    causal(+window)(+kv_lengths) mask, with each chunk's fully masked key
    range skipped. ``q_offset``: the position of q's first row among the
    keys (a sequence-parallel rank's rows)."""
    b, sq, h, dq = q.shape
    sk = k.shape[1]
    cq = SDPA_Q_CHUNK
    dev = q.device
    if q_offset or sq <= cq or sq % cq != 0 or sq != sk:
        mask = causal_window_mask(sq, sk, window, offset=q_offset,
                                  device=dev)
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


def _fill_cache(buf: torch.Tensor, new: torch.Tensor, lo: int = 0,
                c: Optional[int] = None) -> None:
    """Prefill: write the prompt's rows (B, S, ...) into the cache buffer
    (B, C, ...) in place — rows [0, S) when C >= S, else the ring-
    consistent tail (token t at slot t % C). A cache shorter than the
    prompt takes the tail even without a sliding window, as in the
    reference. ``buf`` may hold only rows [lo, lo + its length) of a
    C-row cache (a shard of its sequence): it gets those rows."""
    s, cl = new.shape[1], buf.shape[1]
    c = cl if c is None else c
    if c >= s:
        hi = min(lo + cl, s)
        if hi > lo:
            buf[:, :hi - lo].copy_(new[:, lo:hi])
    else:
        buf.copy_(torch.roll(new[:, s - c:], s % c, dims=1)[:, lo:lo + cl])


def _decode_slots(buf: torch.Tensor, new: torch.Tensor,
                  cache_pos: torch.Tensor, lo: int = 0,
                  c: Optional[int] = None) -> None:
    """Decode: write each sequence's new row (B, 1, ...) at slot
    ``cache_pos % C`` of its cache, in place. Where ``buf`` holds only
    rows [lo, lo + its length) of a C-row cache, only the sequences whose
    slot falls there are written (no read back to the host)."""
    b, cl = buf.shape[0], buf.shape[1]
    c = cl if c is None else c
    slot = torch.remainder(cache_pos.to(torch.long), c)
    rows = torch.arange(b, device=buf.device)
    row = new[:, 0].to(buf.dtype)
    if cl == c:
        buf[rows, slot] = row
        return
    at = slot - lo
    own = ((at >= 0) & (at < cl)).view((b,) + (1,) * (row.dim() - 1))
    at = at.clamp(0, cl - 1)
    buf[rows, at] = torch.where(own, row, buf[rows, at])


def _decode_valid(cache_pos: torch.Tensor, c: int) -> torch.Tensor:
    """(B, C) written slots: all of them once the ring is full."""
    n_written = torch.clamp(cache_pos + 1, max=c)
    return (torch.arange(c, device=cache_pos.device)[None, :]
            < n_written[:, None])


def split_cols(tp, w: torch.Tensor, width: int) -> bool:
    """The tables split this weight's ``width`` columns over the model
    axis (its local width is short of them)."""
    return tp is not None and w.shape[-1] < width


def gather_cols(tp, ys, widths, *, scatter: bool = False):
    """Column-parallel products' columns from every model rank, where
    their weights were split (a local width short of its ``widths``
    entry); one gather where every weight was. ``scatter``: the consumer
    differs by rank (a sequence-parallel core's rows), so the gathers'
    backward is a reduce-scatter, and a product computed whole (alike on
    every rank) enters it through ``TensorParallel.copy``; else every
    rank consumes them alike."""
    split = [y.shape[-1] < w for y, w in zip(ys, widths)]
    if not all(split):
        return [tp.gather_model(y, scatter=scatter) if s
                else model_copy(tp, y) if scatter else y
                for y, s in zip(ys, split)]
    n = [y.shape[-1] for y in ys]
    whole = tp.gather_model(torch.cat(ys, dim=-1), scatter=scatter
                            ).unflatten(-1, (tp.size, sum(n)))
    return [t.flatten(-2) for t in torch.split(whole, n, dim=-1)]


def partial_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w accumulated and returned in float32 (bf16 operands' products
    are exact in it): a rank's partial sum of a row-parallel product,
    which the all-reduce sums in f32 and rounds once, as one process
    rounds its whole product once (R partials rounded to bf16 each would
    round R + 1 times)."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), w,
                        out_dtype=torch.float32).unflatten(0, a.shape[:-1])
    return a.float() @ w.float()


def row_parallel(tp, a: torch.Tensor, w: torch.Tensor, width: int, *,
                 scattered: bool = False) -> torch.Tensor:
    """a @ w where ``w`` (width, d) may hold only this model rank's rows
    (the tables split ``wo``, ``w_down``, ``out_proj`` on their input
    dim): the rank's columns of a whole ``a``, or its own ``a``, times
    its rows (``partial_product``), summed over the ranks (the sum's
    consumer is alike on every rank). A whole ``a`` computed alike on
    every rank enters the rank's columns through ``TensorParallel.copy``;
    ``scattered``: it comes from a gather whose backward already
    reduce-scatters (``gather_seq(..., scatter=True)``)."""
    if tp is None or w.shape[0] == width:
        return a @ w
    n = w.shape[0]
    if a.shape[-1] == width:
        if not scattered:
            a = model_copy(tp, a)
        a = a[..., tp.rank * n:(tp.rank + 1) * n]
    return tp.all_reduce(partial_product(a, w)).to(a.dtype)


def col_products(tp, x: torch.Tensor, p, weights):
    """x @ p[name] for each (name, width) of ``weights``, column-parallel
    products of one input: where the tables split any of their columns,
    x enters the rank's columns through one ``TensorParallel.copy``
    shared by the split ones; a whole weight's product stays alike on
    every rank."""
    split = [split_cols(tp, p[n], w) for n, w in weights]
    xc = model_copy(tp, x) if any(split) else x
    return [(xc if s else x) @ p[n].to(x.dtype)
            for (n, _), s in zip(weights, split)]


def _merge_shards(tp, part, dtype):
    """The softmax partials (m, l, acc) of every model rank's sequence
    shard, gathered in rank order and merged → (B, 1, H, D)."""
    m, l, acc = part
    b, h, n, d = acc.shape
    packed = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    allp = tp.stack_model(packed).permute(1, 2, 0, 3, 4).reshape(
        b, h, tp.size * n, d + 2)
    return kops.merge_partials(allp[..., 0].contiguous(),
                               allp[..., 1].contiguous(),
                               allp[..., 2:].contiguous(), dtype)


def gqa_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  mrope_positions: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  mode: str = "train",
                  kv_lengths: Optional[torch.Tensor] = None,
                  tp=None, cache_rows: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Causal self-attention over x (B, S, d) → ((B, S, d), cache).

    ``tp``: the model's ``TensorParallel`` where it is placed on the
    model axis; ``p`` then holds this rank's shards, and the head counts
    come from their widths. Where the KV heads divide the axis, each rank
    keeps its own q and KV heads (and cache heads) and the context goes
    through its rows of ``wo``, summed over the ranks. Where they do not
    (the tables split ``wk`` through a head, and the cache by its
    sequence), every rank gathers whole q, k and v; train and prefill run
    sequence-parallel (``_seq_shard``) and gather the context, decode
    runs #5 on the rank's cache rows and merges every rank's partials.
    ``cache_rows`` (lo, C): the cache buffers hold rows [lo, lo + their
    length) of a C-row cache."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = x.dtype
    width = cfg.num_heads * hd
    heads = tp is None or cfg.num_kv_heads % tp.size == 0
    kv = cfg.num_kv_heads * hd
    q, k, v = col_products(tp, x, p, (("wq", width), ("wk", kv),
                                      ("wv", kv)))
    if not heads:
        # train and prefill: each rank's query rows attend (a consumer
        # that differs by rank); decode runs every head alike
        q, k, v = gather_cols(tp, (q, k, v), (width, kv, kv),
                              scatter=mode != "decode")
    h, hkv = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        # the replicated scales meet the rank's heads (or its rows)
        q = rms_norm(q, model_copy(tp, p["q_scale"]), cfg.norm_eps)
        k = rms_norm(k, model_copy(tp, p["k_scale"]), cfg.norm_eps)
    scale = 1.0 / (hd ** 0.5)
    wo = p["wo"].to(dt)
    # wo split by its rows: the gathered context enters the rank's rows
    split_wo = not heads and wo.shape[0] < width

    if mode in ("train", "prefill"):
        lo = 0
        if not heads:                   # q: this rank's rows from here on
            q, k, v = _seq_shard(q, k, v, tp)
            lo = tp.seq_bounds(s)[0]
        rows = slice(lo, lo + q.shape[1])
        q = _rope(cfg, q, positions[:, rows], None if mrope_positions is None
                  else mrope_positions[:, :, rows])
        k = _rope(cfg, k, positions, mrope_positions)
        ctx = _sdpa_causal_chunked(q, k, v, scale, cfg.attn_logit_softcap,
                                   h // hkv, cfg.sliding_window,
                                   kv_lengths, q_offset=lo)
        if not heads:
            ctx = tp.gather_seq(ctx, s, scatter=split_wo)
        if mode == "prefill" and cache is not None:
            c_lo, c = cache_rows or (0, None)
            _fill_cache(cache["k"], k, c_lo, c)
            _fill_cache(cache["v"], v, c_lo, c)
        else:
            cache = None
        return row_parallel(tp, ctx.reshape(b, s, h * hd), wo, width,
                            scattered=split_wo), cache

    # ---- decode: s == 1; cache_pos (B,) per-slot token counts ----------
    assert cache is not None and cache_pos is not None
    q = _rope(cfg, q, positions, mrope_positions)
    k = _rope(cfg, k, positions, mrope_positions)
    c_lo, c = cache_rows or (0, cache["k"].shape[1])
    _decode_slots(cache["k"], k, cache_pos, c_lo, c)
    _decode_slots(cache["v"], v, cache_pos, c_lo, c)
    cl = cache["k"].shape[1]
    valid = _decode_valid(cache_pos, c)[:, c_lo:c_lo + cl]
    kw = dict(scale=scale, softcap=cfg.attn_logit_softcap, q_per_kv=h // hkv)
    if cl == c:
        ctx = kops.decode_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                                    valid, **kw)
    else:                   # the rank's shard of the sequence: #5's split
        ctx = _merge_shards(tp, kops.decode_attention(
            q, cache["k"].to(dt), cache["v"].to(dt), valid, partials=True,
            **kw), dt)
    return row_parallel(tp, ctx.reshape(b, 1, h * hd), wo, width), cache


# ===========================================================================
# Cross attention (whisper decoder)
# ===========================================================================


def cross_attn_init(gen: torch.Generator, cfg: ModelConfig,
                    dtype=torch.float32) -> dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"wq": dense_init(gen, d, h * hd, dtype=dtype),
            "wk": dense_init(gen, d, h * hd, dtype=dtype),
            "wv": dense_init(gen, d, h * hd, dtype=dtype),
            "wo": dense_init(gen, h * hd, d, dtype=dtype)}


def full_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   x: torch.Tensor, src: torch.Tensor, *, kv_heads: int,
                   tp=None, seq_parallel: bool = False) -> torch.Tensor:
    """Every query of x (B, Sq, d) over every row of src (B, Sk, d), no
    mask and no positions: Whisper's cross attention (src the encoder's
    output) and its encoder's self-attention (src = x), with ``kv_heads``
    key/value heads.

    ``tp``: as ``gqa_attention``'s. Where the KV heads divide the model
    axis each rank keeps its heads and the context goes through its rows
    of ``wo``, summed over the ranks. Where they do not, every rank
    gathers whole q, k and v (``gather_cols``); with ``seq_parallel`` it
    attends its rows of the queries (``_seq_shard``) and gathers the
    context, else all of them."""
    b, sq, _ = x.shape
    sk = src.shape[1]
    hd, dt = cfg.head_dim, x.dtype
    width, kv = cfg.num_heads * hd, kv_heads * hd
    heads = tp is None or kv_heads % tp.size == 0
    if src is x:
        q, k, v = col_products(tp, x, p, (("wq", width), ("wk", kv),
                                          ("wv", kv)))
    else:
        q, = col_products(tp, x, p, (("wq", width),))
        k, v = col_products(tp, src, p, (("wk", kv), ("wv", kv)))
    # sequence-parallel (the encoder): each rank's query rows attend, a
    # consumer that differs by rank; else every rank runs every head
    split = not heads and seq_parallel
    if not heads and src is x:          # one packed gather
        q, k, v = gather_cols(tp, (q, k, v), (width, kv, kv), scatter=split)
    elif not heads:                     # q's rows are not src's
        q, = gather_cols(tp, (q,), (width,), scatter=split)
        k, v = gather_cols(tp, (k, v), (kv, kv), scatter=split)
    h, hkv = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(b, sq, h, hd)
    k = k.reshape(b, sk, hkv, hd)
    v = v.reshape(b, sk, hkv, hd)
    wo = p["wo"].to(dt)
    split_wo = split and wo.shape[0] < width
    if split:
        q, k, v = _seq_shard(q, k, v, tp)
    mask = torch.ones((q.shape[1], sk), dtype=torch.bool, device=x.device)
    ctx = _sdpa(q, k, v, mask, 1.0 / (hd ** 0.5), 0.0, h // hkv)
    if split:
        ctx = tp.gather_seq(ctx, sq, scatter=split_wo)
    return row_parallel(tp, ctx.reshape(b, sq, h * hd), wo, width,
                        scattered=split_wo)


def cross_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, enc: torch.Tensor, tp=None
                    ) -> torch.Tensor:
    """x: (B, Sq, d) decoder states; enc: (B, Sk, d) encoder output; every
    query sees every encoder frame. ``tp``: see ``full_attention``."""
    return full_attention(p, cfg, x, enc, kv_heads=cfg.num_heads, tp=tp)


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


def _head_cols(tp, y: torch.Tensor, width: int) -> torch.Tensor:
    """A column-parallel product's output (``width`` columns, heads
    contiguous) where the heads divide the model axis: this rank's heads'
    columns, sliced from a whole ``y`` (a weight the tables replicate,
    such as DeepSeek-V2-Lite's ``w_q``; y, alike on every rank, enters
    the rank's heads)."""
    if tp is None or y.shape[-1] < width:
        return y
    n = width // tp.size
    return model_copy(tp, y)[..., tp.rank * n:(tp.rank + 1) * n]


def _whole(tp, w: torch.Tensor, width: int) -> torch.Tensor:
    """A weight whose columns the tables may split through a head, whole
    (gathered over the model axis where they did)."""
    return w if w.shape[-1] == width else tp.gather_model(w)


def _mla_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
             tp=None):
    """The shared projections → q (B, S, ·) before its heads are split
    (this rank's columns where ``w_uq`` is split), ckv, k_rope."""
    m = cfg.mla
    dt = x.dtype
    h = cfg.num_heads
    if m.q_lora_rank:
        cq = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
        q, = col_products(tp, cq, p, (("w_uq", h * m.qk_head_dim),))
    else:
        q, = col_products(tp, x, p, (("w_q", h * m.qk_head_dim),))
    ckv = rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"].to(dt))[:, :, None, :], positions,
                        theta=cfg.rope_theta)[:, :, 0, :]
    return q, ckv, k_rope


def _mla_q(cfg: ModelConfig, q: torch.Tensor, positions: torch.Tensor):
    """q (B, S, H' · qk) → q_nope, q_rope (RoPE'd) of its H' heads."""
    m = cfg.mla
    q = q.unflatten(-1, (-1, m.qk_head_dim))
    return q[..., :m.qk_nope_head_dim], apply_rope(
        q[..., m.qk_nope_head_dim:], positions, theta=cfg.rope_theta)


def mla_attention(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  cache: Optional[dict] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  mode: str = "train",
                  kv_lengths: Optional[torch.Tensor] = None,
                  tp=None, cache_rows: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA over x (B, S, d) → ((B, S, d), cache): the expanded-head form
    for train/prefill, the matrix-absorbed latent form for decode.

    ``tp``: the model's ``TensorParallel`` where it is placed on the
    model axis (``p`` then holds this rank's shards; ``w_dkv``, ``w_kr``
    and so ckv and k_rope are whole on every rank, the latent cache split
    by its sequence). Where the heads divide the axis, each rank keeps its
    heads of q, k_nope and v (``w_uq``/``w_uk``/``w_uv`` by columns, a
    replicated ``w_q`` sliced); prefill attends them over the whole prompt
    and the context goes through the rank's rows of ``wo``, summed over
    the ranks. Decode gathers every rank's absorbed queries (one packed
    gather), runs #6's partials on the rank's cache rows, merges every
    rank's partials and keeps its heads of the latent context. Where the
    heads do not divide the axis (the tables split those columns through
    a head), every rank gathers whole q, k_nope and v; prefill runs
    sequence-parallel (``_seq_shard``) and gathers the context; decode
    takes ``w_uk`` and ``w_uv`` whole and runs all heads on every rank.
    ``cache_rows`` (lo, C): the cache buffers hold rows [lo, lo + their
    length) of a C-row cache."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dt = x.dtype
    scale = 1.0 / (m.qk_head_dim ** 0.5)
    heads = tp is None or h % tp.size == 0
    wo = p["wo"].to(dt)
    width = h * m.v_head_dim
    q, ckv, k_rope = _mla_qkv(p, cfg, x, positions, tp)

    if mode in ("train", "prefill"):
        widths = (h * m.qk_head_dim, h * m.qk_nope_head_dim, width)
        k_nope, v = col_products(tp, ckv, p, (("w_uk", widths[1]),
                                              ("w_uv", width)))
        if heads:
            q, k_nope, v = (_head_cols(tp, y, n)
                            for y, n in zip((q, k_nope, v), widths))
        else:
            # each rank's query rows attend: a consumer that differs by
            # rank
            q, k_nope, v = gather_cols(tp, (q, k_nope, v), widths,
                                       scatter=True)
        q_nope, q_rope = _mla_q(cfg, q, positions)
        hl = q_nope.shape[2]
        k_nope = k_nope.reshape(b, s, hl, m.qk_nope_head_dim)
        v = v.reshape(b, s, hl, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        # the shared rope key, alike on every rank, meets its heads
        k = torch.cat([k_nope, model_copy(tp, k_rope)[:, :, None, :].expand(
            b, s, hl, m.qk_rope_head_dim)], dim=-1)
        split_wo = not heads and wo.shape[0] < width
        lo = 0
        if not heads:                   # q: this rank's rows from here on
            q, k, v = _seq_shard(q, k, v, tp)
            lo = tp.seq_bounds(s)[0]
        ctx = _sdpa_causal_chunked(q, k, v, scale, 0.0, 1,
                                   cfg.sliding_window, kv_lengths,
                                   q_offset=lo)
        if not heads:
            ctx = tp.gather_seq(ctx, s, scatter=split_wo)
        if mode == "prefill" and cache is not None:
            c_lo, c = cache_rows or (0, None)
            _fill_cache(cache["ckv"], ckv, c_lo, c)
            _fill_cache(cache["krope"], k_rope, c_lo, c)
        else:
            cache = None
        return row_parallel(tp, ctx.reshape(b, s, -1), wo, width,
                            scattered=split_wo), cache

    # ---- decode: matrix-absorbed latent attention; cache_pos (B,) -------
    assert cache is not None and cache_pos is not None
    q = _head_cols(tp, q, h * m.qk_head_dim) if heads else gather_cols(
        tp, (q,), (h * m.qk_head_dim,))[0]
    q_nope, q_rope = _mla_q(cfg, q, positions)
    hl = q_nope.shape[2]
    w_uk, w_uv = p["w_uk"].to(dt), p["w_uv"].to(dt)
    if heads:
        w_uk = _head_cols(tp, w_uk, h * m.qk_nope_head_dim)
        w_uv = _head_cols(tp, w_uv, width)
    else:
        w_uk = _whole(tp, w_uk, h * m.qk_nope_head_dim)
        w_uv = _whole(tp, w_uv, width)
    c_lo, c = cache_rows or (0, cache["ckv"].shape[1])
    _decode_slots(cache["ckv"], ckv, cache_pos, c_lo, c)
    _decode_slots(cache["krope"], k_rope, cache_pos, c_lo, c)
    cl = cache["ckv"].shape[1]
    valid = _decode_valid(cache_pos, c)[:, c_lo:c_lo + cl]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk.reshape(
        m.kv_lora_rank, hl, m.qk_nope_head_dim))             # (B,1,H',R)
    ckv_c, kr_c = cache["ckv"].to(dt), cache["krope"].to(dt)
    if cl == c:
        ctx_lat = kops.mla_decode_attention(q_abs, q_rope, ckv_c, kr_c,
                                            valid, scale=scale)
    else:               # the rank's shard of the sequence: #6's split
        if hl < h:      # every head meets every row: the queries of all
            q_abs, q_rope = torch.split(tp.gather_model(torch.cat(
                [q_abs, q_rope], dim=-1), 2), [m.kv_lora_rank,
                                               m.qk_rope_head_dim], dim=-1)
        ctx_lat = _merge_shards(tp, kops.mla_decode_attention(
            q_abs, q_rope, ckv_c, kr_c, valid, scale=scale, partials=True),
            dt)
        if hl < h:
            ctx_lat = ctx_lat[:, :, tp.rank * hl:(tp.rank + 1) * hl]
    ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, w_uv.reshape(
        m.kv_lora_rank, hl, m.v_head_dim))
    return row_parallel(tp, ctx.reshape(b, 1, -1), wo, width), cache
