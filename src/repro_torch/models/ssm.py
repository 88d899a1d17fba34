"""Mamba2 (SSD) block, as the reference computes it: the chunked scan for
train and prefill, the O(1) recurrent state update for decode.

Within a chunk the quadratic form is a product of its own; across chunks
a loop over the chunks (the reference's ``lax.scan``) carries the
(H, P, N) state. The projections stay separate (z / x / BC / dt and two
depthwise convolutions), with the reference's names.

Cache (every leaf f32, whatever the cache dtype): ``{"ssm": (B, H, P, N),
"conv_x": (B, K-1, d_in), "conv_bc": (B, K-1, 2N)}``; the conv states
hold the last K-1 pre-activation inputs.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import model_copy, stat_sum
from repro_torch.models.attention import (col_products, gather_cols,
                                          row_parallel)
from repro_torch.models.layers import dense_init, rms_norm


def _dims(cfg: ModelConfig):
    sc = cfg.ssm
    return sc, sc.d_inner(cfg.d_model), sc.num_heads(cfg.d_model)


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
                ) -> dict:
    """The reference's leaves and scales; ``A_log``, ``D`` and ``dt_bias``
    are f32 whatever ``dtype``."""
    sc, d_in, nheads = _dims(cfg)
    d, n2, dev = cfg.d_model, 2 * sc.state_dim, gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    u = (torch.rand((nheads,), generator=gen, device=dev)
         * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = torch.log(torch.expm1(torch.exp(u)))     # inverse softplus

    def conv(ch):
        return (torch.randn((sc.conv_dim, ch), generator=gen, device=dev)
                / math.sqrt(sc.conv_dim)).to(dtype)
    return {
        "in_z": dense_init(gen, d, d_in, dtype=dtype),
        "in_x": dense_init(gen, d, d_in, dtype=dtype),
        "in_bc": dense_init(gen, d, n2, dtype=dtype),
        "in_dt": dense_init(gen, d, nheads, dtype=dtype),
        "conv_x_w": conv(d_in),
        "conv_x_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "conv_bc_w": conv(n2),
        "conv_bc_b": torch.zeros((n2,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, nheads + 1, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": dt_bias.to(torch.float32),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_in, d, dtype=dtype),
    }


def mamba2_cache_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    sc, d_in, nheads = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ssm": torch.zeros((batch, nheads, sc.head_dim, sc.state_dim), **f32),
        "conv_x": torch.zeros((batch, sc.conv_dim - 1, d_in), **f32),
        "conv_bc": torch.zeros((batch, sc.conv_dim - 1, 2 * sc.state_dim),
                               **f32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv + silu. x: (B, S, ch); w: (K, ch). Returns
    the output and the last K-1 inputs (pre-activation) in f32."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, ch)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):].to(torch.float32)
    return F.silu(y + b.to(x.dtype)), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l) with out[i, j] = sum_{k=j+1..i} a_k for
    i >= j, -inf otherwise."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(l, device=a.device)[:, None]
    j = torch.arange(l, device=a.device)[None, :]
    return torch.where(i >= j, diff, -math.inf)


def _ssd_chunked(xh, dt, A, B, C, chunk, init_state):
    """Chunked SSD scan.

    xh: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, n).
    Returns y (b, s, h, p) and final state (b, h, p, n), in f32.
    """
    b, s, h, p = xh.shape
    n = B.shape[-1]
    assert s % chunk == 0, (s, chunk)
    c = s // chunk
    f32 = torch.float32
    xh = xh.to(f32).reshape(b, c, chunk, h, p)
    dt = dt.to(f32).reshape(b, c, chunk, h)
    Bm = B.to(f32).reshape(b, c, chunk, n)
    Cm = C.to(f32).reshape(b, c, chunk, n)
    xdt = xh * dt[..., None]                              # fold dt into x

    a = (dt * A[None, None, None, :]).movedim(-1, 2)      # (b,c,h,l)
    a_cum = torch.cumsum(a, dim=-1)                       # inclusive

    # intra-chunk: (C_i . B_j) L_ij x_j over the chunk
    L = torch.exp(_segsum(a))                             # (b,c,h,l,l)
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", cb[:, :, None] * L, xdt)

    # per-chunk input states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)     # (b,c,h,l)
    states = torch.einsum("bcjn,bchj,bcjhp->bchpn", Bm, decay_states, xdt)

    # inter-chunk recurrence; each chunk reads the state before it
    chunk_decay = torch.exp(a_cum[..., -1])               # (b,c,h)
    carry = (init_state.to(f32) if init_state is not None
             else torch.zeros((b, h, p, n), dtype=f32, device=xh.device))
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                # (b,c,h,p,n)

    state_decay = torch.exp(a_cum)                        # (b,c,h,l)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", Cm, prev_states,
                         state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), carry


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               eps: float, tp=None, width: Optional[int] = None
               ) -> torch.Tensor:
    """The gated RMSNorm ``rms_norm(y * silu(z), scale)`` over all
    ``width`` channels. Where y and z hold only this model rank's
    channels (``scale`` its slice of them), each rank's f32 sum of
    squares is all-reduced over the model axis before the rsqrt: a norm
    over the rank's channels alone would be another function. Each rank
    applies the sum to its own channels, so its backward sums over the
    ranks too (``launch.sharding.stat_sum``)."""
    g = y * F.silu(z)
    if tp is None or g.shape[-1] == width:
        return rms_norm(g, scale, eps)
    f32 = torch.float32
    g32 = g.to(f32)
    var = stat_sum(tp, (g32 * g32).sum(-1, keepdim=True)) / width
    return (g32 * torch.rsqrt(var + eps) * scale.to(f32)).to(g.dtype)


def mamba2_apply(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, *, cache: Optional[dict] = None,
                 mode: str = "train", tp=None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) → ((B, S, d), the new cache leaves or None). Decode
    takes S == 1 and the layer's cache; prefill returns the cache after
    the prompt.

    ``tp``: the model's ``TensorParallel`` where it is placed on the
    model axis; ``p`` and the cache then hold this rank's shards (the
    tables split ``in_z``, ``in_x``, ``in_dt``, the x convolution, its
    state and the ``ssm`` state by head, ``out_proj`` by rows; ``in_bc``
    and the B/C convolution are whole, so B and C are). Where the rank's
    channels are whole heads it runs them: its slices of ``A_log``,
    ``D``, ``dt_bias`` and ``norm_scale``, the gated norm's sum of
    squares all-reduced (``gated_norm``), its rows of ``out_proj``
    summed over the ranks. Where they split a head (the heads do not
    divide the axis: ``in_dt`` and the ``ssm`` state are whole), the x
    convolution runs on the rank's channels, x and z are gathered, every
    rank runs every head and keeps the whole state, and the rank's
    channels go through its rows of ``out_proj``. In a train step the
    tensors every rank holds alike — x, B and C, and the replicated
    per-head ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` — enter the
    rank's heads through ``TensorParallel.copy``."""
    sc, d_in, nheads = _dims(cfg)
    hp = sc.head_dim
    b, s, _ = x.shape
    dt_ = x.dtype
    z, xc, bc, dt_raw = col_products(tp, x, p, (
        ("in_z", d_in), ("in_x", d_in), ("in_bc", 2 * sc.state_dim),
        ("in_dt", nheads)))
    # this rank's channels [lo, lo + n) and heads [h0, h0 + hl)
    n = xc.shape[-1]
    heads = n % hp == 0
    lo = 0 if n == d_in else tp.rank * n
    h0, hl = (lo // hp, n // hp) if heads else (0, nheads)
    mine = n < d_in and heads           # the rank's own heads

    def own(t):
        # a tensor alike on every rank, as the rank's heads take it
        return model_copy(tp, t) if mine else t
    if dt_raw.shape[-1] > hl:
        dt_raw = own(dt_raw)[..., h0:h0 + hl]
    heads_of = slice(h0, h0 + hl)
    dt = F.softplus(dt_raw.to(torch.float32)
                    + own(p["dt_bias"])[heads_of][None, None, :])
    A = -torch.exp(own(p["A_log"])[heads_of])
    Dh = own(p["D"])[heads_of]
    scale = p["norm_scale"]
    if heads and n < scale.shape[0]:
        scale = own(scale)[lo:lo + n]

    def gather(xs, z):
        # a head split: the ranks' x and z channels, whole, every head
        # then run alike on every rank
        if heads:
            return xs, z
        return gather_cols(tp, (xs, z), (d_in, d_in))

    def finish(y, z):
        y = gated_norm(y, z, scale, cfg.norm_eps, tp, d_in)
        return row_parallel(tp, y, p["out_proj"].to(dt_), d_in)

    if mode == "decode":
        assert s == 1 and cache is not None
        xs, new_cx = _causal_conv(xc, p["conv_x_w"], p["conv_x_b"],
                                  cache["conv_x"])
        bcs, new_cbc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                    cache["conv_bc"])
        xs, z = gather(xs, z)
        bcs = own(bcs)
        Bv, Cv = torch.chunk(bcs, 2, dim=-1)
        xh = xs.reshape(b, hl, hp).to(torch.float32)
        dt1 = dt[:, 0]                                    # (b,h)
        dA = torch.exp(dt1 * A[None, :])
        Bv1 = Bv[:, 0].to(torch.float32)                  # (b,n)
        Cv1 = Cv[:, 0].to(torch.float32)
        new_state = (cache["ssm"] * dA[..., None, None]
                     + torch.einsum("bh,bhp,bn->bhpn", dt1, xh, Bv1))
        y = torch.einsum("bhpn,bn->bhp", new_state, Cv1)
        y = y + Dh[None, :, None] * xh
        y = y.reshape(b, 1, -1).to(dt_)
        return finish(y, z), {
            "ssm": new_state, "conv_x": new_cx, "conv_bc": new_cbc}

    # train / prefill ------------------------------------------------------
    xs, new_cx = _causal_conv(xc, p["conv_x_w"], p["conv_x_b"], None)
    bcs, new_cbc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"], None)
    xs, z = gather(xs, z)
    bcs = own(bcs)
    Bv, Cv = torch.chunk(bcs, 2, dim=-1)
    xh = xs.reshape(b, s, hl, hp)
    chunk = min(sc.chunk, s)
    # pad to a chunk multiple (padded dt = 0: no state update, no decay)
    pad = (-s) % chunk
    if pad:
        xh, Bv, Cv = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                      for t in (xh, Bv, Cv))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, final_state = _ssd_chunked(xh, dt, A, Bv, Cv, chunk, None)
    y = y[:, :s]
    y = y + Dh[None, None, :, None] * xh[:, :s].to(torch.float32)
    y = y.reshape(b, s, -1).to(dt_)
    out = finish(y, z)
    if mode == "prefill" and cache is not None:
        return out, {"ssm": final_state, "conv_x": new_cx,
                     "conv_bc": new_cbc}
    return out, None
