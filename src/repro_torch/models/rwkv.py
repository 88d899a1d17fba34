"""RWKV6 ("Finch") block, as the reference computes it: attention-free
time mixing with data-dependent decay [arXiv:2404.05892].

Per head (K = V = head_dim) the WKV recurrence is

    y_t[j] = sum_i r_t[i] * (S_t[i, j] + u[i] * k_t[i] * v_t[j])
    S_{t+1}[i, j] = w_t[i] * S_t[i, j] + k_t[i] * v_t[j]

with w_t = exp(-exp(decay_t)) data-dependent through a LoRA on the
token-shift mix. Train and prefill loop over time carrying S (the
reference's ``lax.scan``); decode is one O(1) step.

State (every leaf f32): ``{"wkv": (B, H, K, K), "shift_tm": (B, d),
"shift_cm": (B, d)}``; the shift states hold the last row of the block's
normed input.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import model_copy
from repro_torch.models.attention import (gather_cols, row_parallel,
                                          split_cols)
from repro_torch.models.layers import dense_init

_MIX = ("w", "k", "v", "r", "g")


def _heads(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
               ) -> dict:
    d, rc, dev = cfg.d_model, cfg.rwkv, gen.device
    h, hd = _heads(cfg)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=dev)
    return {
        # token-shift base mixes
        "maa_x": full((d,), 0.0),
        "maa": full((5, d), 0.0),
        # data-dependent mix LoRA: d -> 5*gate_lora -> 5*d
        "maa_w1": dense_init(gen, d, 5 * rc.gate_lora, dtype=dtype),
        "maa_w2": (torch.randn((5, rc.gate_lora, d), generator=gen,
                               device=dev)
                   * (1.0 / math.sqrt(rc.gate_lora))).to(dtype),
        # decay: base + LoRA
        "decay_base": full((d,), -6.0),
        "decay_w1": dense_init(gen, d, rc.decay_lora, dtype=dtype),
        "decay_w2": dense_init(gen, rc.decay_lora, d, dtype=dtype),
        "bonus_u": (torch.randn((h, hd), generator=gen, device=dev)
                    * 0.1).to(dtype),
        "wr": dense_init(gen, d, d, dtype=dtype),
        "wk": dense_init(gen, d, d, dtype=dtype),
        "wv": dense_init(gen, d, d, dtype=dtype),
        "wg": dense_init(gen, d, d, dtype=dtype),
        "wo": dense_init(gen, d, d, dtype=dtype),
        "ln_scale": full((h, hd), 1.0),
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": dense_init(gen, d, cfg.d_ff, dtype=dtype),
        "cm_wv": dense_init(gen, cfg.d_ff, d, dtype=dtype),
        "cm_wr": dense_init(gen, d, d, dtype=dtype),
    }


def rwkv6_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    h, hd = _heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"wkv": torch.zeros((batch, h, hd, hd), **f32),
            "shift_tm": torch.zeros((batch, cfg.d_model), **f32),
            "shift_cm": torch.zeros((batch, cfg.d_model), **f32)}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x: (B,S,d) -> previous-timestep tensor (B,S,d)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _shift_delta(x, prev, mode):
    """The token shift's difference ``shifted - x``."""
    if mode == "decode":
        return prev[:, None, :].to(x.dtype) - x
    return _token_shift(x, prev) - x


def _ddlerp(p, x, sx):
    """Data-dependent token-shift mixes for (w, k, v, r, g)."""
    dt = x.dtype
    xx = x + sx * p["maa_x"].to(dt)
    lo = torch.tanh(xx @ p["maa_w1"].to(dt))              # (B,S,5*r)
    b, s, _ = lo.shape
    lo = lo.reshape(b, s, 5, -1)
    mix = torch.einsum("bsgr,grd->gbsd", lo, p["maa_w2"].to(dt))
    return [x + sx * (p["maa"][i].to(dt) + mix[i])
            for i in range(len(_MIX))]


def _wkv_step(S, rt, kt, vt, wt, u):
    """One step of the recurrence: (B,H,K) inputs → (new S, y (B,H,K))."""
    a = kt[..., :, None] * vt[..., None, :]               # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", rt, S + u[None, :, :, None] * a)
    return wt[..., :, None] * S + a, y


def _wkv_scan(r, k, v, w, u, init_state):
    """r,k,v,w: (B,S,H,K); u: (H,K). Returns y (B,S,H,K), final
    (B,H,K,K), in f32."""
    f32 = torch.float32
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    S = init_state.to(f32)
    ys = []
    for t in range(r.shape[1]):
        S, y = _wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _group_norm(y: torch.Tensor, scale: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """Per-head normalisation of the WKV output (population variance).
    y: (B,S,H,K)."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps) * scale[None, None]


def rwkv6_time_mix(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   x: torch.Tensor, state: Optional[dict], mode: str,
                   tp=None):
    """The time mix of x (B, S, d) → ((B, S, d), its new state leaves).

    ``tp``: the model's ``TensorParallel`` where it is placed on the
    model axis; ``p`` and ``state`` then hold this rank's shards (the
    tables split ``wr``, ``wk``, ``wv``, ``wg`` and ``decay_w2`` by
    columns, ``bonus_u``, ``ln_scale`` and the ``wkv`` state by head,
    ``wo`` by rows; the token-shift mixes and their state are whole).
    Where the rank's columns are whole heads it runs them, with its
    slice of ``decay_base``; where they split a head (the heads do not
    divide the axis: ``bonus_u``, ``ln_scale`` and the state are whole)
    r, k, v, g and the decay are gathered and every rank runs every
    head. Either way the output goes through the rank's rows of ``wo``,
    summed over the ranks. In a train step each mix (and the decay
    LoRA's hidden state) enters the rank's columns through
    ``TensorParallel.copy``, and so does the replicated ``decay_base``
    its heads' slice."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    dt, f32 = x.dtype, torch.float32
    prev = state["shift_tm"] if state is not None else None
    xw, xk, xv, xr, xg = _ddlerp(p, x, _shift_delta(x, prev, mode))

    def col(a, name):
        # a mix, alike on every rank, into the rank's columns of a split
        # weight
        w = p[name]
        return (model_copy(tp, a) if split_cols(tp, w, d) else a) @ w.to(dt)
    r = col(xr, "wr")
    k = col(xk, "wk")
    v = col(xv, "wv")
    g = col(xg, "wg")
    dw = col(torch.tanh(xw @ p["decay_w1"].to(dt)), "decay_w2")
    n = r.shape[-1]
    if n % hd:                          # a head split: every head whole,
        # run alike on every rank
        r, k, v, g, dw = gather_cols(tp, (r, k, v, g, dw), (d,) * 5)
        n = d
    # this rank's channels [lo, lo + n) and heads [h0, h0 + hl)
    lo = 0 if n == d else tp.rank * n
    h0, hl = lo // hd, n // hd
    g = F.silu(g)
    base = p["decay_base"] if n == d else model_copy(tp, p["decay_base"])
    decay = base.to(f32)[lo:lo + n] + dw.to(f32)
    w = torch.exp(-torch.exp(decay)).reshape(b, s, hl, hd)
    r, k, v = (t.reshape(b, s, hl, hd) for t in (r, k, v))

    def mine(t):                        # (H, hd) → the rank's heads
        return t[h0:h0 + hl] if t.shape[0] > hl else t
    init = (state["wkv"] if state is not None
            else torch.zeros((b, hl, hd, hd), dtype=f32, device=x.device))
    u = mine(p["bonus_u"]).to(f32)
    if mode == "decode":
        final, y = _wkv_step(init, r[:, 0].to(f32), k[:, 0].to(f32),
                             v[:, 0].to(f32), w[:, 0].to(f32), u)
        y = y[:, None]                                    # (B,1,H,K)
    else:
        y, final = _wkv_scan(r, k, v, w, u, init)

    y = _group_norm(y, mine(p["ln_scale"]).to(f32), 64e-5)
    y = y.reshape(b, s, n).to(dt) * g
    out = row_parallel(tp, y, p["wo"].to(dt), d)
    return out, {"wkv": final, "shift_tm": x[:, -1].to(f32)}


def rwkv6_channel_mix(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, state: Optional[dict], mode: str,
                      tp=None):
    """The channel mix of x (B, S, d) → ((B, S, d), its new state leaf).

    ``tp``: as ``rwkv6_time_mix``'s. The reference's first-match table
    gives ``cm_wv`` and ``cm_wr`` the rule of ``wv`` and ``wr`` (split
    by columns), so a rank holds its columns of ``k`` (``cm_wk`` by
    columns) but needs all of ``k`` for its output columns: ``k`` is
    gathered, then the rank's output columns are."""
    dt = x.dtype
    d = cfg.d_model
    prev = state["shift_cm"] if state is not None else None
    sx = _shift_delta(x, prev, mode)
    xk = x + sx * p["cm_mu_k"].to(dt)
    xr = x + sx * p["cm_mu_r"].to(dt)
    split_k = split_cols(tp, p["cm_wk"], cfg.d_ff)
    split_v = split_cols(tp, p["cm_wv"], d)
    k = torch.square(F.relu((model_copy(tp, xk) if split_k else xk)
                            @ p["cm_wk"].to(dt)))
    if split_k:
        # consumed by the rank's output columns of cm_wv where those are
        # split (a reduce-scatter backward), else alike
        k = tp.gather_model(k, scatter=split_v)
    elif split_v:
        k = model_copy(tp, k)
    xr = model_copy(tp, xr) if split_cols(tp, p["cm_wr"], d) else xr
    out = torch.sigmoid(xr @ p["cm_wr"].to(dt)) * (k @ p["cm_wv"].to(dt))
    if out.shape[-1] < d:
        # the residual takes it alike on every rank
        out = tp.gather_model(out)
    return out, {"shift_cm": x[:, -1].to(torch.float32)}
