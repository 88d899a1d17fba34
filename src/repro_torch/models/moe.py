"""Sparse mixture-of-experts FFN, computing the reference's function
(``repro.models.moe``): GShard routing over fixed chunks of the sequence.

Per chunk of n tokens (``chunk_size``): a router softmax in f32, the
top-k experts of each token (ties to the lowest expert index, as
``jax.lax.top_k``) with their weights divided by the top-k sum, and a
capacity of ``max(ceil(n·k/E·capacity_factor), 1)`` slots an expert in
each batch row. Each (token, slot) pair takes the next free slot of its
expert in flattened (n·k) order — token-major, then slot — and pairs past
capacity are dropped. The kept pairs' expert FFNs
``act(x·W_gate) * (x·W_up) · W_down`` (in ``x.dtype``) are combined by
their weights; shared experts are added to every token. The aux loss is
Switch's ``E · Σ_e (f_e / k) · P_e``, averaged over chunks, times
``router_aux_coef``.

The reference dispatches with one-hot einsums over a (B, n, E, C) tensor,
the TPU's design. Here the same result comes by index: the kept pairs are
sorted by expert and their tokens gathered once; each of the three expert
products is one ``F.grouped_mm`` over the stacked (E, ·, ·) weights, a
group an expert, so only the experts that received a kept token read
their weights; the weighted outputs are summed back per token with
``index_add_`` in f32. The routing, the sort and the group offsets stay
on the device: a layer reads nothing back to the host.

On the model axis (``moe_apply(..., tp=)``, the expert-parallel layer)
the router and x are whole on every rank, so the routing — capacities and
drops included — is decided once, identically everywhere. Each rank runs
the kept pairs of its own experts (the tables split the stacked weights
by their leading E) and its columns of the shared expert through its rows
of ``w_down``; the two partial sums, in f32, take one all-reduce a layer
and one cast. In a train step x and the routing weights enter the rank's
experts through ``TensorParallel.copy``, so the router's gradient is the
sum of every rank's experts' share; the aux loss is on the routing that
every model rank shares.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import model_copy
from repro_torch.models.layers import (activation_fn, dense_init, mlp_apply,
                                       mlp_init)

_MAX_CHUNK = 2048


def chunk_size(s: int) -> int:
    """The largest power of two ≤ min(s, 2048) that divides s."""
    c = 1
    while c * 2 <= min(s, _MAX_CHUNK) and s % (c * 2) == 0:
        c *= 2
    return c


def capacity(n: int, cfg: ModelConfig) -> int:
    """Slots an expert has in each batch row of a chunk of n tokens."""
    mc = cfg.moe
    return max(int(math.ceil(n * mc.experts_per_token / mc.num_experts
                             * mc.capacity_factor)), 1)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
             ) -> dict:
    """``router`` (d, E); ``w_gate``, ``w_up`` (E, d, ff); ``w_down`` (E,
    ff, d), each at the reference's fan-in scale; ``shared``, a gated MLP
    of ``shared_d_ff``, with shared experts."""
    mc = cfg.moe
    d, e, ff = cfg.d_model, mc.num_experts, mc.d_ff

    def expert_w(i, o):
        return (torch.randn((e, i, o), generator=gen, device=gen.device)
                * (1.0 / math.sqrt(i))).to(dtype)

    p = {"router": dense_init(gen, d, e, scale=1.0 / math.sqrt(d),
                              dtype=dtype),
         "w_gate": expert_w(d, ff),
         "w_up": expert_w(d, ff),
         "w_down": expert_w(ff, d)}
    if mc.num_shared_experts:
        p["shared"] = mlp_init(gen, d, mc.shared_d_ff, gated=True,
                               dtype=dtype)
    return p


class Routing(NamedTuple):
    """The routing of x (B, S, d) in chunks of n tokens."""
    top_i: torch.Tensor     # (B, S, k) int64 experts, best first
    top_w: torch.Tensor     # (B, S, k) f32 weights, summing to 1 a token
    keep: torch.Tensor      # (B, S, k) bool: the pair got a slot
    aux: torch.Tensor       # (S // n,) f32 each chunk's aux (unscaled)
    probs: torch.Tensor     # (B, S, E) f32 router probabilities


def route(p: Mapping[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
          n: int) -> Routing:
    """Route x (B, S, d) in chunks of n tokens (n divides S): top-k,
    renormalised weights, slots by the flattened (token, slot) order
    within each batch row of a chunk, drops past capacity."""
    mc = cfg.moe
    b, s, _ = x.shape
    e, k = mc.num_experts, mc.experts_per_token
    nc = s // n
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (B,S,E)
    # a stable descending sort puts ties at the lowest index first
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    # one-hot by comparison: F.one_hot would read the ids back to check
    onehot = (top_i.reshape(b * nc, n * k, 1)
              == torch.arange(e, device=x.device)).to(torch.int32)
    # 0-based position of each pair in its expert's buffer
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    keep = (pos < capacity(n, cfg)).reshape(b, s, k)
    # Switch load balance per chunk: E · Σ_e (f_e / k) · P_e
    frac = onehot.reshape(b, nc, n * k, e).sum(2).sum(0).to(
        torch.float32) / (b * n)                                # (nc, E)
    mean_p = probs.reshape(b, nc, n, e).mean(dim=(0, 2))        # (nc, E)
    aux = e * (frac / k * mean_p).sum(-1)
    return Routing(top_i, top_w, keep, aux, probs)


def _experts(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
             x: torch.Tensor, r: Routing, lo: int = 0) -> torch.Tensor:
    """The kept pairs' expert FFNs, combined by their weights → (B, S, d)
    in f32. The pairs are sorted by expert and each expert's rows are one
    group of a grouped product, so an expert no kept pair reached reads no
    weight; nothing is read back to the host. ``p``'s stacked weights may
    hold experts [lo, lo + their E) alone (a rank's on the model axis):
    only the pairs routed to those count, and with none every group is
    empty."""
    mc = cfg.moe
    b, s, d = x.shape
    e, k = p["w_gate"].shape[0], mc.experts_per_token
    dt = x.dtype
    act = activation_fn(cfg.activation)
    # dropped pairs, and the pairs of other ranks' experts, sort after the
    # last expert, outside every group
    local = r.top_i - lo
    eid = torch.where(r.keep & (local >= 0) & (local < e), local,
                      e).reshape(-1)
    order = torch.argsort(eid, stable=True)
    counts = torch.zeros(e + 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, eid, torch.ones_like(eid))
    offs = torch.cumsum(counts[:e], 0).to(torch.int32)
    tok = torch.div(order, k, rounding_mode="floor")
    # the rows past the last group (the dropped pairs) belong to no
    # group: the products leave them unwritten, forward and backward (in
    # a's gradient). A ``where`` on each side selects them away — in the
    # backward pass too, where a product by 0 would keep a NaN.
    kept = (eid[order] < e)[:, None]
    xs = torch.where(kept, x.reshape(b * s, d)[tok], 0.0)

    def gmm(a, w):
        return F.grouped_mm(a, w.to(dt), offs=offs)
    ys = gmm(act(gmm(xs, p["w_gate"])) * gmm(xs, p["w_up"]), p["w_down"])
    w = r.top_w.reshape(-1)[order].to(dt).to(torch.float32)
    ys = torch.where(kept, ys.to(torch.float32), 0.0) * w[:, None]
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, ys)
    return y.reshape(b, s, d)


def moe_apply(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), aux loss ()). ``tp``: the model's
    ``TensorParallel`` where ``p`` holds this rank's shards (the experts
    by E, the shared expert by its hidden columns): the ranks' partial
    sums, each in f32, are summed by one all-reduce and cast once."""
    mc = cfg.moe
    dt = x.dtype
    r = route(p, cfg, x, chunk_size(x.shape[1]))
    e_loc = p["w_gate"].shape[0]
    split = tp is not None and e_loc < mc.num_experts
    sh_split = (mc.num_shared_experts > 0 and tp is not None
                and p["shared"]["w_down"].shape[0] < mc.shared_d_ff)
    # x, alike on every rank, enters the rank's experts and shared columns
    xr = model_copy(tp, x) if split or sh_split else x
    if split:
        r = r._replace(top_w=model_copy(tp, r.top_w))
    y = _experts(p, cfg, xr if split else x, r,
                 tp.rank * e_loc if split else 0)
    shared = (mlp_apply(p["shared"], xr if sh_split else x, cfg.activation)
              if mc.num_shared_experts else None)
    aux = r.aux.mean() * mc.router_aux_coef
    if not (split or sh_split):
        y = y.to(dt)
        return (y if shared is None else y + shared), aux
    # the ranks' partial sums in f32: one all-reduce a layer, one cast
    total = tp.all_reduce((y if split else 0)
                          + (shared.to(torch.float32) if sh_split else 0))
    if not split:
        total = total + y
    if shared is not None and not sh_split:
        total = total + shared.to(torch.float32)
    return total.to(dt), aux
