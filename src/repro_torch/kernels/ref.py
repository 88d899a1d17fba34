"""Plain PyTorch versions of the kernels on the port's path.

Each function is the correctness reference of one hand-written kernel
(``similarity.py``: fused retrieval and the dense scan;
``scene_score.py``: scene score; ``decode_attention.py``: GQA and MLA
decode) and the path a CPU tensor takes through ``kernels.ops``. They may
materialise what the kernels keep on chip; what they return is exactly
the kernels' contract.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.draws import raw_counts

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# validity
# ---------------------------------------------------------------------------


def as_valid_mask(valid: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical form of a stacked scan's ``valid`` argument:

    * (S, N) bool mask — passes through;
    * (S,) int sizes — valid prefix ``[0, size)``;
    * (S, 2) int ``[start, size]`` ring windows — valid rows are
      ``[start, start+size) mod N``.
    """
    dev = valid.device
    if valid.dim() == 1:
        return torch.arange(n, device=dev)[None, :] < valid[:, None]
    if (valid.dim() == 2 and valid.shape[-1] == 2
            and not valid.dtype.is_floating_point
            and valid.dtype != torch.bool):
        j = torch.arange(n, device=dev)[None, :]
        # torch.remainder takes the sign of the divisor, like jnp.mod
        return torch.remainder(j - valid[:, :1], n) < valid[:, 1:2]
    return valid


# ---------------------------------------------------------------------------
# decode attention: one query token against a KV cache
# ---------------------------------------------------------------------------


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, *, scale: float,
                         softcap: float = 0.0, q_per_kv: int = 1
                         ) -> torch.Tensor:
    """GQA decode: q (B,1,H,D); k/v (B,C,Hkv,D); valid (B or 1, C) bool →
    (B,1,H,D) in q's dtype. f32 logits (tanh-capped when ``softcap`` > 0)
    masked with -1e30, a softmax, the value product in f32; an
    all-invalid row gives the mean of v."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, hkv, q_per_kv, d).to(f32)            # (B,Hkv,G,D)
    kt = k.to(f32).permute(0, 2, 3, 1)                     # (B,Hkv,D,C)
    logits = torch.matmul(qg, kt) * scale                  # (B,Hkv,G,C)
    if softcap and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = valid.expand(b, valid.shape[-1])
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(probs, v.to(f32).permute(0, 2, 1, 3))  # (B,Hkv,G,D)
    return ctx.reshape(b, 1, h, v.shape[-1]).to(q.dtype)


def mla_decode_attention_ref(q_abs: torch.Tensor, q_rope: torch.Tensor,
                             ckv: torch.Tensor, krope: torch.Tensor,
                             valid: torch.Tensor, *, scale: float
                             ) -> torch.Tensor:
    """MLA decode in the matrix-absorbed latent form: q_abs (B,1,H,R),
    q_rope (B,1,H,Dr), ckv (B,C,R), krope (B,C,Dr), valid (B or 1, C) →
    the latent context (B,1,H,R) in q_abs's dtype; the values are ckv."""
    b = q_abs.shape[0]
    f32 = torch.float32
    ckv32 = ckv.to(f32)
    logits = (torch.matmul(q_abs[:, 0].to(f32), ckv32.transpose(1, 2))
              + torch.matmul(q_rope[:, 0].to(f32),
                             krope.to(f32).transpose(1, 2))) * scale
    mask = valid.expand(b, valid.shape[-1])
    logits = torch.where(mask[:, None, :], logits, NEG_INF)   # (B,H,C)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, ckv32)[:, None].to(q_abs.dtype)


# ---------------------------------------------------------------------------
# cosine similarity + temperature softmax
# ---------------------------------------------------------------------------


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def similarity_scan_stack_ref(query: torch.Tensor, index: torch.Tensor,
                              valid: torch.Tensor, *, tau: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the dense scan kernel: query (S,Q,d), index
    (S,N,d) f32 or int8, valid in any canonical form → the raw triple
    (sims (S,Q,N), m (S,Q,1), l (S,Q,1)), m and l the max and sum-exp of
    the masked logits (an all-invalid session: m = -1e30, l = N)."""
    valid = as_valid_mask(valid, index.shape[1])
    sims = torch.matmul(_unit_rows(query), _unit_rows(index).transpose(1, 2))
    logits = torch.where(valid[:, None, :], sims / tau,
                         torch.full_like(sims, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    return sims, m, torch.exp(logits - m).sum(-1, keepdim=True)


def similarity_scan_ref(query: torch.Tensor, index: torch.Tensor,
                        valid: torch.Tensor, *, tau: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 2-D raw triple: query (Q,d), index (N,d), valid (N,) bool →
    (sims (Q,N), m (Q,1), l (Q,1))."""
    sims, m, l = similarity_scan_stack_ref(query[None], index[None],
                                           valid[None], tau=tau)
    return sims[0], m[0], l[0]


def scan_probs(sims: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
               valid: torch.Tensor, tau: float) -> torch.Tensor:
    """The dense scan's probability epilogue, on both routes: exp(where(
    valid, s/τ, -1e30) - m) / max(l, 1e-30), ``valid`` a mask
    broadcastable to sims — the softmax of the masked logits, from the
    kernel's m and l. τ is a device tensor so that s/τ is a true
    division, the division the kernels make (a Python scalar becomes a
    reciprocal multiply on the card); ``new_full`` makes it without a
    host-to-device copy."""
    logits = torch.where(valid, sims / sims.new_full((), tau), NEG_INF)
    return torch.exp(logits - m) / torch.clamp(l, min=1e-30)


# ---------------------------------------------------------------------------
# fused retrieval: scan + inverse-CDF draws + running top-k
# ---------------------------------------------------------------------------


class FusedRetrieveResult(NamedTuple):
    """The fused scan's contract — no (S, Q, N) tensor in it. ``counts``
    are raw lane counts #{cdf ≤ t} (the dispatch layer clips them)."""
    counts: torch.Tensor        # (S, Q, T) int32
    drawn_p: torch.Tensor       # (S, Q, T) f32 prob at the crossing lane
    p_last: torch.Tensor        # (S, Q, 1) f32 prob of lane N-1
    topk_v: torch.Tensor        # (S, Q, K) f32 top-k sims (desc)
    topk_i: torch.Tensor        # (S, Q, K) int32 top-k lanes
    m: torch.Tensor             # (S, Q, 1) f32 softmax max logit
    l: torch.Tensor             # (S, Q, 1) f32 softmax sum-exp
    p_max: torch.Tensor         # (S, Q, 1) f32 max probability


def topk_lowest_lane(x: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, value-descending with ties to the LOWEST
    lane (``lax.top_k``'s order). ``torch.topk`` does not promise the tie
    order, a stable descending sort does."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


def fused_retrieve_stack_ref(query: torch.Tensor, index: torch.Tensor,
                             valid: torch.Tensor, targets: torch.Tensor, *,
                             tau: float, n_topk: int) -> FusedRetrieveResult:
    """Plain version of the fused retrieval scan: query (S,Q,d), index
    (S,N,d) f32 or int8, valid in any canonical form, targets (S,Q,T)."""
    n = index.shape[1]
    valid = as_valid_mask(valid, n)
    sims, m, l = similarity_scan_stack_ref(query, index, valid, tau=tau)
    probs = scan_probs(sims, m, l, valid[:, None, :], tau)
    counts = raw_counts(probs, targets)
    clipped = counts.clamp(0, n - 1).to(torch.int64)
    drawn_p = torch.gather(probs, -1, clipped)
    p_last = probs[:, :, n - 1:n]
    neg = torch.full_like(sims, NEG_INF)
    topk_v, topk_i = topk_lowest_lane(
        torch.where(valid[:, None, :], sims, neg), n_topk)
    return FusedRetrieveResult(counts, drawn_p, p_last, topk_v, topk_i, m,
                               l, probs.amax(-1, keepdim=True))


# ---------------------------------------------------------------------------
# scene score (Eq. 1)
# ---------------------------------------------------------------------------


def hsle(frames: torch.Tensor) -> torch.Tensor:
    """frames (..., H, W, 3) in [0,1] → (..., H, W, 4) hue, saturation,
    lightness and edge (L1 gradient of lightness, zero first row and
    column)."""
    rgb = frames.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    light = 0.5 * (mx + mn)
    sat = c / (1.0 - torch.abs(2.0 * light - 1.0) + 1e-6)
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    hue = torch.where(
        mx == r, torch.remainder((g - b) / safe_c, 6.0),
        torch.where(mx == g, (b - r) / safe_c + 2.0,
                    (r - g) / safe_c + 4.0)) / 6.0
    hue = torch.where(c > 0, hue, torch.zeros_like(hue))
    dx = torch.zeros_like(light)
    dx[..., :, 1:] = torch.abs(light[..., :, 1:] - light[..., :, :-1])
    dy = torch.zeros_like(light)
    dy[..., 1:, :] = torch.abs(light[..., 1:, :] - light[..., :-1, :])
    return torch.stack([hue, sat, light, dx + dy], dim=-1)


def scene_score_ref(frames: torch.Tensor, weights: Sequence[float],
                    prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames (T,H,W,3) in [0,1] → φ (T,) per Eq. 1; φ[0] = 0, or with
    ``prev`` (H,W,3), the frame before the clip, φ[0] scores frames[0]
    against it."""
    w = torch.as_tensor(tuple(weights), dtype=torch.float32,
                        device=frames.device)
    feats = hsle(frames)
    before = feats[:-1] if prev is None else torch.cat(
        [hsle(prev)[None], feats[:-1]])
    diffs = torch.abs(feats[1 if prev is None else 0:] - before)
    num = (diffs * w).sum(dim=(1, 2, 3))
    hw = frames.shape[1] * frames.shape[2]
    phi = num / (w.sum() * hw)
    if prev is not None:
        return phi
    return torch.cat([torch.zeros(1, dtype=torch.float32,
                                  device=frames.device), phi])
