"""Plain PyTorch versions of the kernels on the port's path.

Each function is the correctness reference of one hand-written kernel
(``similarity.py``: fused retrieval and the dense scan;
``scene_score.py``: scene score; ``decode_attention.py``: GQA and MLA
decode; ``cluster.py``: a partition's incremental clustering) and the path a CPU tensor takes through ``kernels.ops``. They may
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


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, *, scale: float,
                        softcap: float = 0.0, q_per_kv: int = 1):
    """``decode_attention_ref``'s softmax stopped before its division, as
    one part: m (B,H,1) = the max masked logit, l (B,H,1) = sum e^(s - m),
    acc (B,H,1,D) = sum e^(s - m) v, all f32, over the valid rows: a mask
    with no valid row gives the empty part, m = -1e30, l = 0, acc = 0."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, hkv, q_per_kv, d).to(f32)
    logits = torch.matmul(qg, k.to(f32).permute(0, 2, 3, 1)) * scale
    if softcap and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = valid.expand(b, valid.shape[-1])
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)                      # (B,Hkv,G,1)
    p = torch.exp(logits - m) * mask[:, None, None, :]
    acc = torch.matmul(p, v.to(f32).permute(0, 2, 1, 3))   # (B,Hkv,G,D)
    return (m.reshape(b, h, 1), p.sum(-1).reshape(b, h, 1),
            acc.reshape(b, h, 1, v.shape[-1]))


def merge_partials_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The merge of N softmax parts: m, l (B,H,N), acc (B,H,N,D) →
    (B,1,H,D) in ``dtype``: sum acc e^(m - M) / max(sum l e^(m - M),
    1e-30), M = max m."""
    f32 = torch.float32
    m, l, acc = m.to(f32), l.to(f32), acc.to(f32)
    w = torch.exp(m - m.amax(-1, keepdim=True))            # (B,H,N)
    den = torch.clamp((l * w).sum(-1), min=1e-30)          # (B,H)
    out = (acc * w[..., None]).sum(2) / den[..., None]     # (B,H,D)
    return out[:, None].to(dtype)


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


def mla_decode_partials_ref(q_abs: torch.Tensor, q_rope: torch.Tensor,
                            ckv: torch.Tensor, krope: torch.Tensor,
                            valid: torch.Tensor, *, scale: float):
    """``mla_decode_attention_ref``'s softmax stopped before its division,
    as one part: m (B,H,1) = the max masked logit, l (B,H,1) = sum e^(s -
    m), acc (B,H,1,R) = sum e^(s - m) ckv, all f32, over the valid rows: a
    mask with no valid row gives the empty part, m = -1e30, l = 0, acc =
    0."""
    b = q_abs.shape[0]
    f32 = torch.float32
    ckv32 = ckv.to(f32)
    logits = (torch.matmul(q_abs[:, 0].to(f32), ckv32.transpose(1, 2))
              + torch.matmul(q_rope[:, 0].to(f32),
                             krope.to(f32).transpose(1, 2))) * scale
    mask = valid.expand(b, valid.shape[-1])[:, None, :]
    logits = torch.where(mask, logits, NEG_INF)               # (B,H,C)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    return m, p.sum(-1, keepdim=True), torch.matmul(p, ckv32)[:, :, None]


# ---------------------------------------------------------------------------
# cosine similarity + temperature softmax
# ---------------------------------------------------------------------------


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


# elements of the (S, Q, rows, d) product ``_cosines`` holds at once
_COSINE_ELEMS = 1 << 26


def _cosines(qn: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """qn (S,Q,d) × xn (S,N,d) unit rows → (S,Q,N): each score an
    elementwise product summed over d, so its bits depend on its query and
    its row alone (a batched matmul's summation order changes with N and
    Q on the CPU, and a standing query's score must equal an ad-hoc
    scan's over the same rows). Rows in chunks that bound the product."""
    s, q, d = qn.shape
    step = max(1, _COSINE_ELEMS // max(1, s * q * d))
    return torch.cat([(qn[:, :, None, :] * xn[:, None, lo:lo + step, :]
                       ).sum(-1) for lo in range(0, xn.shape[1], step)],
                     dim=-1)


def similarity_scan_stack_ref(query: torch.Tensor, index: torch.Tensor,
                              valid: torch.Tensor, *, tau: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the dense scan kernel: query (S,Q,d), index
    (S,N,d) f32 or int8, valid in any canonical form → the raw triple
    (sims (S,Q,N), m (S,Q,1), l (S,Q,1)), m and l the max and sum-exp of
    the masked logits (an all-invalid session: m = -1e30, l = N)."""
    valid = as_valid_mask(valid, index.shape[1])
    sims = _cosines(_unit_rows(query), _unit_rows(index))
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


# ---------------------------------------------------------------------------
# incremental clustering of one partition
# ---------------------------------------------------------------------------


def cluster_partition_ref(vecs: torch.Tensor, threshold: float,
                          max_clusters: int) -> Tuple[torch.Tensor, ...]:
    """vecs (T, d) f32 → (assignments (T,) int32, n_clusters () int32,
    centroids (K, d), counts (K,), index_frames (K,) int32): the
    reference's ``lax.scan`` as a loop of tensor ops a frame, on the
    vectors' device, with no host synchronisation per frame: the fp32
    distance, first-minimum ``argmin`` ties and the overflow rule."""
    t, d = vecs.shape
    kmax = int(max_clusters)
    dev = vecs.device
    sums = torch.zeros((kmax, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((kmax,), dtype=torch.float32, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.arange(kmax, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    assignments = torch.zeros((t,), dtype=torch.int64, device=dev)
    for i in range(t):
        v = vecs[i]
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        dist = torch.sqrt(((means - v[None]) ** 2).sum(-1) + 1e-12)
        dist = torch.where(lanes < n, dist, inf)
        nearest = torch.argmin(dist)                # first minimum
        near_ok = dist[nearest] <= threshold
        make_new = (~near_ok & (n < kmax)) | (n == 0)
        cid = torch.where(make_new, n, nearest)
        sums.index_add_(0, cid[None], v[None])
        counts.index_add_(0, cid[None], torch.ones(1, device=dev))
        n = n + make_new.to(torch.int64)
        assignments[i] = cid
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    d2 = ((vecs[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)  # (T,K)
    member = assignments[:, None] == lanes[None, :]
    d2 = torch.where(member, d2, inf)
    index_frames = torch.argmin(d2, dim=0).to(torch.int32)
    return (assignments.to(torch.int32), n.to(torch.int32), centroids,
            counts, index_frames)
