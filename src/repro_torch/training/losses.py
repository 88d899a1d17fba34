"""Loss functions: LM cross-entropy (+ z-loss) and SigLIP contrastive,
the reference's (``repro.training.losses``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     z_loss: float = 1e-4) -> Tuple[torch.Tensor, dict]:
    """logits (B, S, V); labels (B, S) int. Masked mean token NLL plus
    ``z_loss`` · the masked mean of logsumexp², in f32; metrics ``nll``
    and ``accuracy`` (argmax ties to the first index, as ``jnp.argmax``).

    The reference picks the gold logit with an f32 one-hot contraction
    (the form that keeps a vocab-sharded TPU layout local). On one card
    that is a (B, S, V) f32 tensor — 210 MB at V = 102,400 and
    B·S = 512 — for one number a token; a gather gives the same value bit
    for bit, since the contraction adds exact zeros to it."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)                             # (B,S)
    gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    m = (torch.ones_like(nll) if mask is None
         else mask.to(device=nll.device, dtype=torch.float32))
    denom = torch.clamp(m.sum(), min=1.0)
    loss = (nll * m).sum() / denom
    total = loss + z_loss * (torch.square(lse) * m).sum() / denom
    hit = (lg.argmax(-1) == labels.long()).to(torch.float32)
    acc = (hit * m).sum() / denom
    return total, {"nll": loss, "accuracy": acc}


def siglip_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """SigLIP pairwise sigmoid loss over the (B, B) similarities of
    L2-normalised embeddings, matching pairs on the diagonal; metric
    ``contrastive_acc`` (each image's best text is its own)."""
    b = img_emb.shape[0]
    f32 = torch.float32
    logits = (img_emb.to(f32) @ txt_emb.to(f32).t()) * torch.exp(
        logit_scale) + logit_bias
    labels = 2.0 * torch.eye(b, dtype=f32, device=logits.device) - 1.0
    loss = -F.logsigmoid(labels * logits).mean()
    hit = logits.argmax(-1) == torch.arange(b, device=logits.device)
    return loss, {"contrastive_acc": hit.to(f32).mean()}
