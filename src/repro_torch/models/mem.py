"""Venus MEM — dual-encoder multimodal embedding model (BGE-VL class).

The text tower encodes token sequences; the vision tower encodes
precomputed patch embeddings (the frontend is a stub). Both are pooled,
projected into the shared space and L2-normalised, so the cosine between
a text query and an indexed frame is Eq. 4 of the paper.

The reference's quirks are kept, since parity depends on them: both
towers run their stack in "train" mode, so attention is causal in both;
the text mask is used only in pooling; the vision tower adds its learned
``pos_embed`` here, not in an embedding layer; ``_l2norm`` computes in
f32 and casts back to the activation dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.venus_mem import MEMConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.transformer import Transformer, _norm
from repro_torch.util import resolve_device


def _pool(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return h.mean(1)
    m = mask.to(h.dtype)[..., None]
    return (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return (x32 * torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-12)
            ).to(x.dtype)


class MEM(nn.Module):
    """``text`` and ``vision`` towers, ``text_proj`` / ``vision_proj``
    projections and the SigLIP ``logit_scale`` / ``logit_bias``."""

    def __init__(self, cfg: MEMConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.text = Transformer(cfg.text, gen, head=False)
        self.vision = Transformer(cfg.vision, gen, head=False)
        d = cfg.embed_dim
        self.text_proj = nn.Parameter(dense_init(gen, cfg.text.d_model, d),
                                      requires_grad=False)
        self.vision_proj = nn.Parameter(
            dense_init(gen, cfg.vision.d_model, d), requires_grad=False)
        self.register_buffer("logit_scale", torch.tensor(
            2.0, device=gen.device))
        self.register_buffer("logit_bias", torch.tensor(
            -10.0, device=gen.device))

    @classmethod
    def init(cls, cfg: MEMConfig, seed: int = 0, device=None) -> "MEM":
        """Random weights from ``seed`` on ``device`` (the reference's
        scales; not the reference's numbers — load those with
        ``core.convert.mem_params_from_numpy``)."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return cls(cfg, gen)

    @property
    def device(self) -> torch.device:
        return self.text_proj.device

    def _trunk(self, tower: Transformer, x: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The tower body without an LM head over already-embedded x."""
        h = _norm(tower.cfg, tower.final_norm, tower.hidden(x))
        return _pool(h, mask)

    def encode_text(self, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, L) int → (B, embed_dim) unit rows in the activation
        dtype; ``mask`` (B, L) marks real tokens (pooling only)."""
        tower = self.text
        x = tower.embed.to(tower.adtype)[tokens.long()]
        pooled = self._trunk(tower, x, mask)
        return _l2norm(pooled @ self.text_proj.to(pooled.dtype))

    def encode_image(self, patch_embeds: torch.Tensor) -> torch.Tensor:
        """patch_embeds (B, P, d_vision) → (B, embed_dim) unit rows."""
        tower = self.vision
        x = patch_embeds.to(tower.adtype)
        if tower.pos_embed is not None:
            x = x + tower.pos_embed.to(tower.adtype)[None, : x.shape[1]]
        pooled = self._trunk(tower, x, None)
        return _l2norm(pooled @ self.vision_proj.to(pooled.dtype))
