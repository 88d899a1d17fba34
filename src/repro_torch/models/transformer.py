"""The dense decoder stack (no MoE, no cross-attention, no cache), one
``nn.Module`` per layer where the reference scans stacked layers.

A tower holds ``embed`` (vocab, d), ``pos_embed`` (max_seq_len, d) for
learned positions, ``final_norm`` and ``blocks``; every leaf keeps the
reference's name, so ``core.convert.mem_params_from_numpy`` maps a
reference parameter tree onto it one to one. The unused LM head is not
carried. Norms are RMSNorm, the dense families' norm. Caches, MoE, the
hybrid/RWKV/audio families (and the audio family's LayerNorm) and M-RoPE
come with later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_init, mlp_apply, mlp_init,
                                       rms_norm)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


def _norm_init(d: int, dtype, device) -> dict:
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p["w"], cfg.norm_eps)


class AttnBlock(nn.Module):
    """Pre-norm attention block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dtype, dev = _dtype(cfg.param_dtype), gen.device
        self.ln1 = _params(_norm_init(cfg.d_model, dtype, dev))
        self.ln2 = _params(_norm_init(cfg.d_model, dtype, dev))
        self.attn = _params(attn.gqa_init(gen, cfg, dtype))
        self.mlp = _params(mlp_init(gen, cfg.d_model, cfg.d_ff,
                                    gated=cfg.gated_mlp, dtype=dtype))

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(cfg, self.ln1, x)
        x = x + attn.gqa_attention(self.attn, cfg, h, positions=positions)
        h = _norm(cfg, self.ln2, x)
        return x + mlp_apply(self.mlp, h, cfg.activation)


class Transformer(nn.Module):
    """A dense decoder tower without its LM head. ``gen`` draws the
    initial weights (on its device) with the reference's scales."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        if cfg.family not in ("dense", "vlm") or cfg.attn_type != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} / attention "
                f"{cfg.attn_type!r} belong to later slices of the port "
                f"(ROADMAP.md)")
        self.cfg = cfg
        self.adtype = _dtype(cfg.dtype)
        dtype = _dtype(cfg.param_dtype)
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, dtype),
                                  requires_grad=False)
        if cfg.pos_type == "learned":
            self.pos_embed = nn.Parameter(
                embed_init(gen, cfg.max_seq_len, cfg.d_model, dtype),
                requires_grad=False)
        else:
            self.pos_embed = None
        self.final_norm = _params(_norm_init(cfg.d_model, dtype, gen.device))
        self.blocks = nn.ModuleList(AttnBlock(cfg, gen)
                                    for _ in range(cfg.num_layers))

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The block stack over already-embedded x (B, S, d), positions
        0..S-1, in "train" mode (the reference's ``_apply_decoder``
        without a cache)."""
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[0], -1)
        for block in self.blocks:
            x = block(x, positions)
        return x
