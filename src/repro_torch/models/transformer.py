"""The decoder stack of the dense and VLM families — GQA or MLA blocks, with
a KV cache — one ``nn.Module`` per layer where the reference scans stacked
layers.

A model holds ``embed`` (vocab, d), ``pos_embed`` (max_seq_len, d) for
learned positions, ``final_norm``, ``blocks`` and, unless the embeddings
are tied, ``lm_head`` (d, vocab); every leaf keeps the reference's name,
so ``core.convert`` maps a reference parameter tree onto it one to one.
The MEM towers are built without a head (``head=False``) and read only
``hidden``.

``apply`` modes: "train" (full logits), "prefill" (fills the cache,
returns last-position logits only), "decode" (one token against the
cache). The cache keeps the reference's layout: ``pos`` (B,), for M-RoPE
``mrope_delta`` (B,), and ``dense`` — the layers' cache leaves stacked on
a leading layer axis, the batch on axis 1. Layers write their slices of
the stacked leaves in place.

Norms are RMSNorm, the dense families' norm. MoE, the hybrid, RWKV and
audio families come with later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, mlp_apply,
                                       mlp_init, rms_norm)
from repro_torch.util import resolve_device

Cache = Optional[Dict[str, Any]]


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
    """Pre-norm attention block: ``ln1``, ``attn`` (GQA or MLA), ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dtype, dev = _dtype(cfg.param_dtype), gen.device
        self.ln1 = _params(_norm_init(cfg.d_model, dtype, dev))
        self.ln2 = _params(_norm_init(cfg.d_model, dtype, dev))
        init = attn.mla_init if cfg.attn_type == "mla" else attn.gqa_init
        self.attn = _params(init(gen, cfg, dtype))
        self.mlp = _params(mlp_init(gen, cfg.d_model, cfg.d_ff,
                                    gated=cfg.gated_mlp, dtype=dtype))

    def step(self, x: torch.Tensor, *, positions: torch.Tensor,
             mrope_positions: Optional[torch.Tensor] = None,
             cache: Optional[dict] = None,
             cache_pos: Optional[torch.Tensor] = None, mode: str = "train",
             kv_lengths: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[dict]]:
        cfg = self.cfg
        h = _norm(cfg, self.ln1, x)
        if cfg.attn_type == "mla":
            a, cache = attn.mla_attention(
                self.attn, cfg, h, positions=positions, cache=cache,
                cache_pos=cache_pos, mode=mode, kv_lengths=kv_lengths)
        else:
            a, cache = attn.gqa_attention(
                self.attn, cfg, h, positions=positions,
                mrope_positions=mrope_positions, cache=cache,
                cache_pos=cache_pos, mode=mode, kv_lengths=kv_lengths)
        x = x + a
        h = _norm(cfg, self.ln2, x)
        return x + mlp_apply(self.mlp, h, cfg.activation), cache

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return self.step(x, positions=positions)[0]


class Transformer(nn.Module):
    """A dense or VLM decoder. ``gen`` draws the initial weights (on its
    device) with the reference's scales; ``head=False`` leaves out the LM
    head (the MEM towers)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 head: bool = True):
        super().__init__()
        if cfg.family not in ("dense", "vlm") or cfg.attn_type not in (
                "gqa", "mla"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} / attention "
                f"{cfg.attn_type!r} belong to later slices of the port "
                f"(ROADMAP.md)")
        self.cfg = cfg
        self.adtype = _dtype(cfg.dtype)
        dtype, dev = _dtype(cfg.param_dtype), gen.device
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, dtype),
                                  requires_grad=False)
        if cfg.pos_type == "learned":
            self.pos_embed = nn.Parameter(
                embed_init(gen, cfg.max_seq_len, cfg.d_model, dtype),
                requires_grad=False)
        else:
            self.pos_embed = None
        self.final_norm = _params(_norm_init(cfg.d_model, dtype, dev))
        if head and not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype),
                requires_grad=False)
        else:
            self.lm_head = None
        self.blocks = nn.ModuleList(AttnBlock(cfg, gen)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The block stack over already-embedded x (B, S, d), positions
        0..S-1, in "train" mode (the reference's ``_apply_decoder``
        without a cache)."""
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[0], -1)
        for block in self.blocks:
            x = block(x, positions)
        return x

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, Any]:
        cfg = self.cfg
        device = self.device if device is None else device
        cache: Dict[str, Any] = {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
        if cfg.pos_type == "mrope":
            cache["mrope_delta"] = torch.zeros((batch,), dtype=torch.int32,
                                               device=device)
        mk = (attn.mla_cache_init if cfg.attn_type == "mla"
              else attn.gqa_cache_init)
        one = mk(cfg, batch, max_len, dtype, device="meta")
        cache["dense"] = {k: torch.zeros((cfg.num_layers,) + v.shape,
                                         dtype=dtype, device=device)
                          for k, v in one.items()}
        return cache

    @staticmethod
    def insert_slot(cache: Dict[str, Any], one: Dict[str, Any],
                    slot: int) -> None:
        """Copy a batch-1 cache ``one`` into batch row ``slot`` of
        ``cache`` in place: ``pos`` and ``mrope_delta`` have the batch on
        axis 0, the stacked ``dense`` leaves on axis 1."""
        for k, v in cache.items():
            if k == "dense":
                for n, buf in v.items():
                    buf.narrow(1, slot, 1).copy_(one["dense"][n])
            else:
                v.narrow(0, slot, 1).copy_(one[k])

    # ----------------------------------------------------------------- apply
    @torch.no_grad()
    def apply(self, tokens: torch.Tensor, *,
              vision_embeds: Optional[torch.Tensor] = None,
              cache: Cache = None, mode: str = "train",
              prompt_lengths: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """tokens: (B, S_text) int. Returns (logits, new_cache, aux).

        prompt_lengths (B,): true prompt lengths (vision tokens included)
        for right-padded prefill — pad keys are masked, last-token logits
        and cache positions use the true length."""
        cfg = self.cfg
        dev = self.device
        tokens = tokens.to(dev)
        if prompt_lengths is not None:
            prompt_lengths = prompt_lengths.to(dev)
        cache_pos = cache["pos"] if cache is not None else None
        kv_lengths = prompt_lengths if mode == "prefill" else None
        cached_delta = (cache.get("mrope_delta") if cache is not None
                        else None)
        if vision_embeds is not None:
            vision_embeds = vision_embeds.to(dev)

        x, positions, mrope_positions, delta = self._embed(
            tokens, vision_embeds, cache_pos, cached_delta, mode)
        x = x.to(self.adtype)
        s_total = x.shape[1]                    # vision tokens included
        for i, block in enumerate(self.blocks):
            layer = (None if cache is None
                     else {k: v[i] for k, v in cache["dense"].items()})
            x, _ = block.step(x, positions=positions,
                              mrope_positions=mrope_positions, cache=layer,
                              cache_pos=cache_pos, mode=mode,
                              kv_lengths=kv_lengths)

        x = _norm(cfg, self.final_norm, x)
        if mode == "prefill":
            if prompt_lengths is not None:
                idx = (prompt_lengths - 1).to(torch.long)
                x = x[torch.arange(x.shape[0], device=dev), idx][:, None]
            else:
                x = x[:, -1:]
        head = self.embed.t() if self.lm_head is None else self.lm_head
        logits = x @ head.to(x.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if cache is None:
            return logits, None, aux
        b = tokens.shape[0]
        new_cache = dict(cache)
        if mode == "decode":
            new_cache["pos"] = cache_pos + 1
        elif prompt_lengths is not None:
            new_cache["pos"] = prompt_lengths.to(torch.int32)
        else:
            new_cache["pos"] = torch.full((b,), s_total, dtype=torch.int32,
                                          device=dev)
        if cfg.pos_type == "mrope":
            new_cache["mrope_delta"] = (
                cached_delta if mode == "decode"
                else torch.full((b,), delta, dtype=torch.int32, device=dev))
        return logits, new_cache, aux

    # ------------------------------------------------------------- internals
    def _embed(self, tokens, vision_embeds, cache_pos, cached_delta, mode):
        cfg = self.cfg
        b = tokens.shape[0]
        x = self.embed.to(self.adtype)[tokens.long()]
        if vision_embeds is not None and mode != "decode":
            x = torch.cat([vision_embeds.to(self.adtype), x], dim=1)
        s = x.shape[1]
        if mode == "decode":
            positions = cache_pos[:, None]                    # (B, 1)
        else:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        mrope_positions, delta = None, 0
        if cfg.pos_type == "mrope":
            mrope_positions, delta = self._mrope_positions(
                b, s, vision_embeds, cache_pos, cached_delta, mode,
                x.device)
        if cfg.pos_type == "learned":
            x = x + self.pos_embed.to(self.adtype)[positions]
        return x, positions, mrope_positions, delta

    def _mrope_positions(self, b, s, vision_embeds, cache_pos, cached_delta,
                         mode, dev):
        """((3, B, S) position ids, rope delta). The delta (g − n_vision)
        maps absolute cache positions back onto the M-RoPE text axis at
        decode time (Qwen2-VL's rope_delta)."""
        nv = (vision_embeds.shape[1]
              if vision_embeds is not None and mode != "decode" else 0)
        if nv:
            g = math.isqrt(nv)
            assert g * g == nv, "vision_tokens must be a square grid"
            vi = torch.arange(nv, device=dev)
            ti = torch.arange(s - nv, device=dev) + g
            pos3 = torch.stack([
                torch.cat([torch.zeros_like(vi), ti]),
                torch.cat([vi // g, ti]),
                torch.cat([vi % g, ti])])                      # (3, S)
            return pos3[:, None].expand(3, b, s), g - nv
        if mode == "decode":
            # text continuation on the shifted M-RoPE text axis
            p = cache_pos + cached_delta                          # (B,)
            return p[None, :, None].expand(3, b, s), 0
        pos3 = torch.arange(s, device=dev)[None].expand(3, s)
        return pos3[:, None].expand(3, b, s), 0


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """A ``Transformer`` with random weights from ``seed`` on ``device``
    (the reference's scales; not the reference's numbers — load those with
    ``core.convert.model_params_from_numpy``)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return Transformer(cfg, gen)
