"""The MEM dual encoder, plain: a text tower over word-hash tokens and a
vision tower over patch embeddings, each a pre-norm decoder stack run
causally (both towers, as the port runs them), mean-pooled (the text
over its real tokens), projected and L2-normalised. The vision tower adds
learned positions; the text tower rotates q and k. The frontend is the
fixed patch projection ``patch_projection`` (NumPy ``default_rng(11)``
normals of scale 1/sqrt(patch²·3))."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from perfbench.reference import text as text_mod
from perfbench.reference.layers import (F32, Precision, attention_block,
                                        mlp_block, rms_norm, rope_angles)


def patch_projection(patch: int, d: int, seed: int = 11) -> np.ndarray:
    k = patch * patch * 3
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0 / np.sqrt(k), (k, d)).astype(np.float32)


def patchify(frames: torch.Tensor, patch: int, proj: torch.Tensor
             ) -> torch.Tensor:
    """frames (B, H, W, 3) → (B, P, d): row-major patches, each patch's
    pixels in (y, x, c) order, times ``proj``."""
    b, h, w, c = frames.shape
    ph, pw = h // patch, w // patch
    x = frames[:, :ph * patch, :pw * patch].reshape(b, ph, patch, pw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, ph * pw, patch * patch * c)
    return x.to(proj.dtype) @ proj


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class MEMReference:
    """``get(group)`` gives a group of ``perfbench.weights`` in f32."""

    def __init__(self, cfg: dict,
                 get: Callable[[str], Dict[str, torch.Tensor]],
                 device, prec: Precision = F32):
        self.cfg = cfg
        self.get = get
        self.device = torch.device(device)
        self.prec = prec
        v = cfg["vision_config"]
        self.proj = torch.from_numpy(patch_projection(
            v["patch_size"], v["hidden_size"])).to(self.device)

    def _tower(self, x: torch.Tensor, name: str, tc: dict, angles
               ) -> torch.Tensor:
        eps = self.cfg["rms_norm_eps"]
        d, heads = tc["hidden_size"], tc["num_attention_heads"]
        for i in range(tc["num_hidden_layers"]):
            w = self.get(f"{name}.block{i}")
            pre = f"{name}.blocks.{i}."
            x = attention_block(x, w, pre, heads=heads, kv_heads=heads,
                                head_dim=d // heads, eps=eps, angles=angles,
                                prec=self.prec)
            x = mlp_block(x, w, pre, eps=eps, activation="gelu",
                          prec=self.prec)
        return rms_norm(x, self.get(f"{name}.head")[f"{name}.final_norm.w"],
                        eps)

    @torch.no_grad()
    def encode_frames(self, frames: torch.Tensor, batch: int = 32
                      ) -> torch.Tensor:
        """frames (B, H, W, 3) in [0, 1] → (B, embed) unit rows."""
        v = self.cfg["vision_config"]
        pos = self.get("vision.pos_embed")["vision.pos_embed"]
        w_out = self.get("proj")["vision_proj"]
        out = []
        for i in range(0, frames.shape[0], batch):
            x = patchify(frames[i:i + batch].to(torch.float32),
                         v["patch_size"], self.proj)
            x = x + pos[None, :x.shape[1]]
            h = self._tower(x, "vision", v, None).mean(1)
            out.append(l2norm(self.prec.linear(h, w_out)))
        return torch.cat(out)

    @torch.no_grad()
    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """texts → (B, embed) unit rows."""
        t = self.cfg["text_config"]
        toks, mask = text_mod.tokenize_batch(list(texts), t["vocab_size"],
                                             t["text_max_len"])
        toks = torch.from_numpy(toks).to(self.device)
        m = torch.from_numpy(mask).to(self.device, torch.float32)[..., None]
        x = self.get("text.embed")["text.embed"][toks]
        ang = rope_angles(torch.arange(toks.shape[1], device=self.device),
                          t["hidden_size"] // t["num_attention_heads"],
                          self.cfg["rope_theta"])
        h = self._tower(x, "text", t, ang)
        pooled = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
        return l2norm(self.prec.linear(pooled, self.get("proj")["text_proj"]))
