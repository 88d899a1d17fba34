"""The VLM's language decoder, plain: the request's vision tokens (a
square grid of ``g``² rows) ahead of its text tokens, a pre-norm GQA
decoder with Qwen2-VL's multimodal rotary positions (vision row i at
(0, i // g, i % g), text token j at g + j on all three axes), a gated
SiLU MLP, RMSNorm, an untied head. Run layer by layer over a batch of
whole sequences, each layer's weights made once, so a 7B model fits
beside its activations in float32."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

from perfbench.reference.layers import (F32, Precision, attention_block,
                                        mlp_block, mrope_angles, rms_norm)


def mrope_positions(n_vision: int, n_text: int, device) -> torch.Tensor:
    g = math.isqrt(n_vision)
    if g * g != n_vision:
        raise ValueError(f"{n_vision} vision tokens are not a square grid")
    vi = torch.arange(n_vision, device=device)
    ti = torch.arange(n_text, device=device) + g
    return torch.stack([torch.cat([torch.zeros_like(vi), ti]),
                        torch.cat([vi // g, ti]),
                        torch.cat([vi % g, ti])])


class DecoderReference:
    """``get(group)`` gives a group of ``perfbench.weights`` in f32."""

    def __init__(self, cfg: dict,
                 get: Callable[[str], Dict[str, torch.Tensor]],
                 device):
        self.m = cfg
        self.get = get
        self.device = torch.device(device)

    @torch.no_grad()
    def logits(self, seqs: Sequence[dict], precs: Sequence[Precision] = (F32,)
               ) -> List[List[torch.Tensor]]:
        """Each of ``seqs`` is ``{"vision": (n_vision, d) f32, "tokens":
        (n,) ints, "at": positions among the text tokens}``: the logits
        (len(at), vocab) f32 that the sequence's prefix up to each text
        position ``at[k]`` gives for the next token, once for each of
        ``precs`` (one pass over the layers serves them all)."""
        m, dev = self.m, self.device
        hd = m["head_dim"]
        eps = m["rms_norm_eps"]
        emb = self.get("embed")["embed"]
        hs, angles = [], []
        for s in seqs:
            tok = torch.as_tensor(s["tokens"], device=dev).long()
            nv = s["vision"].shape[0]
            x = torch.cat([s["vision"].to(dev, torch.float32), emb[tok]])
            hs.append([x.clone() for _ in precs])
            angles.append(mrope_angles(mrope_positions(nv, len(tok), dev), hd,
                                       m["rope_theta"], m["mrope_section"]))
        del emb
        for i in range(m["num_hidden_layers"]):
            w = self.get(f"block{i}")
            pre = f"blocks.{i}."
            for j, per in enumerate(hs):
                for p, prec in enumerate(precs):
                    x = attention_block(
                        per[p], w, pre, heads=m["num_attention_heads"],
                        kv_heads=m["num_key_value_heads"], head_dim=hd,
                        eps=eps, angles=angles[j], prec=prec)
                    per[p] = mlp_block(x, w, pre, eps=eps, activation="silu",
                                       prec=prec)
            del w
        head = self.get("head")
        out = []
        for s, per in zip(seqs, hs):
            rows = s["vision"].shape[0] + torch.as_tensor(s["at"], device=dev)
            out.append([precs[p].linear(
                rms_norm(per[p][rows], head["final_norm.w"], eps),
                head["lm_head"]) for p in range(len(precs))])
        return out
