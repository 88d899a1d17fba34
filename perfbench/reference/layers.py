"""Plain layers: RMSNorm, the products of a linear layer, causal GQA
attention with rotary positions, the MLPs. Float32 throughout with TF32
off. ``Precision("fp8")`` is the control: every linear layer's weight and
input rounded to float8 e4m3 (per-tensor scale, as fp8 inference does)
before an f32 product; ``Precision("bf16")`` rounds them to bfloat16."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F8_MAX = 448.0


class Precision:
    """How the operands of a linear layer are rounded: ``"f32"`` (not
    at all), ``"bf16"`` or ``"fp8"``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        if self.name == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        scale = x.abs().amax().clamp(min=1e-12) / F8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.round(x) @ self.round(w)


F32 = Precision("f32")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated in halves by angles (S, D/2)."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                        device=device) / half)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """positions (S,) → angles (S, D/2)."""
    f = freqs(head_dim, theta, positions.device)
    return (positions.to(torch.float64)[:, None] * f).to(torch.float32)


def mrope_angles(pos3: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL's multimodal rotary angles: pos3 (3, S) temporal, height
    and width ids; frequency slot j takes the id of its section."""
    f = freqs(head_dim, theta, pos3.device)
    sec = torch.repeat_interleave(torch.arange(3, device=pos3.device),
                                  torch.tensor(list(sections),
                                               device=pos3.device))
    pos = pos3.to(torch.float64)[sec]                 # (D/2, S)
    return (pos.t() * f).to(torch.float32)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q (..., S, H, D), k and v (..., S, Hkv, D) → (..., S, H·D); query
    head h reads kv head h // (H / Hkv)."""
    s, h, d = q.shape[-3:]
    rep = h // k.shape[-2]
    k = k.repeat_interleave(rep, dim=-2)
    v = v.repeat_interleave(rep, dim=-2)
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(d)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    ctx = torch.einsum("...hqk,...khd->...qhd", torch.softmax(logits, -1), v)
    return ctx.reshape(*q.shape[:-2], h * d)


def attention_block(x: torch.Tensor, w: dict, pre: str, *, heads: int,
                    kv_heads: int, head_dim: int, eps: float,
                    angles: Optional[torch.Tensor], prec: Precision
                    ) -> torch.Tensor:
    """x + attention(norm(x)) over sequences x (..., S, d)."""
    lead = x.shape[:-1]
    h = rms_norm(x, w[pre + "ln1.w"], eps)
    q = prec.linear(h, w[pre + "attn.wq"]).reshape(*lead, heads, head_dim)
    k = prec.linear(h, w[pre + "attn.wk"]).reshape(*lead, kv_heads, head_dim)
    v = prec.linear(h, w[pre + "attn.wv"]).reshape(*lead, kv_heads, head_dim)
    if angles is not None:
        q, k = rotate(q, angles), rotate(k, angles)
    return x + prec.linear(causal_attention(q, k, v), w[pre + "attn.wo"])


def mlp_block(x: torch.Tensor, w: dict, pre: str, *, eps: float,
              activation: str, prec: Precision) -> torch.Tensor:
    """x + MLP(norm(x)): gated when the block has ``w_gate``."""
    h = rms_norm(x, w[pre + "ln2.w"], eps)
    up = prec.linear(h, w[pre + "mlp.w_up"])
    if activation == "silu":
        act = F.silu
    elif activation == "gelu":
        act = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    else:
        raise ValueError(f"unknown activation {activation!r}")
    gate = w.get(pre + "mlp.w_gate")
    hid = act(prec.linear(h, gate)) * up if gate is not None else act(up)
    return x + prec.linear(hid, w[pre + "mlp.w_down"])
