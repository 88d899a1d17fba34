"""Shared neural-net primitives, written as the reference writes them.

Parameters are tensors in mappings (``nn.ParameterDict`` inside the
modules) under the reference's names, stored in ``param_dtype`` and cast
to the activation dtype at use. Norms compute in f32 and cast back.
Initialisers take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None, dtype=torch.float32
               ) -> torch.Tensor:
    """(d_in, d_out) variance-scaling (fan-in) weight."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32
               ) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":           # jax.nn.gelu's default: the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, gated: bool,
             dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype=dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype=dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype=dtype)
    return p


def mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              act_name: str) -> torch.Tensor:
    act = activation_fn(act_name)
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = act(up)
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (RoPE / partial RoPE)
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) → cos/sin of shape (..., rot_dim // 2)."""
    half = rot_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, exps)   # no host→device copy
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    """Rotate pairs (x1, x2) = (x[..., :half], x[..., half:])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S). Rotates the leading
    ``fraction`` of D in halves (not interleaved pairs), cos and sin cast
    to the activation dtype first; passes the rest through."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    cos, sin = rope_cos_sin(positions, rot, theta)   # (B, S, rot/2)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    head, tail = x[..., :rot], x[..., rot:]
    head = _rotate(head, cos, sin)
    return torch.cat([head, tail], dim=-1) if tail.numel() else head


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, *, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D); positions3: (3, B, S)
    temporal/height/width position ids. ``sections`` splits the D/2
    frequency slots among (t, h, w); each slot rotates by the position id
    of its section."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    dev = x.device
    exps = torch.arange(half, dtype=torch.float32, device=dev) / half
    freqs = 1.0 / torch.pow(theta, exps)
    # section id of each frequency slot, built on the device
    j = torch.arange(half, device=dev)
    sec = (j >= sections[0]).long() + (j >= sections[0] + sections[1]).long()
    pos = positions3.to(dev, torch.float32)[sec]           # (half, B, S)
    ang = pos.permute(1, 2, 0) * freqs                      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)
