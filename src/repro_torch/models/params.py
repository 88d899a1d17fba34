"""Parameter accounting, exact and without allocation: the shapes come from
a model built on the ``meta`` device (the port's ``jax.eval_shape``).

The counts equal the reference's (``repro.models.params``) leaf for leaf:
each port parameter is read under the reference's tree path (dots →
slashes; a decoder's ``blocks.<i>`` → ``dense_blocks`` or ``moe_blocks``,
every other family's ``blocks.<i>`` → ``blocks`` and ``enc_blocks.<i>`` →
``enc_blocks``; the hybrid's weight-tied ``shared`` block once), and the
active count scales each layer-stacked leaf as the reference does, once
over all its layers — which, as in the reference, takes k/E of the
shared experts' leaves too, since their paths lie under ``moe``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig

_EMBED_KEYS = ("embed", "pos_embed", "enc_pos_embed", "lm_head")
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: the model's
    initialisers place tensors on ``gen.device``."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def reference_path(model, name: str) -> str:
    """The reference's tree path of the port parameter ``name`` of
    ``model`` (a ``Transformer``): dots → slashes, a decoder's
    ``blocks.<i>`` → ``dense_blocks`` or ``moe_blocks``, every other
    family's ``blocks.<i>`` → ``blocks`` and ``enc_blocks.<i>`` →
    ``enc_blocks``; the layer index goes, as the reference stacks its
    layers on a leading axis (the hybrid's ``shared`` block is one
    block in both)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks"):
        group = parts[0]
        if model.kind == "decoder" and group == "blocks":
            group = ("dense_blocks" if int(parts[1]) < model.n_dense
                     else "moe_blocks")
        parts = [group] + parts[2:]
    return "/".join(parts)


def meta_model(cfg: ModelConfig):
    """A ``Transformer`` of ``cfg`` on the ``meta`` device: shapes and
    dtypes, no storage."""
    from repro_torch.models.transformer import Transformer
    return Transformer(cfg, _MetaGenerator())


def _shapes(cfg: ModelConfig) -> Dict[str, int]:
    """Element count of each reference leaf path (layer-stacked leaves
    summed over their layers)."""
    model = meta_model(cfg)
    out: Dict[str, int] = {}
    for name, t in model.named_parameters():
        path = reference_path(model, name)
        out[path] = out.get(path, 0) + t.numel()
    return out


def _is_embed(path: str) -> bool:
    return any(path.endswith(k) or f"/{k}" in path for k in _EMBED_KEYS)


def count_params(cfg: ModelConfig) -> int:
    return sum(_shapes(cfg).values())


def count_params_analytic(cfg: ModelConfig) -> int:
    """Non-embedding parameter count."""
    return sum(n for path, n in _shapes(cfg).items() if not _is_embed(path))


def count_active_params_analytic(cfg: ModelConfig) -> int:
    """Non-embedding parameters active per token (MoE: k/E of the expert
    leaves)."""
    if cfg.moe is None:
        return count_params_analytic(cfg)
    frac = cfg.moe.experts_per_token / cfg.moe.num_experts
    total = 0
    for path, n in _shapes(cfg).items():
        if _is_embed(path):
            continue
        if "moe" in path and any(path.endswith(k) for k in _EXPERT_KEYS):
            n = int(n * frac)
        total += n
    return total
