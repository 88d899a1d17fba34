"""Checkpoints in the reference's format (``repro.training.checkpoint``):
one ``.npz`` whose keys are the ``/``-joined paths of a nested tree, and
a JSON manifest beside it (``keys`` and the caller's metadata). Restore
rebuilds into the structure of a given target.

A training checkpoint is the tree ``{"params": ..., "opt": {"count",
"mu", "nu"}}`` with the parameters and both moments in the reference's
layer-stacked layout (``core.convert.model_params_to_numpy``), so each
package restores the other's file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import (model_params_from_numpy,
                                      model_params_to_numpy)
from repro_torch.training.optim import AdamWState


def _paths(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of nested mappings."""
    if not isinstance(tree, Mapping):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _np(v) for k, v in _paths(tree)}
    np.savez(_npz(path), **flat)
    meta = {"keys": sorted(flat), **(metadata or {})}
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def restore(path: str, target: Any) -> Any:
    """The nested mappings of ``target`` (numpy leaves, as
    ``train_state`` makes them) with every leaf read from the file, of
    the target leaf's shape and dtype."""
    with np.load(_npz(path)) as data:
        def rebuild(tree, prefix=""):
            if isinstance(tree, Mapping):
                return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in tree.items()}
            arr = data[prefix]
            if arr.shape != tuple(tree.shape):
                raise ValueError(f"{prefix}: {arr.shape} in the file, "
                                 f"{tuple(tree.shape)} in the target")
            return arr.astype(tree.dtype)
        return rebuild(target)


def train_state(cfg: ModelConfig, model: torch.nn.Module,
                opt: AdamWState) -> dict:
    """A model of ``cfg`` and its AdamW state → the checkpoint tree, in
    the reference's layout."""
    return {"params": model_params_to_numpy(cfg, model),
            "opt": {"count": _np(opt.count),
                    "mu": model_params_to_numpy(cfg, opt.mu),
                    "nu": model_params_to_numpy(cfg, opt.nu)}}


def load_train_state(cfg: ModelConfig, model: torch.nn.Module,
                     tree: Mapping) -> AdamWState:
    """Load a checkpoint tree's parameters into ``model`` and return its
    AdamW state on the model's device."""
    model.load_state_dict(model_params_from_numpy(cfg, tree["params"]))
    dev = next(model.parameters()).device

    def moments(t):
        return {k: v.to(dev) for k, v in
                model_params_from_numpy(cfg, t).items()}
    opt = tree["opt"]
    return AdamWState(torch.as_tensor(np.asarray(opt["count"], np.int32),
                                      device=dev),
                      moments(opt["mu"]), moments(opt["nu"]))
