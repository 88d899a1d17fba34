"""Train-step factories: LM training of any arch of the zoo and MEM
contrastive training, the reference's (``repro.training.trainer``).

A step takes the module it trains, its AdamW state, a batch (numpy
arrays or tensors) and the step number, and returns the module (its
parameters updated in place), the new state and the metrics as 0-d
tensors. The module is unfrozen (``requires_grad_``) for the step, the
gradients come from ``torch.autograd.grad`` (nothing accumulates in
``.grad``), and ``adamw_update`` writes the update in place. With
``remat`` each layer body is checkpointed, as the reference's
``jax.checkpoint`` (``Transformer.apply(remat=)``): the same gradients
for less activation memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mem import MEM
from repro_torch.models.transformer import Transformer
from repro_torch.training.losses import lm_cross_entropy, siglip_loss
from repro_torch.training.optim import (AdamWState, adamw_update,
                                        cosine_schedule, global_norm)

Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainHParams:
    base_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: bool = True


def _on(batch: Mapping, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _step(loss_fn: Callable, hp: TrainHParams) -> Callable:
    """The step shared by both factories: ``loss_fn(model, batch)`` →
    (loss, metrics); gradients, the schedule, AdamW."""

    def train_step(model: nn.Module, opt_state: AdamWState, batch: Mapping,
                   step) -> Tuple[nn.Module, AdamWState, Metrics]:
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        model.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(model, _on(batch, dev))
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        lr = cosine_schedule(torch.as_tensor(step, device=dev),
                             base_lr=hp.base_lr, warmup=hp.warmup,
                             total=hp.total_steps)
        _, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=hp.weight_decay,
            grad_clip=hp.grad_clip)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   "loss": loss.detach(), "lr": lr,
                   "grad_norm": global_norm(grads)}
        return model, opt_state, metrics

    return train_step


def lm_loss(cfg: ModelConfig, model: Transformer, batch: Mapping, *,
            remat: bool = False) -> Tuple[torch.Tensor, Metrics]:
    """The reference's LM loss of ``model`` (a ``Transformer`` of
    ``cfg``) on a batch of tensors: ``lm_cross_entropy`` over the text
    positions plus the MoE aux loss → (loss, metrics ``nll``,
    ``accuracy``, ``moe_aux``)."""
    if model.cfg != cfg:
        raise ValueError(f"the loss is for {cfg.name}, the model is "
                         f"{model.cfg.name}")
    kw = {}
    if cfg.family == "vlm":
        kw["vision_embeds"] = batch["vision_embeds"]
    if cfg.family == "audio":
        kw["encoder_frames"] = batch["encoder_frames"]
    logits, _, aux = model.apply(batch["tokens"], mode="train", remat=remat,
                                 **kw)
    if cfg.family == "vlm":
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    loss, metrics = lm_cross_entropy(logits, batch["labels"],
                                     batch.get("mask"))
    return loss + aux, {**metrics, "moe_aux": aux}


def mem_loss(mem: MEM, batch: Mapping, *, remat: bool = False
             ) -> Tuple[torch.Tensor, Metrics]:
    """The SigLIP loss of ``mem`` on a batch of tensors (``tokens``,
    ``mask``, ``patches``) → (loss, metrics ``contrastive_acc``)."""
    txt = mem.encode_text(batch["tokens"], batch.get("mask"), remat=remat)
    img = mem.encode_image(batch["patches"], remat=remat)
    return siglip_loss(img, txt, mem.logit_scale, mem.logit_bias)


def make_train_step(cfg: ModelConfig, hp: TrainHParams = TrainHParams()
                    ) -> Callable:
    """LM train step for a ``Transformer`` of ``cfg``. batch: ``tokens``
    and ``labels`` (B, S), optional ``mask``, and ``vision_embeds`` (vlm:
    the logits over them are dropped) or ``encoder_frames`` (audio).
    Loss: ``lm_loss``; metrics ``loss``, ``nll``, ``accuracy``,
    ``moe_aux``, ``lr``, ``grad_norm``."""
    return _step(lambda model, batch: lm_loss(cfg, model, batch,
                                              remat=hp.remat), hp)


def make_mem_train_step(mem: MEM, hp: TrainHParams = TrainHParams()
                        ) -> Callable:
    """SigLIP contrastive step for a MEM of ``mem``'s configuration (the
    step's ``model``). batch: ``tokens``, ``mask`` (B, L) and ``patches``
    (B, P, d_vision); metrics ``loss``, ``contrastive_acc``, ``lr``,
    ``grad_norm``. Unlike the reference's MEM step, ``hp.remat``
    checkpoints the towers' blocks here: the same gradients, for the
    activations of a full-width batch."""

    def loss_fn(model: MEM, batch: Mapping):
        if model.cfg != mem.cfg:
            raise ValueError("the step is for another MEM configuration")
        return mem_loss(model, batch, remat=hp.remat)

    return _step(loss_fn, hp)
