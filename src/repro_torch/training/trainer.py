"""Train-step factories: LM training of any arch of the zoo and MEM
contrastive training, the reference's (``repro.training.trainer``).

A step takes the module it trains, its AdamW state, a batch (numpy
arrays or tensors) and the step number, and returns the module (its
parameters updated in place), the new state and the metrics as 0-d
tensors. The module is unfrozen (``requires_grad_``) for the step, the
gradients come from ``loss.backward()`` and are read from ``p.grad``,
which is cleared before and after (nothing accumulates across steps),
and ``adamw_update`` writes the update in place. With ``remat`` each
layer body is checkpointed, as the reference's ``jax.checkpoint``
(``Transformer.apply(remat=)``): the same gradients for less activation
memory.

Training over a ``("data", "model")`` ``DeviceMesh`` of (D, K), the
reference's ``param_specs(mode="train")``: FSDP2 over ``data`` × the
port's tensor parallelism over ``model``. The caller places the model
on the model axis (``launch.sharding.tp_shard(model, mesh,
mode="train")``, or ``init_model(..., mesh=, mode="train")``) where K >
1, shards it once with ``fsdp_shard`` (each parameter then a 2-D
DTensor: the train table's FSDP dim over ``data``, its TP dim over
``model``) and then makes its AdamW state with ``adamw_init``, whose
moments are DTensors placed as their parameters (the reference's
``opt_specs``); ``make_train_step(mesh=)`` trains it. Each data rank
runs its rows of the global batch (the K model ranks of a data rank the
same rows: one loss), the layers' model-axis collectives carry the
gradients (``launch.sharding.TensorParallel``), FSDP2's reduce-scatter
(a mean over ``data``) runs in the backward hooks, and the clip's norm
is global (``optim.global_norm``: each element once, a leaf replicated
over ``model`` counted once). The metrics ``loss``, ``nll``,
``accuracy`` and ``moe_aux`` come back as means over ``data`` only;
``lr`` and ``grad_norm`` are the same on every rank. The MoE aux loss
is each data rank's own routing statistic, so an MoE arch's step at D >
1 is not the single-process step (at D = 1 it is, whatever K).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

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


def fsdp_shard(model: nn.Module, device_mesh) -> nn.Module:
    """Shard ``model`` (a ``Transformer``) in place with FSDP2 over the
    data axis of ``device_mesh``: ``fully_shard`` on each block (their
    ``step`` and ``encode`` registered as forward methods), then on the
    root (``apply``). Where the mesh's model axis is larger than 1 the
    model must be placed on it first (``launch.sharding.tp_shard(model,
    device_mesh, mode="train")``: each parameter a DTensor of the
    ``model`` sub-mesh), and FSDP2 takes the ``data`` sub-mesh, so each
    parameter becomes a 2-D DTensor. Each parameter is split over
    ``data`` on the dim that the reference's ``param_specs(mode=
    "train")`` gives its FSDP axes; where that table gives none (norms,
    scalars, a dim the axes do not divide, the vocabulary table), FSDP2's
    default ``Shard(0)`` — the reference replicates those; on a dim that
    the model axis splits too, FSDP2 interleaves the two
    (``_StridedShard``). The model's layers then read their shards live
    at every forward (``Transformer.set_tp(keep=False)``). The
    parameters are unfrozen first."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import abstract_of, data_axes
    from repro_torch.launch.sharding import (mesh_axis_size, param_specs,
                                             spec_axes)
    daxes = data_axes(device_mesh)
    if len(daxes) != 1:
        raise ValueError(f"FSDP runs over one data axis; the mesh has "
                         f"{daxes}")
    tp = getattr(model, "tp", None)
    if mesh_axis_size(device_mesh) > 1 and tp is None:
        raise ValueError("on a mesh whose model axis is larger than 1, "
                         "fsdp_shard takes a model placed by tp_shard("
                         "model, mesh, mode='train')")
    if tp is not None and tp.device_mesh is not device_mesh:
        raise ValueError("fsdp_shard takes the DeviceMesh the model was "
                         "placed on")
    specs = param_specs(model, abstract_of(device_mesh), mode="train")
    dims = {}
    for name, p in model.named_parameters():
        spec = specs[name]
        fsdp = [d for d in range(len(spec))
                if set(spec_axes(spec, d)) & set(daxes)]
        if fsdp:
            dims[id(p)] = Shard(fsdp[0])
    kw = dict(mesh=device_mesh[daxes[0]], reshard_after_forward=True,
              shard_placement_fn=lambda p: dims.get(id(p)))
    model.requires_grad_(True)
    for group in ("blocks", "enc_blocks"):
        for block in getattr(model, group, None) or ():
            fully_shard(block, **kw)
            for method in ("step", "encode"):
                if hasattr(block, method):
                    register_fsdp_forward_method(block, method)
    fully_shard(model, **kw)
    register_fsdp_forward_method(model, "apply")
    if tp is not None:
        model.set_tp(tp, keep=False)
    return model


def _rank_means(metrics: Metrics, group) -> Metrics:
    """Each metric's mean over the ranks of ``group``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    keys = list(metrics)
    vals = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(vals, group=group)
    return {k: v / n for k, v in zip(keys, vals)}


def _check_placed(model: nn.Module, device_mesh) -> None:
    """Refuse a model the step cannot train on ``device_mesh``: one not
    sharded by ``fsdp_shard``, one without the model axis on a mesh whose
    model axis is larger than 1, and, without a mesh, one placed on a
    mesh (only a dry run's ``RecordingTP`` runs a rank's step alone)."""
    from repro_torch.launch.sharding import RecordingTP, mesh_axis_size
    tp = getattr(model, "tp", None)
    if device_mesh is None:
        if tp is not None and not isinstance(tp, RecordingTP):
            raise ValueError("a model placed on the model axis trains with "
                             "make_train_step(mesh=) after fsdp_shard")
        return
    from torch.distributed.fsdp import FSDPModule
    if not isinstance(model, FSDPModule):
        raise ValueError("make_train_step(mesh=) trains a model "
                         "sharded by fsdp_shard(model, mesh)")
    if mesh_axis_size(device_mesh) > 1 and tp is None:
        raise ValueError("make_train_step(mesh=) on a model axis larger "
                         "than 1 trains a model placed by tp_shard(model, "
                         "mesh, mode='train') before fsdp_shard")


def _step(loss_fn: Callable, hp: TrainHParams, device_mesh=None
          ) -> Callable:
    """The step shared by both factories: ``loss_fn(model, batch)`` →
    (loss, metrics); gradients, the schedule, AdamW; the metrics are
    means over the ranks of ``device_mesh``'s data axis when one is
    given (the model sharded over it by ``fsdp_shard``; the model axis's
    ranks hold one loss)."""
    group = None
    if device_mesh is not None:
        from repro_torch.launch.mesh import data_axes
        daxes = data_axes(device_mesh)
        if len(daxes) != 1:
            raise ValueError(f"FSDP runs over one data axis; the mesh has "
                             f"{daxes}")
        group = device_mesh.get_group(daxes[0])

    def train_step(model: nn.Module, opt_state: AdamWState, batch: Mapping,
                   step) -> Tuple[nn.Module, AdamWState, Metrics]:
        _check_placed(model, device_mesh)
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        model.requires_grad_(True)
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = loss_fn(model, _on(batch, dev))
            loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        lr = cosine_schedule(torch.as_tensor(step, device=dev),
                             base_lr=hp.base_lr, warmup=hp.warmup,
                             total=hp.total_steps)
        _, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=hp.weight_decay,
            grad_clip=hp.grad_clip)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   "loss": loss.detach()}
        if group is not None:
            metrics = _rank_means(metrics, group)
        metrics.update(lr=lr, grad_norm=global_norm(grads))
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


def make_train_step(cfg: ModelConfig, hp: TrainHParams = TrainHParams(),
                    mesh: Optional[object] = None) -> Callable:
    """LM train step for a ``Transformer`` of ``cfg``. batch: ``tokens``
    and ``labels`` (B, S), optional ``mask``, and ``vision_embeds`` (vlm:
    the logits over them are dropped) or ``encoder_frames`` (audio).
    Loss: ``lm_loss``; metrics ``loss``, ``nll``, ``accuracy``,
    ``moe_aux``, ``lr``, ``grad_norm``. ``mesh``: a ``torch.distributed``
    ``DeviceMesh`` with the reference's axis names (``("data",
    "model")``, or ``data`` alone), over which the caller placed the
    model (``tp_shard(mode="train")`` where the model axis is larger
    than 1, then ``fsdp_shard``) before ``adamw_init``; each rank's batch
    is its data rank's rows of the global batch, and the metrics are
    means over ``data``."""
    return _step(lambda model, batch: lm_loss(cfg, model, batch,
                                              remat=hp.remat), hp, mesh)


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
