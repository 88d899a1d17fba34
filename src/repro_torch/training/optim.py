"""AdamW and the cosine schedule, the reference's (``repro.training.
optim``) as plain functions over a parameter dict: the gradients clipped
by ``min(1, clip / (‖g‖ + 1e-9))`` over the global norm, f32 moments
whatever the parameter dtype, bias correction, the decay added into the
step, and the update computed in f32 and cast back to the parameter's
dtype — written in place, one leaf's temporaries at a time.
``torch.optim.AdamW`` differs in its clip epsilon and its state layout;
this state is the reference's ``count`` / ``mu`` / ``nu``, which a
checkpoint carries across packages."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, NamedTuple, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    count: torch.Tensor            # () int32: updates taken
    mu: Params                     # f32 first moments, by parameter name
    nu: Params                     # f32 second moments


def adamw_init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero f32 moments beside each parameter, on its device."""
    dev = next(iter(params.values())).device

    def zeros() -> Params:
        return {k: torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                for k, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], *,
                 lr: Union[float, torch.Tensor], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[Params, AdamWState]:
    """One AdamW step in the reference's arithmetic: the new parameters
    and moments are written into ``params`` and ``state``'s tensors,
    which return as (params, the state with its count advanced)."""
    f32 = torch.float32
    count = state.count + 1
    cf = count.to(f32)
    scale = None
    if grad_clip and grad_clip > 0:
        scale = torch.clamp(grad_clip / (global_norm(grads) + 1e-9),
                            max=1.0)
    c1 = 1 - b1 ** cf
    c2 = 1 - b2 ** cf
    for k, p in params.items():
        # DTensors (FSDP2) update shard by shard: the same elements
        p, g, m, v = (_local(t) for t in (p, grads[k], state.mu[k],
                                          state.nu[k]))
        g = g.to(f32)
        if scale is not None:
            g = g * scale
        torch.add(b1 * m, (1 - b1) * g, out=m)
        torch.add(b2 * v, (1 - b2) * torch.square(g), out=v)
        p32 = p.to(f32)
        step = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p32
        p.copy_(p32 - lr * step)
    return dict(params), AdamWState(count, state.mu, state.nu)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage), else ``t``."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in f32; over all shards of a DTensor (an all-reduce)."""
    from torch.distributed.tensor import DTensor
    s = torch.sum(torch.square(x.to(torch.float32)))
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree: Union[Mapping[str, torch.Tensor],
                            Iterable[torch.Tensor]]) -> torch.Tensor:
    """sqrt(Σ over every leaf of Σ x²), in f32; the global norm of
    DTensor leaves, whatever their sharding: each element once, a leaf
    replicated over a mesh axis (a norm over ``model``) counted once, as
    the sum of a ``Replicate`` dim is one rank's value — the model ranks'
    gradients of such a leaf agree (``launch.sharding.TensorParallel``'s
    collectives)."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(sum(_square_sum(x) for x in leaves))


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_frac · base_lr`` at ``total``; f32, on the
    step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
