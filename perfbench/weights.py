"""Seeded weights, made on the device by the benchmark.

A model is described by plain numbers (``tower_shape``); its leaves fall
into groups (the embedding, each block, the head), and each group is
made by ONE ``torch.randn`` call on the device from a generator seeded by
(seed, model, group), split into its leaves and scaled: dense weights by
1/sqrt(fan-in), tables by 0.02, norm weights as 1 + 0.1·z. The program
and the reference are given the same group, so the reference can make
each layer again, alone, when it needs it. Leaves carry the names of the
port's parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from perfbench.world import derive_seed

# leaf kinds: how a standard normal draw is scaled
DENSE, TABLE, NORM = "dense", "table", "norm"


def tower_shape(*, layers: int, d: int, heads: int, kv_heads: int,
                head_dim: int, d_ff: int, vocab: int, gated: bool,
                learned_positions: int = 0, head: bool = True,
                prefix: str = "") -> List[Tuple[str, List[tuple]]]:
    """The groups of a pre-norm GQA decoder (RMSNorm, ``gated`` MLP or
    not) as ``[(group, [(leaf, shape, kind), ...]), ...]``."""
    p = prefix
    groups = [(f"{p}embed", [(f"{p}embed", (vocab, d), TABLE)])]
    if learned_positions:
        groups.append((f"{p}pos_embed", [(f"{p}pos_embed",
                                          (learned_positions, d), TABLE)]))
    for i in range(layers):
        b = f"{p}blocks.{i}."
        leaves = [(b + "ln1.w", (d,), NORM),
                  (b + "attn.wq", (d, heads * head_dim), DENSE),
                  (b + "attn.wk", (d, kv_heads * head_dim), DENSE),
                  (b + "attn.wv", (d, kv_heads * head_dim), DENSE),
                  (b + "attn.wo", (heads * head_dim, d), DENSE),
                  (b + "ln2.w", (d,), NORM)]
        if gated:
            leaves.append((b + "mlp.w_gate", (d, d_ff), DENSE))
        leaves += [(b + "mlp.w_up", (d, d_ff), DENSE),
                   (b + "mlp.w_down", (d_ff, d), DENSE)]
        groups.append((f"{p}block{i}", leaves))
    last = [(f"{p}final_norm.w", (d,), NORM)]
    if head:
        last.append((f"{p}lm_head", (d, vocab), DENSE))
    groups.append((f"{p}head", last))
    return groups


def make_group(seed: int, model: str, group: str, leaves, *,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """One group's leaves from one draw on ``device``, in ``dtype``."""
    numel = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed("weights", seed, model, group))
    z = torch.randn((numel,), generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        x = z[off:off + n].reshape(shape)
        off += n
        if kind == DENSE:
            x = x * (1.0 / math.sqrt(shape[0]))
        elif kind == TABLE:
            x = x * 0.02
        else:
            x = 1.0 + 0.1 * x
        out[name] = x.to(dtype)
    return out


class MetaGenerator:
    """What the program's initialisers read of a ``torch.Generator``: a
    ``meta`` device makes them allocate shapes only (the benchmark's
    weights are loaded after ``to_empty``)."""
    device = torch.device("meta")


def groups(seed: int, model: str, shape, **kw
           ) -> Iterator[Dict[str, torch.Tensor]]:
    for group, leaves in shape:
        yield make_group(seed, model, group, leaves, **kw)


def load(module: torch.nn.Module, made: Iterator[Dict[str, torch.Tensor]],
         constants: Dict[str, float] = None) -> None:
    """Copy every made leaf into the parameter of the same name, group by
    group (each group is freed before the next is made); every parameter
    of ``module`` must be given, by a group or by ``constants``."""
    params = dict(module.named_parameters())
    seen = set()
    for g in made:
        for name, t in g.items():
            params[name].data.copy_(t)
            seen.add(name)
        del g
    for name, v in (constants or {}).items():
        params[name].data.fill_(v)
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise RuntimeError(f"weights made for no parameter of "
                           f"{sorted(missing)[:8]}")


def provider(seed: int, model: str, shape, *, dtype=torch.float32,
             device="cuda") -> Callable[[str], Dict[str, torch.Tensor]]:
    """``get(group)`` → that group's leaves made again, upcast to
    ``dtype`` (the reference reads the bf16 values in f32)."""
    table = dict(shape)

    def get(group: str) -> Dict[str, torch.Tensor]:
        made = make_group(seed, model, group, table[group], device=device)
        return {k: v.to(dtype) for k, v in made.items()}
    return get
