"""Sharding: the memory path's slot slabs, and the rule tables that place
every parameter, cache, batch and optimiser leaf of the model zoo on a
mesh.

**Slabs.** A ``(S, …)`` memory buffer sharded over an axis of size K is K
tensors: slab k holds rows ``[k·S/K, (k+1)·S/K)`` on
``slab_devices(mesh)[k]``, every trailing dim whole. The arena keeps its
super-buffers so, and the sharded scans of ``kernels.ops`` launch once
per slab on the slab's device.

**Rule tables** (the reference's ``repro.launch.sharding``). A spec ``P``
names, per tensor dim, a mesh axis, a tuple of axes or None. One table
covers every architecture, because leaf names are uniform across
families:

* **TP (model axis)**: attention heads (wq/wk/wv out, wo in), FFN hidden
  (w_up/w_gate out, w_down in), MoE experts (leading E), MLA
  up-projections, Mamba2 head-dim projections, RWKV head projections,
  vocab (embed rows, lm_head columns);
* **FSDP (data axes, train modes only)**: the remaining large dim of
  each weight over ``("pod",) + ("data",)``; serving replicates weights
  over data;
* **caches**: batch over data; KV heads over model when divisible, else
  the cache sequence over model; SSM/RWKV states shard heads over model;
* a dim that its axes do not divide, or that is smaller than them, falls
  back to replication (``_sanitize``).

Specs are right-aligned. The reference stacks each block group's leaves
on a leading layer axis, which its specs leave unsharded; the port keeps
one tensor a layer, so a parameter's spec here is the reference's spec
of its leaf (``models.params.reference_path``) without the leading
None. Caches are stacked in both packages, so their specs are the
reference's as they stand. ``to_placements`` turns a spec into DTensor
placements over a ``DeviceMesh``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import data_axes

# sentinel for "the FSDP axes", resolved per mode and mesh
FSDP = "__fsdp__"
MODEL = "model"
_BATCH = "__batch__"


def mesh_axis_size(mesh, axis: str = MODEL) -> int:
    """Shard count of ``axis`` on ``mesh`` (1 when mesh is None or the
    axis is absent): the K every sharded memory path branches on."""
    if mesh is None:
        return 1
    return dict(mesh.shape).get(axis, 1)


def slab_devices(mesh, axis: str = MODEL) -> List[torch.device]:
    """The device of each of the K slabs along ``axis``: the first K
    devices of the mesh's first row (the model axis is the last)."""
    k = mesh_axis_size(mesh, axis)
    if axis != mesh.axis_names[-1] and k > 1:
        raise ValueError(f"memory slabs run along the mesh's last axis, "
                         f"not {axis!r}")
    return list(mesh.device_list()[:k])


def _entry(e):
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a one-axis
    tuple is that axis, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name, or a
    tuple of axis names, the outer axis first). Immutable and compared
    entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


_PARAM_RULES: Sequence[Tuple[str, Tuple]] = (
    # embeddings and heads: vocab-parallel with d replicated
    (r"embed$", (MODEL, None)),
    (r"pos_embed$", (None, FSDP)),
    (r"lm_head$", (None, MODEL)),
    # MoE experts (E, d, ff): expert-parallel over model
    (r"moe/w_(gate|up)$", (MODEL, FSDP, None)),
    (r"moe/w_down$", (MODEL, None, FSDP)),
    (r"moe/router$", (FSDP, None)),
    (r"moe/shared/w_(gate|up)$", (FSDP, MODEL)),
    (r"moe/shared/w_down$", (MODEL, FSDP)),
    # MLA
    (r"w_dq$", (FSDP, None)),
    (r"w_dkv$", (FSDP, None)),
    (r"w_kr$", (FSDP, None)),
    (r"w_uq$", (FSDP, MODEL)),
    (r"w_uk$", (FSDP, MODEL)),
    (r"w_uv$", (FSDP, MODEL)),
    # attention and the generic MLP (also whisper's cross attention)
    (r"(wq|wk|wv)$", (FSDP, MODEL)),
    (r"wo$", (MODEL, FSDP)),
    (r"w_(gate|up)$", (FSDP, MODEL)),
    (r"w_down$", (MODEL, FSDP)),
    # Mamba2
    (r"in_(z|x)$", (FSDP, MODEL)),
    (r"in_dt$", (FSDP, MODEL)),
    (r"in_bc$", (FSDP, None)),
    (r"conv_x_w$", (None, MODEL)),
    (r"conv_x_b$", (MODEL,)),
    (r"out_proj$", (MODEL, FSDP)),
    # RWKV6
    (r"(wr|wg)$", (FSDP, MODEL)),
    (r"cm_wk$", (FSDP, MODEL)),
    (r"cm_wv$", (MODEL, FSDP)),
    (r"cm_wr$", (FSDP, None)),
    (r"decay_w1$", (FSDP, None)),
    (r"decay_w2$", (None, MODEL)),
    (r"maa_w1$", (FSDP, None)),
    (r"ln_scale$", (MODEL, None)),
    (r"bonus_u$", (MODEL, None)),
)

_CACHE_RULES: Sequence[Tuple[str, Tuple]] = (
    # k/v/ckv/krope are decided per leaf (head against sequence sharding)
    (r"(^|/)pos$", (_BATCH,)),
    (r"mrope_delta$", (_BATCH,)),
    (r"enc_out$", (_BATCH, None, None)),
    (r"ssm$", (_BATCH, MODEL, None, None)),
    (r"conv_x$", (_BATCH, None, MODEL)),
    (r"conv_bc$", (_BATCH, None, None)),
    (r"wkv$", (_BATCH, MODEL, None, None)),
    (r"shift_(tm|cm)$", (_BATCH, None)),
)

# ZeRO-3 placement (mode "train_zero3"): FSDP co-sharded with the model
# axis on the already TP-sharded dim; the MoE leaves keep the base rules
_ZERO3_OVERRIDES: Sequence[Tuple[str, Optional[Tuple]]] = (
    (r"moe/", None),
    (r"(wq|wk|wv|wr|wg)$", (None, (FSDP, MODEL))),
    (r"w_(gate|up)$", (None, (FSDP, MODEL))),
    (r"w_u(q|k|v)$", (None, (FSDP, MODEL))),
    (r"in_(z|x)$", (None, (FSDP, MODEL))),
    (r"in_dt$", (None, (FSDP, MODEL))),
    (r"cm_wk$", (None, (FSDP, MODEL))),
    (r"decay_w2$", (None, (FSDP, MODEL))),
    (r"wo$", ((MODEL, FSDP), None)),
    (r"w_down$", ((MODEL, FSDP), None)),
    (r"out_proj$", ((MODEL, FSDP), None)),
    (r"cm_wv$", ((MODEL, FSDP), None)),
)


def path_str(path: Sequence) -> str:
    """A tree path (keys and indices) as the reference joins it."""
    return "/".join(str(p) for p in path)


def _sanitize(spec: Tuple, shape: Sequence[int], mesh) -> P:
    """Right-align the spec to the shape's rank; drop an axis (or a tuple
    of axes) that does not divide its dim or exceeds it."""
    spec = tuple(spec)
    full = (None,) * (len(shape) - len(spec)) + spec
    sizes = dict(mesh.shape)
    out = []
    for dim, ax in zip(shape, full):
        if ax is None:
            out.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes[a]
        out.append(ax if dim % n == 0 and dim >= n else None)
    return P(*out)


def _resolve(spec: Tuple, fsdp_axes: Optional[Tuple[str, ...]],
             batch_axes: Tuple[str, ...]) -> Tuple:
    """Replace the FSDP and batch sentinels by the mesh's axes (None
    where there are none), flattening combined entries."""
    def one(s):
        if s == FSDP:
            return tuple(fsdp_axes) if fsdp_axes else None
        if s == _BATCH:
            return tuple(batch_axes) if batch_axes else None
        if isinstance(s, tuple):
            flat = []
            for t in s:
                r = one(t)
                if r is not None:
                    flat.extend(r if isinstance(r, tuple) else (r,))
            return tuple(flat) if flat else None
        return s
    return tuple(one(s) for s in spec)


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested mappings, lists and
    tuples (a NamedTuple keeps its type)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(ref_path: str, shape: Sequence[int], mesh, *, mode: str
               ) -> P:
    """The spec of one parameter by its reference path and its shape.
    mode: "train" (FSDP × TP), "train_zero3" or "serve" (TP only)."""
    if mode not in ("train", "train_zero3", "serve"):
        raise ValueError(f"unknown mode {mode!r}")
    daxes = data_axes(mesh)
    fsdp = daxes if mode.startswith("train") else None
    if mode == "train_zero3":
        for pat, spec in _ZERO3_OVERRIDES:
            if re.search(pat, ref_path):
                if spec is None:
                    break                     # the base rules decide
                return _sanitize(_resolve(spec, fsdp, daxes), shape, mesh)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, ref_path):
            return _sanitize(_resolve(spec, fsdp, daxes), shape, mesh)
    return P()                                # norms, scalars: replicated


def param_specs(model: torch.nn.Module, mesh, *, mode: str
                ) -> Dict[str, P]:
    """{parameter name: spec} of a ``Transformer`` (on any device, the
    ``meta`` one included)."""
    from repro_torch.models.params import reference_path
    return {name: param_spec(reference_path(model, name), p.shape, mesh,
                             mode=mode)
            for name, p in model.named_parameters()}


def cache_specs(cache, mesh) -> Any:
    """Decode caches (``Transformer.init_cache``'s tree): batch over
    data; KV heads over model where divisible, else the sequence over
    model (context parallelism); the latent MLA cache by sequence."""
    daxes = data_axes(mesh)
    msize = dict(mesh.shape)[MODEL]

    def one(path, leaf):
        ps = path_str(path)
        for pat, spec in _CACHE_RULES:
            if re.search(pat, ps):
                return _sanitize(_resolve(spec, None, daxes), leaf.shape,
                                 mesh)
        if re.search(r"(^|/)(k|v)$", ps):
            # (L, B, C, Hkv, D)
            if leaf.shape[-2] % msize == 0:
                spec = (None, daxes, None, MODEL, None)
            else:
                spec = (None, daxes, MODEL, None, None)
            return _sanitize(spec, leaf.shape, mesh)
        if re.search(r"(ckv|krope)$", ps):
            # (L, B, C, R): the latent cache shards its sequence
            return _sanitize((None, daxes, MODEL, None), leaf.shape, mesh)
        return P()

    return _tree_map(one, cache)


def batch_specs(batch, mesh) -> Any:
    """Input batches (a tensor or a tree of them): the leading batch dim
    over the data axes."""
    daxes = data_axes(mesh)

    def one(path, leaf):
        if len(leaf.shape) == 0:
            return P()
        spec = (tuple(daxes),) + (None,) * (len(leaf.shape) - 1)
        return _sanitize(spec, leaf.shape, mesh)

    return _tree_map(one, batch)


def opt_specs(opt_state, pspecs: Mapping[str, P]):
    """AdamW state: ``count`` replicated, ``mu`` and ``nu`` as the
    parameters."""
    return type(opt_state)(P(), dict(pspecs), dict(pspecs))


def spec_axes(spec: P, dim: int) -> Tuple[str, ...]:
    """The mesh axes that shard tensor dim ``dim`` under ``spec``."""
    e = spec[dim] if dim < len(spec) else None
    if e is None:
        return ()
    return e if isinstance(e, tuple) else (e,)


def to_placements(spec: P, device_mesh) -> List:
    """DTensor placements of ``spec`` over ``device_mesh``: for each mesh
    dim, ``Shard(d)`` where tensor dim d names its axis, else
    ``Replicate()``. A tensor dim over two axes, e.g. ``("pod",
    "data")``, is ``Shard(d)`` on both mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in device_mesh.mesh_dim_names:
        dims = [d for d in range(len(spec)) if axis in spec_axes(spec, d)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
