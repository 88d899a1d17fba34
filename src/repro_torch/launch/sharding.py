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
# the reference's ring-algorithm traffic factor a collective's output byte
# (``repro.launch.dryrun._COLL_FACTOR``)
RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def mesh_axis_size(mesh, axis: str = MODEL) -> int:
    """Shard count of ``axis`` on ``mesh`` (a ``Mesh`` or a
    ``DeviceMesh``; 1 when mesh is None or the axis is absent): the K
    every sharded memory path branches on."""
    if mesh is None:
        return 1
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                     # a DeviceMesh
        return dict(zip(names, mesh.shape)).get(axis, 1)
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
            n *= sizes.get(a, 1)          # an axis the mesh lacks: size 1
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


# ===========================================================================
# The model axis: a model's parameters and caches placed by the tables
# ===========================================================================


def _grad(x: torch.Tensor) -> bool:
    """x is part of an autograd graph (a train step's forward)."""
    return torch.is_grad_enabled() and x.requires_grad


class _RowSum(torch.autograd.Function):
    """The sum of a row-parallel product's partials over the model axis,
    whose consumer is the same on every rank: the backward is the
    identity (each rank's partial meets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp._sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _StatSum(torch.autograd.Function):
    """The sum over the model axis of a statistic that each rank applies
    to its own shard: the backward sums each rank's share of the
    gradient over the axis."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp._sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum(g), None


class _Copy(torch.autograd.Function):
    """A tensor every model rank holds alike entering each rank's own
    computation: the forward is the identity, the backward sums the
    ranks' shares of its gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum(g), None


class _Gather(torch.autograd.Function):
    """The ranks' tensors of a group concatenated on ``dim``. Backward:
    the rank's own slice of the gradient where every rank consumes the
    gathered tensor alike; with ``scatter`` (a consumer that differs by
    rank) the ranks' gradients are summed and scattered, each rank
    keeping its slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, tp, dim, data, scatter):
        ctx.tp, ctx.dim, ctx.data, ctx.scatter = tp, dim, data, scatter
        ctx.n = x.shape[dim]
        return tp._gather(x, dim, data)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.scatter:
            return tp._reduce_scatter(g, ctx.dim, ctx.data), None, None, \
                None, None
        rank = tp.data_rank if ctx.data else tp.rank
        return (g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None, None,
                None)


class TensorParallel:
    """A model's place on a ``("data", "model")`` ``DeviceMesh``: this
    rank's coordinates, its model and data groups, and the collectives the
    layers call between their products on local tensors. DTensors hold
    the parameters and caches (their placements are the tables'); the
    layers compute on their local shards, so no op pays DTensor's
    dispatch on the host, which a decode step already waits for.

    The collectives carry gradients (autograd functions), so a train step
    on the model axis trains every parameter: ``all_reduce`` (a
    row-parallel output), ``all_reduce_stat`` (a statistic each rank
    applies to its own shard), ``copy`` (a replicated tensor entering the
    rank's own computation) and the gathers, each with the backward its
    consumer needs. Outside a graph (serving, ``no_grad``) they run the
    plain collectives alone. All reductions run in float32 and cast back;
    a gather of bf16 moves its bits unchanged.

    ``moved``: None, or a dict that each collective this rank runs adds
    its bytes to, by op, with the reference's ring factors (the dry run's
    ``collective_bytes``: output bytes × 2 for an all-reduce, × 1 for an
    all-gather or a reduce-scatter)."""

    def __init__(self, device_mesh, device=None):
        names = tuple(device_mesh.mesh_dim_names)
        if names != ("data", MODEL):
            raise ValueError(f"tensor parallelism runs on a ('data', "
                             f"'model') mesh, not {names}")
        from repro_torch.launch.mesh import abstract_of
        self.device_mesh = device_mesh
        self.mesh = abstract_of(device_mesh)
        self.device = torch.device(
            device if device is not None else
            "cpu" if device_mesh.device_type == "cpu" else
            f"cuda:{torch.cuda.current_device()}")
        self.size = device_mesh.size(1)
        self.rank = device_mesh.get_local_rank(MODEL)
        self.group = device_mesh.get_group(MODEL)
        self.data_size = device_mesh.size(0)
        self.data_rank = device_mesh.get_local_rank("data")
        self.data_group = device_mesh.get_group("data")
        self.moved: Optional[Dict[str, float]] = None

    # ------------------------------------------------- the process group
    def _record(self, op: str, t: torch.Tensor) -> None:
        if self.moved is not None:
            self.moved[op] = (self.moved.get(op, 0.0) + t.numel()
                              * t.element_size() * RING_FACTOR[op])

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 sum of ``x`` over the model ranks, cast back."""
        import torch.distributed as dist
        y = x.to(torch.float32, copy=True).contiguous()
        self._record("all-reduce", y)
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def _gather(self, x: torch.Tensor, dim: int, data: bool = False
                ) -> torch.Tensor:
        import torch.distributed as dist
        group, n = ((self.data_group, self.data_size) if data
                    else (self.group, self.size))
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim=dim)
        self._record("all-gather", out)
        return out

    def _reduce_scatter(self, g: torch.Tensor, dim: int, data: bool = False
                        ) -> torch.Tensor:
        """This rank's slice on ``dim`` of the f32 sum of every rank's
        ``g``, cast back."""
        import torch.distributed as dist
        group, n = ((self.data_group, self.data_size) if data
                    else (self.group, self.size))
        parts = [t.contiguous() for t in
                 torch.chunk(g.to(torch.float32), n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        self._record("reduce-scatter", out)
        return out.to(g.dtype)

    # -------------------------------------------------------- collectives
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis of each rank's ``x`` (a row-parallel
        product's partial sums), in float32, cast back to x's dtype. Its
        consumer is the same on every rank, so the backward passes the
        gradient through."""
        if self.size == 1:
            return x
        return _RowSum.apply(x, self) if _grad(x) else self._sum(x)

    def all_reduce_stat(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis of a statistic that each rank then
        applies to its own shard (Mamba2's gated norm): the forward of
        ``all_reduce``, a backward that sums over the ranks."""
        if self.size == 1:
            return x
        return _StatSum.apply(x, self) if _grad(x) else self._sum(x)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, held alike by every model rank, as it enters this rank's
        own computation (a column-parallel product, a slice of the rank's
        heads): the identity, whose backward sums the ranks' gradients.
        Outside a graph it is ``x`` itself."""
        if self.size == 1 or not _grad(x):
            return x
        return _Copy.apply(x, self)

    def _gathered(self, x, dim, data, scatter, n):
        if n == 1:
            return x
        if _grad(x):
            return _Gather.apply(x, self, dim % x.dim(), data, scatter)
        return self._gather(x, dim, data)

    def gather_model(self, x: torch.Tensor, dim: int = -1, *,
                     scatter: bool = False) -> torch.Tensor:
        """The ranks' ``x`` concatenated on ``dim`` in model-rank order.
        ``scatter``: the consumer differs by rank, so the backward is a
        reduce-scatter; else it takes the rank's slice."""
        return self._gathered(x, dim, False, scatter, self.size)

    def stack_model(self, x: torch.Tensor) -> torch.Tensor:
        """(R, *x.shape): every model rank's ``x``, in rank order (decode's
        partials, merged alike on every rank)."""
        return self._gathered(x[None], 0, False, False, self.size)

    # ------------------------------------------------------------ the batch
    def batch_sharded(self, b: int) -> bool:
        """A batch of ``b`` rows is split over the data axis (the tables'
        rule: the axis divides it), else every data rank holds it all."""
        return self.data_size > 1 and b % self.data_size == 0

    def batch_rows(self, x: Optional[torch.Tensor]):
        """This data rank's rows of a global batch (all of them where the
        batch is not split)."""
        if x is None or not self.batch_sharded(x.shape[0]):
            return x
        n = x.shape[0] // self.data_size
        return x[self.data_rank * n:(self.data_rank + 1) * n]

    def gather_batch(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """The global batch of ``b`` rows from each data rank's rows (the
        serving logits, alike on every rank: the backward takes the rank's
        rows)."""
        if not self.batch_sharded(b):
            return x
        return self._gathered(x, 0, True, False, self.data_size)

    # --------------------------------------------------------- the sequence
    def seq_bounds(self, n: int) -> Tuple[int, int]:
        """Rows [lo, hi) of a length-``n`` sequence that this model rank
        holds: chunks of ceil(n / R), the last ones shorter or empty."""
        per = -(-n // self.size)
        lo = min(n, self.rank * per)
        return lo, min(n, lo + per)

    def gather_seq(self, x: torch.Tensor, n: int, *, scatter: bool = False
                   ) -> torch.Tensor:
        """The whole length-``n`` sequence (dim 1) from each rank's
        ``seq_bounds`` rows of it; ``scatter`` as ``gather_model``'s."""
        if self.size == 1:
            return x
        per = -(-n // self.size)
        if x.shape[1] < per:
            pad = list(x.shape)
            pad[1] = per - x.shape[1]
            x = torch.cat([x, x.new_zeros(pad)], dim=1)
        return self.gather_model(x, 1, scatter=scatter)[:, :n]

    # ------------------------------------------------------------ placement
    def place(self, t: torch.Tensor, spec: P, model_only: bool = False):
        """``t`` (the whole tensor, or a ``meta`` one: zeros) as a DTensor
        of this mesh with ``spec``'s placements: this rank's slice, split
        locally (no collective), copied to storage of its own on the
        rank's device, so the whole tensor can be freed. ``model_only``:
        a DTensor of the ``model`` sub-mesh, whole over ``data`` (what
        FSDP2 then shards over ``data``: ``training.trainer.fsdp_shard``)."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        mesh = self.device_mesh[MODEL] if model_only else self.device_mesh
        placements = to_placements(spec, mesh)
        part = distribute_tensor(t, mesh, placements,
                                 src_data_rank=None).to_local()
        local = (torch.zeros(part.shape, dtype=t.dtype, device=self.device)
                 if part.is_meta else
                 part.to(self.device, copy=True).contiguous())
        return DTensor.from_local(local, mesh, placements, run_check=False)


def model_copy(tp, x: torch.Tensor) -> torch.Tensor:
    """``x``, held alike by every model rank, as it enters this rank's
    own computation: ``tp.copy(x)`` in a graph (a train step), ``x``
    itself off the model axis or outside a graph, where nothing is
    called."""
    return tp.copy(x) if tp is not None and _grad(x) else x


def stat_sum(tp, x: torch.Tensor) -> torch.Tensor:
    """The sum over the model axis of a statistic each rank applies to its
    own shard: ``tp.all_reduce_stat(x)`` in a graph, whose backward sums
    over the ranks; outside one the plain ``tp.all_reduce``."""
    return tp.all_reduce_stat(x) if _grad(x) else tp.all_reduce(x)


class LocalShard:
    """One rank's shard of a placed tensor with no process group behind
    it: the whole tensor's ``shape`` and the rank's local tensor
    (``to_local``). What ``RecordingTP`` places; the layers read it as a
    DTensor's local shard."""

    device_mesh = None

    def __init__(self, local: torch.Tensor, shape: Sequence[int]):
        self._local = local
        self.shape = torch.Size(shape)

    def to_local(self) -> torch.Tensor:
        return self._local


class RecordingTP(TensorParallel):
    """A stand-in ``TensorParallel`` of rank 0 of an abstract ``("data",
    "model")`` mesh, with no process group: its collectives return what
    rank 0 would receive in shape and dtype (the ``meta`` device's
    tensors carry nothing else) and add their bytes to ``moved``, by op.
    The dry run drives one rank's step through it and reads the
    model-axis collective bytes that the step runs."""

    def __init__(self, mesh, device="meta"):
        sizes = dict(mesh.shape)
        if tuple(mesh.axis_names) != ("data", MODEL):
            raise ValueError(f"a ('data', 'model') mesh, not "
                             f"{mesh.axis_names}")
        self.device_mesh = None
        self.mesh = mesh
        self.device = torch.device(device)
        self.size, self.rank = sizes[MODEL], 0
        self.data_size, self.data_rank = sizes["data"], 0
        self.group = self.data_group = None
        self.moved = {op: 0.0 for op in RING_FACTOR}

    def _sum(self, x):
        y = x.to(torch.float32, copy=True)
        self._record("all-reduce", y)
        return y.to(x.dtype)

    def _gather(self, x, dim, data=False):
        n = self.data_size if data else self.size
        out = torch.cat([x] * n, dim=dim)
        self._record("all-gather", out)
        return out

    def _reduce_scatter(self, g, dim, data=False):
        n = self.data_size if data else self.size
        out = torch.chunk(g.to(torch.float32), n, dim=dim)[0].contiguous()
        self._record("reduce-scatter", out)
        return out.to(g.dtype)

    def place(self, t, spec, model_only=False):
        """Rank 0's shard of ``t`` under ``spec`` (over ``model`` alone
        with ``model_only``), as a ``LocalShard``."""
        return LocalShard(local_shard(t, spec, self.mesh, model_only),
                          t.shape)


def local_shard(t: torch.Tensor, spec: P, mesh, model_only: bool = False
                ) -> torch.Tensor:
    """Rank 0's slice of ``t`` under ``spec`` on the abstract ``mesh``:
    each dim cut to its first 1/n, n the product of its axes' sizes (the
    ``model`` axis alone with ``model_only``)."""
    sizes = dict(mesh.shape)
    out = t
    for d in range(len(spec)):
        n = 1
        for a in spec_axes(spec, d):
            if a == MODEL or not model_only:
                n *= sizes[a]
        if n > 1:
            out = out.narrow(d, 0, t.shape[d] // n)
    return out


def gather_whole(t):
    """A DTensor's whole tensor (``full_tensor``: a collective every rank
    of its mesh joins), else ``t``. Over gloo the shards of CUDA tensors
    are gathered on the host (``via_host``): ``full_tensor`` of a 2-D
    CUDA DTensor over gloo ends the process (SIGSEGV, torch 2.11, ranks
    sharing a card)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    import torch.distributed as dist
    mesh = t.device_mesh
    if mesh.device_type == "cpu" or dist.get_backend(
            mesh.get_group(0)) != "gloo":
        return t.full_tensor()
    return via_host(t).to(t.device)


def via_host(t):
    """``t.full_tensor()`` on the host: the local shard copied to the CPU
    and gathered on a CPU twin of ``t``'s mesh over the same process
    groups (gloo takes CPU tensors)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh = t.device_mesh
    groups = mesh.get_all_groups()
    cpu = DeviceMesh.from_group(groups if mesh.ndim > 1 else groups[0],
                                "cpu", mesh=mesh.mesh,
                                mesh_dim_names=mesh.mesh_dim_names)
    return DTensor.from_local(t.to_local().cpu(), cpu, t.placements,
                              shape=t.shape, stride=t.stride(),
                              run_check=False).full_tensor()


def is_placed(t) -> bool:
    """A DTensor (a placed parameter or cache leaf)."""
    return hasattr(t, "device_mesh") and hasattr(t, "to_local")


def local(t):
    """A placed tensor's local shard (the same storage), else ``t``."""
    return t.to_local() if is_placed(t) else t


# the families whose serving runs on the model axis: every one the
# ``Transformer`` builds — the decoders (GQA or MLA, dense or MoE), the
# Mamba2 hybrid, RWKV6 (family "ssm") and Whisper ("audio")
TP_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")


def tp_shard(model, device_mesh, *, mode: str = "serve", device=None):
    """Place ``model`` (a ``Transformer`` of any family) on
    ``device_mesh``: every parameter becomes a DTensor with
    ``to_placements(param_spec(...))`` — heads, MLA's up-projections,
    FFN columns, the experts by E, Mamba2's and RWKV6's head projections,
    the hybrid's shared block, Whisper's encoder and cross attention, and
    the vocabulary and learned-position tables by their rows over
    ``model``, replicated over ``data`` (``mode="serve"``) — in place; the
    model then computes on its local shards between the layers'
    collectives. ``mode="train"``: the same split over ``model``, each
    parameter a DTensor of the ``model`` sub-mesh, whole over ``data``,
    for ``training.trainer.fsdp_shard`` to shard over ``data`` by the
    train table. Returns the model."""
    check_tp_family(model.cfg)
    tp = TensorParallel(device_mesh, device)
    place_params(model, tp, mode=mode)
    model.set_tp(tp)
    return model


def check_tp_family(cfg) -> None:
    """Raise ``NotImplementedError`` for a config whose serving has no
    model-axis path (one of a family the ``Transformer`` does not build:
    every config of the registry has one)."""
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: serving on the model axis runs the families "
            f"{TP_FAMILIES}; {cfg.family} has no model-axis path")


def place_params(model, tp: TensorParallel, *, mode: str = "serve"
                 ) -> None:
    """Replace each parameter of ``model`` not placed yet by its placed
    DTensor, in place (a model under construction places what it has)."""
    from repro_torch.models.params import reference_path
    for name, p in list(model.named_parameters()):
        if is_placed(p):
            continue
        spec = param_spec(reference_path(model, name), p.shape, tp.mesh,
                          mode=mode)
        set_param(model, name, tp.place(p.detach(), spec,
                                         model_only=mode != "serve"))


def set_param(model, name: str, t) -> None:
    """Replace ``model``'s parameter ``name`` (a dotted path) by a frozen
    parameter of ``t``."""
    owner = model
    *path, leaf = name.split(".")
    for part in path:
        owner = getattr(owner, part)
    setattr(owner, leaf, torch.nn.Parameter(t, requires_grad=False))


def place_cache(cache, device_mesh, device=None):
    """A decode cache (``Transformer.init_cache``'s tree, on any device —
    ``meta`` too, then zeros) with each leaf a DTensor placed by
    ``cache_specs``: the batch over ``data``; k and v (the decoders', the
    hybrid's ``shared`` and Whisper's ``self`` groups) by their KV heads
    over ``model`` where those divide it, else by their sequence; MLA's
    latent ckv and krope by their sequence, whatever the heads; Mamba2's
    ``ssm`` and ``conv_x`` and RWKV6's ``wkv`` by head where the heads
    divide it; ``conv_bc``, the token-shift states and ``enc_out`` whole.
    A placed cache passes through."""
    tp = device_mesh if isinstance(device_mesh, TensorParallel) else \
        TensorParallel(device_mesh, device)
    specs = cache_specs(cache, tp.mesh)
    return _tree_map(
        lambda path, leaf: leaf if is_placed(leaf) else tp.place(
            leaf, _leaf(specs, path)), cache)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree
