"""Dry run of every (arch × shape) for one H100 a mesh device: the work
of one step, counted on the ``meta`` device, the reference's
``repro.launch.dryrun`` in its GPU meaning.

The reference lowers and compiles each step for 512 host devices and
reads XLA's cost and memory analyses. Here the step itself (the port's
train step with remat, ``make_prefill_step`` or ``make_serve_step``)
runs once over meta tensors — shapes and dtypes, no storage, no card —
for the global batch, and is counted as it runs:

* ``flops_per_device``: the matmul-class operations that
  ``torch.utils.flop_counter.FlopCounterMode`` counts (mm, bmm, SDPA,
  convolutions and ``aten._grouped_mm``, whose formula this module
  registers where torch has none: 2 · rows · K · N, the routed rows of
  an MoE layer, not E/k times them), for the global step ÷ (data ×
  model). Element-wise operations are not counted;
* ``bytes_accessed_per_device``: the operand and result bytes of every
  aten op that is not a view, summed by ``_Accounting``: the
  counterpart of XLA's unfused "bytes accessed";
* ``bytes_min_per_device``: the step's own inputs read once and its
  outputs written once, per device by the placements of
  ``launch.sharding``;
* ``memory``: argument and output bytes per device from the placements;
  ``temp_bytes``, an estimate: the peak of the meta storage that the
  step's ops created and still held, ÷ (data × model);
* ``collective_bytes_per_device``: what the port runs, by op, with the
  reference's ring factors (output bytes × 2.0 for an all-reduce, × 1.0
  for an all-gather or a reduce-scatter): in the train modes FSDP2's
  parameter all-gathers (two a step: forward, and backward after the
  reshard) and its gradient reduce-scatter, from the placements; and,
  on a mesh whose model axis is larger than 1, the model-axis
  collectives of the port's tensor-parallel layers
  (``model_axis_collective_bytes_per_device``), read from one rank's
  step on the ``meta`` device through ``launch.sharding.RecordingTP``
  (rank 0, no process group, each parameter its model-axis shard): for
  train the forward, remat's recompute and the backward's conjugates;
  for prefill and decode the forward.

Meta tensors are not CUDA tensors, so ``kernels.ops`` takes the plain
versions: every count is of the plain formulation, whatever kernel runs
on the card. The counts that grow with depth are taken from two shallow
variants (``depth_variants``) and extrapolated, as the reference does:
the recurrent families' time loops (the WKV recurrence, the SSD scan)
would make a full-depth step at prefill_32k cost millions of
dispatches. ``roofline_s = max(flops / peak, bytes_min / HBM rate)`` for
the card of ``launch.mesh.HARDWARE``, with the visible card's name and
power limit beside it (None for both with no card).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeSpec,
                                      get_shape)
from repro_torch.configs.registry import (ARCH_IDS, combo_is_skipped,
                                          get_config)
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (Mesh, data_axes, hardware,
                                     make_abstract_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import adapt_config, input_specs, params_shape
from repro_torch.models.params import reference_path
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.training.optim import adamw_init
from repro_torch.training.trainer import TrainHParams, make_train_step

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# ring-algorithm traffic factor a gathered or scattered output byte
_COLL_FACTOR = shd.RING_FACTOR
# FSDP2 all-gathers every parameter in forward, and again in backward
# after the reshard that follows the forward
FSDP_GATHERS_A_STEP = 2
TRAIN_SHARDING_MODE = "train"   # or "train_zero3"
# cache leaves written whole at a decode step; the attention caches
# (k, v, ckv, krope) take one row of their sequence axis
_STATE_LEAVES = ("pos", "mrope_delta", "ssm", "conv_x", "conv_bc", "wkv",
                 "shift_tm", "shift_cm")


def _register_grouped_mm() -> None:
    """A flop formula for ``aten._grouped_mm`` where torch has none:
    a (M, K) × b (E, K, N) → 2·M·K·N, the rows routed to the groups
    (also a 3-D a); a (K, M) × b (M, N) grouped over M → (E, K, N),
    2·K·M·N (the weight gradient)."""
    op = getattr(torch.ops.aten, "_grouped_mm", None)
    if op is None or op.default in flop_counter.flop_registry:
        return

    @flop_counter.register_flop_formula(op)
    def _grouped_mm_flop(a_shape, b_shape, *args, out_shape=None, **kw):
        n_out = 1
        for s in out_shape:
            n_out *= s
        if len(a_shape) == 2 and len(b_shape) == 2:
            return 2 * (n_out // out_shape[0]) * a_shape[1]
        return 2 * n_out * a_shape[-1]


_register_grouped_mm()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Accounting(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op that is not a
    view, and tracks the storage the ops create: ``peak`` is the most of
    it alive at once. A storage dies when nothing but this mode holds
    it; the storages of the last ``YOUNG`` creations are checked at every
    op, older ones in a sweep every ``len(old)`` ops (so a dead old
    storage may count until the next sweep: the peak is an estimate).
    Storages of ``external`` tensors (the step's arguments) are not
    counted as created."""

    YOUNG = 32

    def __init__(self, external=()):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self._external = {t.untyped_storage()._cdata for t in external}
        self._young: Dict[int, Tuple[Any, int]] = {}
        self._old: Dict[int, Tuple[Any, int]] = {}
        self._next_sweep = 0
        self.live_bytes = 0
        self.peak = 0

    def _drop_dead(self, gen: Dict[int, Tuple[Any, int]]) -> None:
        for k in [k for k in gen if torch._C._storage_Use_Count(k) <= 1]:
            self.live_bytes -= gen.pop(k)[1]

    def _known(self, k: int) -> bool:
        return k in self._external or k in self._young or k in self._old

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if func.is_view:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._drop_dead(self._young)
        if self.ops >= self._next_sweep:
            self._drop_dead(self._old)
            self._next_sweep = self.ops + max(len(self._old), self.YOUNG)
        for o in outs:
            st = o.untyped_storage()
            if not self._known(st._cdata):
                self._young[st._cdata] = (st, st.nbytes())
                self.live_bytes += st.nbytes()
        while len(self._young) > self.YOUNG:
            k = next(iter(self._young))
            self._old[k] = self._young.pop(k)
        self.peak = max(self.peak, self.live_bytes)
        return out


def depth_variants(cfg: ModelConfig):
    """Two reduced-depth configs (a, b) and the scale s such that any
    depth-additive count extrapolates exactly: count(full) = count(a) +
    (count(b) − count(a)) · s. Depths start at 2, as the reference's."""
    if cfg.family == "audio":
        assert cfg.num_layers == cfg.num_encoder_layers
        a = cfg.replace(num_layers=2, num_encoder_layers=2)
        b = cfg.replace(num_layers=3, num_encoder_layers=3)
        return a, b, cfg.num_layers - 2
    if cfg.family == "hybrid":
        p = cfg.shared_attn_period
        pat = "M" * (p - 1) + "A"
        a = cfg.replace(num_layers=2 * p, layer_pattern=pat * 2)
        b = cfg.replace(num_layers=3 * p, layer_pattern=pat * 3)
        return a, b, cfg.num_layers // p - 2
    fd = cfg.moe.first_dense_layers if cfg.moe else 0
    a = cfg.replace(num_layers=fd + 2)
    b = cfg.replace(num_layers=fd + 3)
    return a, b, cfg.num_layers - fd - 2


def build_step(cfg: ModelConfig, shape: ShapeSpec, model) -> Callable:
    """The step the shape's kind runs, over ``model``: the train step
    with remat (model, opt, batch, step), the prefill step (tokens,
    vision_embeds, encoder_frames) or the decode step (tokens, cache)."""
    if shape.kind == "train":
        return make_train_step(cfg, TrainHParams(remat=True))
    if shape.kind == "prefill":
        return make_prefill_step(model, max_len=shape.seq_len)
    return make_serve_step(model)


def _step_args(cfg: ModelConfig, shape: ShapeSpec, model):
    """(positional arguments of the step, {name: argument tree})."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = adamw_init(dict(model.named_parameters()))
        return ((model, opt, specs["batch"], 0),
                {"opt": opt, "batch": specs["batch"]})
    if shape.kind == "prefill":
        return ((specs["tokens"], specs.get("vision_embeds"),
                 specs.get("encoder_frames")), {"batch": specs})
    return ((specs["tokens"], specs["cache"]),
            {"batch": {"tokens": specs["tokens"]}, "cache": specs["cache"]})


def count_step(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """Run the global step of ``cfg`` at ``shape`` once on the meta
    device → its flops, bytes accessed, peak created storage (bytes) and
    the number of aten ops, all global."""
    model = params_shape(cfg)
    args, trees = _step_args(cfg, shape, model)
    step = build_step(cfg, shape, model)
    external = [t for t in tree_flatten((trees, list(model.parameters())))[0]
                if isinstance(t, torch.Tensor)]
    acct = _Accounting(external)
    flops = flop_counter.FlopCounterMode(display=False)
    with flops, acct:
        out = step(*args)
    del out
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(acct.bytes), "temp": float(acct.peak),
            "ops": acct.ops}


def rank_model(cfg: ModelConfig, mesh, mode: str):
    """Rank 0's model of ``cfg`` on ``mesh`` (abstract), on ``meta``:
    each parameter its model-axis shard by ``mode``'s table (FSDP2
    gathers the data axes before a layer computes), run through a
    ``RecordingTP`` of the mesh's (data axes, model) sizes → (model, its
    ``RecordingTP``)."""
    sizes = dict(mesh.shape)
    n_data = 1
    for a in data_axes(mesh):
        n_data *= sizes[a]
    tp = shd.RecordingTP(make_abstract_mesh((n_data, sizes[shd.MODEL]),
                                            ("data", shd.MODEL)))
    model = params_shape(cfg)
    for name, p in list(model.named_parameters()):
        spec = shd.param_spec(reference_path(model, name), p.shape, mesh,
                              mode=mode)
        shd.set_param(model, name, shd.local_shard(
            p, spec, mesh, model_only=True).contiguous())
    model.set_tp(tp)
    return model, tp


def model_axis_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh
                     ) -> Dict[str, float]:
    """Bytes by op that rank 0's model-axis collectives move in one step
    of ``cfg`` at ``shape`` on ``mesh`` (the recording of
    ``rank_model``'s step on ``meta``; zeros on a model axis of 1): the
    train step with remat over the rank's rows of the global batch, the
    prefill step or the decode step over the global batch (the model
    takes its rows)."""
    out = {k: 0.0 for k in _COLLECTIVES}
    if dict(mesh.shape).get(shd.MODEL, 1) == 1:
        return out
    model, tp = rank_model(cfg, mesh, TRAIN_SHARDING_MODE
                           if shape.kind == "train" else "serve")
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        batch = specs["batch"]
        bspecs = shd.batch_specs(batch, mesh)
        rows = {k: shd.local_shard(v, bspecs[k], mesh)
                for k, v in batch.items()}
        opt = adamw_init(dict(model.named_parameters()))
        build_step(cfg, shape, model)(model, opt, rows, 0)
    else:
        args, _ = _step_args(cfg, shape, model)
        build_step(cfg, shape, model)(*args)
    out.update(tp.moved)
    return out


def _shard_factor(spec: shd.P, mesh) -> int:
    sizes = dict(mesh.shape)
    n = 1
    for d in range(len(spec)):
        for a in shd.spec_axes(spec, d):
            n *= sizes[a]
    return n


def _placed(tree, specs, mesh) -> float:
    """Bytes a device holds of ``tree`` under ``specs`` (the same tree
    of ``P``)."""
    leaves = tree_flatten(tree)[0]
    pspecs = tree_flatten(specs, is_leaf=lambda x: isinstance(x, shd.P))[0]
    assert len(leaves) == len(pspecs)
    return float(sum(_nbytes(t) / _shard_factor(p, mesh)
                     for t, p in zip(leaves, pspecs)
                     if isinstance(t, torch.Tensor)))


def _one_row(cache, cspecs, mesh) -> float:
    """Bytes a device writes into a decode cache at one step: one
    sequence row of each attention leaf (L, B, C, …), the state leaves
    whole."""
    total = 0.0
    for group, leaf in cache.items():
        if isinstance(leaf, dict):
            for name, t in leaf.items():
                b = _nbytes(t) / _shard_factor(cspecs[group][name], mesh)
                total += b if name in _STATE_LEAVES else b / t.shape[2]
        else:
            total += _nbytes(leaf) / _shard_factor(cspecs[group], mesh)
    return total


def placement_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh
                    ) -> Dict[str, float]:
    """Per device, from the placements at full depth: ``argument``,
    ``output``, ``min`` (inputs read once, outputs written once) and the
    FSDP collectives (``all-gather``, ``reduce-scatter``)."""
    model = params_shape(cfg)
    args, trees = _step_args(cfg, shape, model)
    mode = TRAIN_SHARDING_MODE if shape.kind == "train" else "serve"
    pspecs = shd.param_specs(model, mesh, mode=mode)
    params = dict(model.named_parameters())
    p_bytes = _placed(params, pspecs, mesh)
    b_bytes = _placed(trees["batch"], shd.batch_specs(trees["batch"], mesh),
                      mesh)
    out = {"all-gather": 0.0, "reduce-scatter": 0.0}
    if shape.kind == "train":
        opt = trees["opt"]
        ospecs = shd.opt_specs(opt, pspecs)
        o_bytes = _placed(list(opt), list(ospecs), mesh)
        moments = o_bytes - _nbytes(opt.count)
        metrics = 6 * 4                  # loss, nll, accuracy, aux, lr, norm
        out.update(argument=p_bytes + o_bytes + b_bytes, output=metrics,
                   # params and moments read and written, gradients
                   # (f32, as the parameters) written and read, the batch
                   min=2 * p_bytes + 2 * p_bytes + 2 * moments + b_bytes)
        daxes = set(data_axes(mesh))
        gathered = 0.0
        for name, p in params.items():
            spec = pspecs[name]
            keep = 1                     # the non-data shards stay split
            for d in range(len(spec)):
                for a in shd.spec_axes(spec, d):
                    if a not in daxes:
                        keep *= dict(mesh.shape)[a]
            gathered += _nbytes(p) / keep
        n_data = 1
        for a in daxes:
            n_data *= dict(mesh.shape)[a]
        out["all-gather"] = (FSDP_GATHERS_A_STEP * gathered
                             * _COLL_FACTOR["all-gather"])
        out["reduce-scatter"] = (gathered / n_data
                                 * _COLL_FACTOR["reduce-scatter"])
        return out
    if shape.kind == "prefill":
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 torch.bfloat16, device="meta")
        c_bytes = _placed(cache, shd.cache_specs(cache, mesh), mesh)
        logits = torch.empty((shape.global_batch, 1, cfg.vocab_size),
                             dtype=getattr(torch, cfg.dtype), device="meta")
        l_bytes = _placed(logits, shd.batch_specs(logits, mesh), mesh)
        out.update(argument=p_bytes + b_bytes, output=c_bytes + l_bytes,
                   min=p_bytes + b_bytes + c_bytes + l_bytes)
        return out
    cache = trees["cache"]
    cspecs = shd.cache_specs(cache, mesh)
    c_bytes = _placed(cache, cspecs, mesh)
    pos = _placed(cache["pos"], cspecs["pos"], mesh)
    out.update(argument=p_bytes + b_bytes + c_bytes,
               output=b_bytes + pos,         # next tokens, new positions
               min=p_bytes + b_bytes + c_bytes + _one_row(cache, cspecs,
                                                          mesh) + b_bytes)
    return out


def lower_combo(arch: str, shape: Union[str, ShapeSpec], *,
                mesh: Optional[Mesh] = None, multi_pod: bool = False,
                cfg: Optional[ModelConfig] = None,
                verbose: bool = True) -> Dict[str, Any]:
    """The dry-run record of one combo. ``cfg`` replaces the arch's
    published config (a smoke config, say), ``shape`` may be a
    ``ShapeSpec`` of its own; ``mesh`` defaults to the production mesh
    (``multi_pod`` for 2 × 16 × 16)."""
    spec = get_shape(shape) if isinstance(shape, str) else shape
    skip = combo_is_skipped(arch, spec.name)
    if skip:
        return {"arch": arch, "shape": spec.name, "status": "skipped",
                "reason": skip}
    cfg = adapt_config(get_config(arch) if cfg is None else cfg, spec)
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None \
        else mesh
    n_dev = mesh.size
    cfg_a, cfg_b, scale = depth_variants(cfg)
    t0 = time.perf_counter()
    ca = count_step(cfg_a, spec)
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    cb = count_step(cfg_b, spec)
    tb = time.perf_counter() - t0

    def extrap(k):
        return ca[k] + (cb[k] - ca[k]) * scale

    t0 = time.perf_counter()
    ma = model_axis_bytes(cfg_a, spec, mesh)
    mb = model_axis_bytes(cfg_b, spec, mesh)
    t_model = time.perf_counter() - t0
    model_axis = {k: ma[k] + (mb[k] - ma[k]) * scale for k in _COLLECTIVES}
    placed = placement_bytes(cfg, spec, mesh)
    flops = extrap("flops") / n_dev
    temp = extrap("temp") / n_dev
    hw = hardware()
    peak = (hw["peak_bf16_flops"] if cfg.dtype == "bfloat16"
            else hw["peak_f32_flops"])
    coll = dict(model_axis)
    if spec.kind == "train":
        coll["all-gather"] += placed["all-gather"]
        coll["reduce-scatter"] += placed["reduce-scatter"]
    result = {
        "arch": arch,
        "shape": spec.name,
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "n_devices": n_dev,
        "status": "ok",
        "device": "meta",
        "variant_count_s": [round(ta, 2), round(tb, 2)],
        "variant_aten_ops": [ca["ops"], cb["ops"]],
        "depth_extrapolation_scale": scale,
        "flops_per_device": flops,
        "flops_note": "matmul-class operations by FlopCounterMode, the "
                      "global step / (data x model); element-wise "
                      "operations not counted",
        "bytes_accessed_per_device": extrap("bytes") / n_dev,
        "bytes_min_per_device": placed["min"],
        "collective_bytes_per_device": coll,
        "model_axis_collective_bytes_per_device": model_axis,
        "model_axis_count_s": round(t_model, 2),
        "collective_note": "by op, the reference's ring factors (output "
                           "bytes x 2 an all-reduce, x 1 an all-gather or "
                           "reduce-scatter): FSDP2's all-gathers (2 a "
                           "step) and gradient reduce-scatter over the "
                           "data axes in the train modes, from the "
                           "placements, plus the model-axis collectives "
                           "of the tensor-parallel layers, recorded on "
                           "rank 0's step on meta (train: forward, remat's "
                           "recompute and the backward's conjugates; "
                           "prefill and decode: the forward)",
        "memory": {
            "argument_bytes": placed["argument"],
            "output_bytes": placed["output"],
            "temp_bytes": temp,
            "temp_note": "estimate: peak of the meta storage the global "
                         "step created and held, / (data x model)",
        },
        "fits": placed["argument"] + temp <= hw["hbm_bytes"],
        "roofline_s": max(flops / peak, placed["min"] / hw["hbm_bw"]),
        "roofline_peak_flops": peak,
        "hardware": {"name": hw["name"],
                     "power_limit_w": hw["power_limit_w"]},
        "sliding_window": cfg.sliding_window,
    }
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    combos = ([(args.arch, args.shape)] if not args.all else
              [(a, s) for a in ARCH_IDS for s in sorted(INPUT_SHAPES)])
    failures = []
    for arch, shape in combos:
        tag = f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag}", flush=True)
        try:
            res = lower_combo(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "status": "error",
                   "error": str(e)[:2000]}
            failures.append(tag)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
