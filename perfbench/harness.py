"""One run of one cell: find the cell's files by name, run its driver,
read its metrics, print the result line.

A driver (``drivers/<traffic's driver>.py``) builds the program, warms
it, runs the window and, once the window has closed and the program's
state is freed, compares what the window produced with the plain
reference. It returns a ``Record``; each metric named in
``BENCHMARK.json`` for the cell is read from it by
``metrics/<name>.py``, whose ``read(record)`` gives a number or None
(nothing to read: the metric is left out)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Check:
    """A number compared against its limit: correct while value ≤
    limit. A check that is not ``judged`` is printed and does not
    decide ``correct``."""
    name: str
    value: float
    limit: float
    judged: bool = True

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def compare(limits: dict, program: dict, control: Optional[dict] = None,
            prefix: str = "") -> List[Check]:
    """Each number against ``limits[name]``. With ``control`` (the
    reference a precision below, put in the program's place) the
    control's numbers are the ones judged, and the program's stay beside
    them, unjudged, as ``program.<name>``."""
    judged = program if control is None else control
    out = [Check(prefix + k, float(v), float(limits[k]))
           for k, v in judged.items()]
    if control is not None:
        out += [Check(f"program.{prefix}{k}", float(v), float(limits[k]),
                      judged=False) for k, v in program.items()]
    return out


@dataclass
class Record:
    cfg: dict
    traffic: dict
    setup_s: float
    t0: float                       # the window, host clock
    t1: float
    attempted: int
    failed: int
    obs: Dict[str, Any]
    spans: Any
    trace: Any
    memory_peak_bytes: int
    checks: List[Check] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, by file (names may hold
    dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"perfbench.{kind}.{name.replace('.', '__').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, man: Optional[dict] = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(cell_name: str, trace: bool, man: dict) -> List[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in man[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def result(cell_name: str, rec: Record, trace: bool, man: dict,
           device: dict) -> dict:
    metrics = {}
    for m in metrics_for(cell_name, trace, man):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    judged = [c for c in rec.checks if c.judged]
    out = {"correct": all(c.ok for c in judged) and bool(judged),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        out["breakdown"] = {
            "device_ops": rec.trace.top_ops(rec.t0, rec.t1),
            "idle_gaps": rec.trace.idle_by_span(rec.spans, rec.t0, rec.t1)}
    out["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                       for c in rec.checks}
    return out


def run_cell(cell_name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float, man: Optional[dict] = None,
             cfg: Optional[dict] = None, traffic: Optional[dict] = None,
             control: bool = False) -> Record:
    """Run the cell's driver; ``cfg`` and ``traffic`` replace the files
    (the CPU tests' small sizes); ``control`` judges the control's
    readings in the program's place (``compare``; ``control.py``, no
    benchmark run asks for it)."""
    man = man or manifest()
    w = cell(cell_name, man)
    cfg = cfg or load_json("configs", f"{w['config']}.json")
    traffic = traffic or load_json("traffic", f"{w['traffic']}.json")
    driver = load_module("drivers", traffic["driver"])
    return driver.run(cfg, traffic, seed=seed, seconds=seconds, trace=trace,
                      device=device, t_start=t_start, control=control)


def main(args, t_start: float) -> int:
    import torch
    man = manifest()
    w = cell(args.workload, man)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"perfbench: {args.workload} needs {w['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 2
    rec = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=t_start, man=man)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"],
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if args.trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s(rec.t0, rec.t1)
        device["window_s"] = rec.window_s
    out = result(args.workload, rec, bool(args.trace), man, device)
    for c in rec.checks:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
