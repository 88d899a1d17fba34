"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; compared whole, so
``repro_torch`` is not it), and a reference that loads nothing of the
program either."""

import glob
import json
import os
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    running ``code`` from the checkout's root."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(
        ROOT, "src")]))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(kind: str):
    return sorted(os.path.basename(p)[:-3] for p in
                  glob.glob(os.path.join(harness.HERE, kind, "*.py"))
                  if not p.endswith("__init__.py"))


def test_harness_and_program_load_no_jax():
    code = "\n".join(
        ["from perfbench import harness, serving, control",
         "import perfbench.run"]
        + [f"harness.load_module('{k}', '{n}')" for k in
           ("drivers", "metrics", "systems", "checks")
           for n in _modules(k)]
        + ["from perfbench.systems import vlm_service, venus_ingest",
           "import repro_torch.serving.venus_service, "
           "repro_torch.core.pipeline, repro_torch.models.mem"])
    loaded = _loaded(code)
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = "\n".join(f"import perfbench.reference.{n}"
                     for n in _modules("reference"))
    loaded = _loaded(code)
    assert not loaded & (set(harness.FORBIDDEN) | {"repro_torch"}), loaded
