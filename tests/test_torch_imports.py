"""Import hygiene of the PyTorch port: every module of ``repro_torch``
(kernels, core, models, configs, data, serving, launch) and the imports
of ``chip_smoke.py`` load neither JAX nor anything of the reference
package ``repro``, and the entry points (the session manager, the façade,
the MEM model, the serving model) refuse to run on the CPU unless
asked."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import ast, importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
tree = ast.parse(open(sys.argv[1]).read())
for node in ast.walk(tree):                   # chip_smoke.py's own imports
    if isinstance(node, ast.ImportFrom) and node.module:
        importlib.import_module(node.module)
    elif isinstance(node, ast.Import):
        for alias in node.names:
            importlib.import_module(alias.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
import torch
from repro_torch.configs.venus_mem import smoke_config
from repro_torch.core.session import SessionManager, VenusConfig
from repro_torch.core.pipeline import VenusSystem
from repro_torch.models.mem import MEM
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import init_model
for name in ("repro_torch.serving.engine",
             "repro_torch.serving.venus_service",
             "repro_torch.kernels.decode_attention",
             "repro_torch.launch.serve"):
    assert name in names, name
if not torch.cuda.is_available():
    for make in (lambda: SessionManager(VenusConfig(), None, 8),
                 lambda: VenusSystem(VenusConfig(), None, 8),
                 lambda: MEM.init(smoke_config()),
                 lambda: init_model(get_smoke_config("qwen2-vl-7b"))):
        try:
            make()
        except RuntimeError as e:
            assert "device='cpu'" in str(e), e
        else:
            raise SystemExit("an entry point ran without a card")
print("raises-ok")
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    n_modules, bad = lines[0].split(" ", 1)
    assert int(n_modules) >= 38       # serving/ and launch/ included
    assert bad == "[]", bad
    assert lines[-1] == "raises-ok"
