"""Build and load the port's CUDA C++ kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). Builds happen at
first use, into ``repro_torch/_build/`` (listed in ``.gitignore``), keyed
by a hash of the source and the shared headers (``csrc/*.cuh``) so an
edited kernel is rebuilt. ``build_all`` starts one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("fused_retrieve.cu", "similarity_scan.cu", "similarity_scan_2d.cu",
           "decode_attention.cu", "mla_decode.cu", "scene_score.cu",
           "cluster.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# what nvcc said for each source (ptxas register/shared-memory report)
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return cand


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start(source: str):
    """Start nvcc for ``source`` unless its library is already built;
    returns (library path, temporary output path, process or None)."""
    path = _lib_path(source)
    if os.path.exists(path):
        return path, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish(source: str, path: str, tmp: str, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    BUILD_LOG[source] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{out}")
    os.replace(tmp, path)           # atomic: readers never see a half file


def build_all() -> Dict[str, str]:
    """Compile every source in parallel (one nvcc each); returns the
    library path of each source."""
    started = {s: _start(s) for s in SOURCES}
    for s, started_s in started.items():
        _finish(s, *started_s)
    return {s: v[0] for s, v in started.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        path, tmp, proc = _start(source)
        _finish(source, path, tmp, proc)
        lib = _LIBS[source] = ctypes.CDLL(path)
    return lib
