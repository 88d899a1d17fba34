"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers. It lists the architectures the port runs; the reference's
other ids raise ``NotImplementedError`` until their slices land."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module under repro_torch.configs
_ARCH_MODULES: Dict[str, str] = {
    "deepseek-7b": "deepseek_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "glm4-9b": "glm4_9b",
    "minicpm3-4b": "minicpm3_4b",
    "nemotron-4-15b": "nemotron4_15b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS: List[str] = sorted(_ARCH_MODULES)

# the reference's other architectures: not yet ported nor held against it
LATER_ARCH_IDS = ("rwkv6-1.6b", "whisper-base", "zamba2-2.7b")


def _module(arch: str):
    if arch in LATER_ARCH_IDS:
        raise NotImplementedError(
            f"{arch!r} belongs to a later slice of the port (ROADMAP.md); "
            f"ported: {ARCH_IDS}")
    try:
        mod = _ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
