"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers: the reference's ten architectures."""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

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
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-base": "whisper_base",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS: List[str] = sorted(_ARCH_MODULES)

# (arch, shape) combinations skipped by design, as in the reference
SKIPPED_COMBOS = {
    ("whisper-base", "long_500k"): (
        "enc-dec audio model: no 524k-token decoder-stream analogue"),
}


def _module(arch: str):
    try:
        mod = _ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def combo_is_skipped(arch: str, shape: str) -> Optional[str]:
    return SKIPPED_COMBOS.get((arch, shape))
