"""Architecture registry of the port.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve the
reference's ten architecture ids; an unknown id raises ``ValueError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return importlib.import_module(ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
