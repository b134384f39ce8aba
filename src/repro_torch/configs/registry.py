"""Architecture registry of the port.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve the
ported architectures. The reference lists ten ids; the ones whose
family is not ported yet raise ``NotImplementedError``.
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
}

NOT_PORTED = ("llama-3.2-vision-11b", "whisper-large-v3")

ARCH_IDS = tuple(ARCH_MODULES)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r}: not ported yet, see ROADMAP")
    if arch_id not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; one of "
                         f"{ARCH_IDS + NOT_PORTED}")
    return importlib.import_module(ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
