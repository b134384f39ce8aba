"""Architecture registry of the port.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve the
reference's ten architecture ids; an unknown id raises ``ValueError``.
``input_specs(cfg, shape_name)`` gives meta-device stand-ins of every
model input of an input shape (``launch.dryrun``; nothing allocated),
and ``supports_shape`` says which (arch, shape) pairs run: long_500k
needs sub-quadratic attention, so the pure full-attention decoders skip
it with the reference's reasons (:data:`LONG_CONTEXT_SKIP`).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig

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

# why long_500k is skipped for pure full-attention archs
LONG_CONTEXT_SKIP = {
    "llama-3.2-vision-11b": "pure full-attention decoder (cross-attn adds "
                            "no windowing); no sub-quadratic variant",
    "whisper-large-v3": "full-attention decoder; architecture caps at 448 "
                        "decoder positions",
    "codeqwen1.5-7b": "pure full-attention decoder",
    "qwen2-72b": "pure full-attention decoder",
    "qwen2.5-3b": "pure full-attention decoder",
    "qwen3-moe-30b-a3b": "full-attention decoder (MoE is FFN-level)",
    "olmoe-1b-7b": "full-attention decoder (MoE is FFN-level)",
}


def _module(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return importlib.import_module(ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def supports_shape(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, input-shape) pair."""
    if shape_name == "long_500k" and cfg.arch_id in LONG_CONTEXT_SKIP:
        return False, LONG_CONTEXT_SKIP[cfg.arch_id]
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every model input of the shape:

    train / prefill: {tokens, labels (train), extra_embeds (vlm, encdec)}
    decode:          {tokens [B, 1], pos}, the KV cache being built from
                     the params (``Model.init_cache``)

    Tokens, labels and ``pos`` are int32; ``extra_embeds`` (the vlm's
    ``num_image_tokens``, the encdec's ``encoder_seq`` frames) are in
    ``cfg.cdtype``."""
    spec = INPUT_SHAPES[shape_name]
    b, s, kind = spec["global_batch"], spec["seq_len"], spec["kind"]

    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if kind == "decode":
        out["tokens"] = sd((b, 1), torch.int32)
        out["pos"] = sd((), torch.int32)
    else:
        out["tokens"] = sd((b, s), torch.int32)
        if kind == "train":
            out["labels"] = sd((b, s), torch.int32)
    if cfg.family == "vlm":
        out["extra_embeds"] = sd((b, cfg.num_image_tokens, cfg.d_model),
                                 cfg.cdtype)
    elif cfg.family == "encdec":
        out["extra_embeds"] = sd((b, cfg.encoder_seq, cfg.d_model),
                                 cfg.cdtype)
    return out
