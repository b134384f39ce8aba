"""Model configuration: the port's copy of ``repro.configs.base``.

``ModelConfig`` keeps the reference's fields, ``head_dim_``,
``param_count`` and ``replace``; the dtype properties return
``torch.dtype``s. There is no ``use_decode_kernel`` flag: on CUDA the
Hopper decode kernel is the path (``kernels.ops`` dispatches by the
tensors' device).

Input shapes (the reference's four, read by ``launch.dryrun``):

    train_4k      seq_len=4096    global_batch=256   (train step)
    prefill_32k   seq_len=32768   global_batch=32    (prefill)
    decode_32k    seq_len=32768   global_batch=128   (serve step, 1 token)
    long_500k     seq_len=524288  global_batch=1     (serve step, 1 token)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

INPUT_SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a dtype name ("float32", "bfloat16", ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of "
                         f"{tuple(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "unnamed"
    family: str = "dense"
    source: str = ""                   # citation (paper / model card)

    # transformer backbone
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None     # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"                  # silu (swiglu) | gelu
    norm: str = "rmsnorm"              # rmsnorm | layernorm (whisper)

    # attention pattern
    sliding_window: Optional[int] = None   # window for local layers
    global_every: int = 0          # gemma3: 1 global per N (0=all global)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2)
    attn_every: int = 0                # shared attn block every N mamba blocks

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0               # frames from the (stubbed) frontend

    # vlm (llama-3.2-vision)
    cross_attn_every: int = 0          # gated cross-attn every N layers
    num_image_tokens: int = 0

    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True

    # serving / decode
    kv_cache_dtype: Optional[str] = None   # KV pool storage (None=compute)

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim \
            else self.d_model // self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def kv_dtype(self) -> torch.dtype:
        return torch_dtype(self.kv_cache_dtype or self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # approximate parameter counts (for roofline MODEL_FLOPS = 6·N·D)
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        if self.family == "ssm":
            per = self._mamba_block_params()
            n = self.num_layers * per + v * d + d
            return n
        att = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        mlp = 3 * d * f if self.act == "silu" else 2 * d * f
        if self.num_experts:
            e = self.experts_per_token if active_only else self.num_experts
            mlp = e * (3 * d * f) + d * self.num_experts  # experts + router
        per = att + mlp + 2 * d
        n = self.num_layers * per + v * d + d
        if self.family == "hybrid":
            per_m = self._mamba_block_params()
            n = self.num_layers * per_m + (att + 2 * d) + v * d + d
        if self.family == "encdec":
            enc_per = att + mlp + 2 * d
            dec_per = 2 * att + mlp + 3 * d   # self + cross
            n = self.encoder_layers * enc_per + self.num_layers * dec_per \
                + v * d + d
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            n += n_cross * (att + 2 * d)
        if not self.tie_embeddings:
            n += v * d
        return int(n)

    def _mamba_block_params(self) -> int:
        d, di, n = self.d_model, self.ssm_d_inner, self.ssm_state
        h = self.ssm_num_heads
        in_proj = d * (2 * di + 2 * n + h)   # z, x, B, C, dt
        conv = (di + 2 * n) * self.ssm_conv_width
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * h + di + 2 * d
