"""qwen2-72b [dense] — arXiv:2407.10671.

80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=29568,
vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, d_ff=512,
        vocab_size=512, param_dtype="float32", compute_dtype="float32",
        remat=False)
