"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-0.5B family (3B scale).

36 layers, d_model=2048, 16 heads (GQA kv=2), d_ff=11008,
vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, param_dtype="float32", compute_dtype="float32",
        remat=False)
