"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38 Mamba2 blocks, d_model=2048, ssm_state=64, with ONE weight-shared
attention(+MLP) block (32 heads, kv=32, d_ff=8192) applied every 6
mamba blocks; vocab=32000. Layout: 6 groups of (6 mamba + shared attn)
+ 2 trailing mamba blocks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
        attn_every=2, param_dtype="float32", compute_dtype="float32",
        remat=False)
