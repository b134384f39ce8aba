"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch).

32 layers, d_model=4096, 32 heads (kv=32 — full MHA), d_ff=13440,
vocab=92416, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, param_dtype="float32", compute_dtype="float32",
        remat=False)
