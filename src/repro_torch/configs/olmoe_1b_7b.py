"""olmoe-1b-7b [moe] — arXiv:2409.02060.

16 layers, d_model=2048, 16 heads (kv=16 — full MHA), 64 experts top-8
with per-expert d_ff=1024, vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                # per-expert intermediate
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=512, num_experts=4, experts_per_token=2,
        param_dtype="float32", compute_dtype="float32", remat=False)
