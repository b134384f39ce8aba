"""gemma3-12b [dense] — hf:google/gemma-3-1b-pt family (12B scale).

48 layers, d_model=3840, 16 heads (GQA kv=8, head_dim=256), d_ff=15360,
vocab=262144, 5:1 local(1024-token sliding window):global attention,
128k context. Layers repeat in 8 groups of (5 local + 1 global).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    act="gelu",
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, sliding_window=8,
        global_every=2, param_dtype="float32", compute_dtype="float32",
        remat=False)
