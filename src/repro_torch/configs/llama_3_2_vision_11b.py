"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40 self-attn layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=128256; gated cross-attention adapter layers every 5th layer
(8 cross blocks) attending to stubbed vision-encoder patch embeddings
(1600 tokens ≈ 4 tiles × 400 patches, projected to d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    num_image_tokens=1600,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, cross_attn_every=2, num_image_tokens=12,
        param_dtype="float32", compute_dtype="float32", remat=False)
