"""whisper-large-v3 [audio] — arXiv:2212.04356.

Encoder–decoder: 32 encoder + 32 decoder layers, d_model=1280, 20 heads
(kv=20), d_ff=5120, vocab=51866, LayerNorm + GELU. The mel-spectrogram +
conv frontend is a STUB: ``batch["extra_embeds"]`` carries 1500
precomputed frame embeddings of width d_model
(``models.registry.extra_embed_shape``). Positions use RoPE, as in the
JAX package.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="encdec",
    source="arXiv:2212.04356",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    act="gelu",
    norm_eps=1e-5,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, encoder_layers=2, encoder_seq=24, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
