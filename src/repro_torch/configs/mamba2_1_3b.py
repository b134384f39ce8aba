"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD, state-space duality).

48 Mamba2 blocks, d_model=2048 (attention-free), ssm_state=128,
d_inner = 2·2048 = 4096, head_dim 64 → 64 SSD heads; vocab=50280.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, vocab_size=512, ssm_state=16,
        ssm_head_dim=32, ssm_chunk=8, param_dtype="float32",
        compute_dtype="float32", remat=False)
