from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.configs.registry import (ARCH_IDS, LONG_CONTEXT_SKIP,
                                          get_config, get_smoke_config,
                                          input_specs, supports_shape)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_SKIP", "ModelConfig",
           "get_config", "get_smoke_config", "input_specs",
           "supports_shape"]
