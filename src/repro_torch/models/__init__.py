from repro_torch.models.convert import (jax_template, params_from_jax,
                                        params_to_jax)
from repro_torch.models.registry import Model, extra_embed_shape, get_model

__all__ = ["Model", "extra_embed_shape", "get_model", "jax_template",
           "params_from_jax", "params_to_jax"]
