from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model", "params_from_jax"]
