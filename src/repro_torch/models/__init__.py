"""Models of the port: the dense GPT-2 decoder for serving."""
from repro_torch.models.model_api import Model, build_model, params_from_jax

__all__ = ["Model", "build_model", "params_from_jax"]
