"""Models of the port: the decoder-only families and the encoder-decoder,
for training and serving."""
from repro_torch.models.model_api import (Model, build_model, enc_len_for,
                                          opt_state_from_jax, params_from_jax,
                                          train_state_from_jax,
                                          train_state_to_numpy)

__all__ = ["Model", "build_model", "enc_len_for", "opt_state_from_jax",
           "params_from_jax", "train_state_from_jax", "train_state_to_numpy"]
