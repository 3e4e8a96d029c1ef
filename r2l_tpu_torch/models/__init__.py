"""Student model (``r2l_tpu/models``): the R2L residual-MLP light field."""
from .r2l import R2L, R2LConfig, init_r2l, params_from_jax, r2l_num_blocks

__all__ = ["R2L", "R2LConfig", "init_r2l", "params_from_jax",
           "r2l_num_blocks"]
