"""Models (``r2l_tpu/models``): the R2L residual-MLP light field (student)
and the NeRF MLP (teacher)."""
from .nerf import (NeRF, NeRFConfig, init_nerf, nerf_params_from_jax,
                   nerf_params_to_jax)
from .r2l import (R2L, R2LConfig, init_r2l, params_from_jax, params_to_jax,
                  r2l_num_blocks)

__all__ = ["NeRF", "NeRFConfig", "R2L", "R2LConfig", "init_nerf",
           "init_r2l", "nerf_params_from_jax", "nerf_params_to_jax",
           "params_from_jax", "params_to_jax", "r2l_num_blocks"]
