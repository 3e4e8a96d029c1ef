"""Hand-written CUDA kernels for the NVIDIA H100 (``csrc/``), with their
PyTorch wrappers and plain versions (``r2l_fused.py``, ``r2l_train.py``,
``nerf_render.py``) and the nvcc build (``_build.py``). Counterpart of
``r2l_tpu/kernels``, whose exported API this package exports too."""
from .r2l_fused import fused_r2l_apply, prepare_fused_params

__all__ = ["fused_r2l_apply", "prepare_fused_params"]
