"""Hand-written CUDA kernels for the NVIDIA H100 (``csrc/``), with their
PyTorch wrappers and plain versions (``r2l_fused.py``) and the nvcc build
(``_build.py``). Counterpart of ``r2l_tpu/kernels``."""
