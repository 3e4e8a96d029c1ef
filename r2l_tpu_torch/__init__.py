"""r2l_tpu_torch — the PyTorch/CUDA port of ``r2l_tpu``.

The JAX package ``r2l_tpu`` is the reference: every function here names the
``r2l_tpu`` function it reproduces, and ``tests/test_torch_*.py`` hold the
two to the same output on the same inputs. This package never imports JAX.

The first slice is the R2L student's novel-view frame:

  camera pose -> ``PointSampler.sample_test`` (evenly spaced points per ray)
  -> positional encoding -> deep residual MLP -> RGB frame

through hand-written CUDA kernels for the NVIDIA H100
(``kernels/csrc/*.cu``): a PE-fused bf16/f32 forward and a PE-fused
static-scale int8 forward. On CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
