"""r2l_tpu_torch — the PyTorch/CUDA port of ``r2l_tpu``.

The JAX package ``r2l_tpu`` is the reference: every function here names the
``r2l_tpu`` function it reproduces, and ``tests/test_torch_*.py`` hold the
two to the same output on the same inputs. This package never imports JAX.

Nine slices are ported, through hand-written CUDA kernels for the NVIDIA
H100 (``kernels/csrc/*.cu``) where the JAX package has a Pallas kernel:

1. The R2L student's novel-view frame: camera pose ->
   ``PointSampler.sample_test`` -> positional encoding -> deep residual MLP
   -> RGB frame (``evaluate.make_r2l_frame_fn``), through a PE-fused
   bf16/f32 forward (K1) and a static-scale int8 forward (K2); the same
   chain on an input encoded outside is the exported kernel API
   (``kernels.fused_r2l_apply``, K9).
2. R2L distillation training, rays mode (``train.make_distill_step``): the
   fused training forward with its stash (K3; int8 K4 with an int8 stash,
   K8 with a bf16 one) and the backward through a block group (K5).
3. The NeRF teacher's volumetric render and pseudo-data generation
   (``render.render_frame_nerf_fused``, ``datagen.generate_pseudo_data``,
   ``evaluate.make_nerf_frame_fn``): the whole volumetric pass of a chunk of
   rays (points, encoding, the MLP, alpha compositing) in one kernel, f32/bf16
   weights (K6) or static-scale int8 (K7).
4. The rest of training: teacher training (``train.make_teacher_step``,
   ``train.make_teacher_step_batched``) and images-mode distillation
   (``train.make_distill_step_images``), plain autograd as in JAX.
5. The tensor-core probes of the JAX package's ``exp/`` (``exp.probe_mxu``,
   ``exp.probe_shapes``): the 86-layer W256 chain with a full, lean or no
   epilogue, single or as two warp groups in flight, at N=512 and in
   static-scale int8, and 64 products by shape and dtype, on K1's and K2's
   wgmma chains (``kernels/csrc/probe_hopper.cuh``); runners that time them
   by the probes' protocol. Only the instrument that reads how mma.sync
   rounds (``probe_shapes.mma_rounding``) keeps the pre-Hopper bf16 engine
   (``kernels/csrc/r2l_engines.cuh``).
6. The probes of K2's int8 engine (``exp.probe_int8``, ``exp.probe_wall``,
   ``exp.probe_pipe_lib`` with its driver ``exp.probe_pipe``,
   ``exp.probe_epi``): its ResMLP body with the requantize folded or not,
   two tiles in flight and a bf16 control; the bare product rate and a
   minimal cast; K2 with its ray tile in S streams; K2 with three requantize
   epilogues. The body and wall probes run K2's wgmma s8 chain
   (``kernels/csrc/probe_hopper.cuh``); the streams and the epilogues are
   forms of K2's Hopper kernel (``kernels/csrc/r2l_int8_hopper.cuh``, wgmma
   s8), which also takes the reference's ``fold_requant``/``nobf16_inner``
   flags.
7. The frame path's remainder and evaluation, through kernels ported above:
   the DONeRF given-rays frames and their bench (K1, K2), the teacher's
   benchmark (K6, K7), and the eval loop (``evaluate.render_path``,
   ``evaluate.render_path_given_rays``) with SSIM (``metrics``), FLIP
   (``flip``) and LPIPS (``lpips``) in plain PyTorch.
8. Checkpoints, full-state resume and export (``checkpoint``, ``export``,
   ``onnx_writer``, ``tools.export_torch_ckpt``): the JAX package's msgpack
   files, byte for byte, and the reference's ``.tar`` files, read and
   written; loaded weights reach the kernels above through the module.
9. The command line (``app``, ``configs``, ``logging_``, ``flops``, the
   dataset loaders under ``data/`` with their own PNG decoder, the datagen
   modes): ``main_cuda.py``, ``tools.create_data`` and
   ``tools.verify_released_ckpt``, on the card unless ``--platform cpu``.

On CPU tensors each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
