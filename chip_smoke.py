#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's student frame path and kernel API, its
distillation steps, the NeRF teacher's pseudo-data generation, teacher
training, the tensor-core probes, the given-rays frames, evaluation and
benchmarks, checkpoints, resume and export, and the command line on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), refuse without CUDA.
2. Build: compile the fifteen CUDA libraries from ``r2l_tpu_torch/kernels/
   csrc`` into ``build/`` in parallel and print the build time and the
   compiler's register report.
3. Kernel vs plain version on the card, at the main path's shape (one
   400x400 lego frame of the canonical W256/D88 student, random weights from
   a seeded generator): K1 with f32 and with bf16 weights, K2 (int8), and K9
   (``fused_r2l_apply`` on the frame's ``r2l_embed``-encoded rays) with f32
   and bf16 weights, each against its plain PyTorch version; K2's three
   forms bit for bit on the frame, and at W64 and W128 (8-layer students on
   the frame's first 20,000 rays); then K2 on the frozen int8 canary
   (``tests/fixtures/int8_epilogue_canary*.npz``). Times each kernel and
   its plain version with CUDA events; beside K1/K2/K9 their bound (f32:
   the 3xTF32 one they follow and the CUDA cores' f32 one) and the weight bytes their design
   reads from L2 in the frame.
4. Main path: ``make_r2l_frame_fn`` and ``make_r2l_bench_fn`` at 400x400 for
   the kinds ``jnp`` (plain module, bf16), ``pe`` and ``int8``; K frames per
   kind, ms/frame from CUDA events, PSNR of each kernel kind's frames against
   the ``jnp`` frames, and the kernels' launch counts in that run. Then the
   exported kernel API (``kernels.prepare_fused_params`` and
   ``kernels.fused_r2l_apply`` on ``r2l_embed(sample_test(pose))``), bf16
   and f32 weights: ms/frame, PSNR against the ``jnp`` frames, K9 launches.
   Then the frame at the CLI's default compute dtype (f32:
   ``make_r2l_frame_fn``, kind ``pe``, K1 f32) on 4 poses: ms/frame, PSNR
   against the plain f32 frames, K1 launches.
5. Training kernels vs plain versions on the card, at one canonical
   distillation step's 81,920 rays (``sample_train`` of synthetic rays with
   stratified depths), each reading its image staged as a step stages it:
   K3 (``train_fwd``) with f32 and bf16 weights, rgb and every stash row,
   and for f32 (3xTF32, each weight stage summed apart) the share of
   ``TOL_TRAIN_F32`` that rgb and every row use, for the canonical weights
   and three more seeds (``[margin]`` lines); K4 (``train_fwd_int8``,
   ``stash_q=True``), rgb and the stash q-values that differ; K8
   (``stash_q=False``), rgb and every bf16 stash row; K4 and K8 also how
   many outputs differ at all (their design is bit for bit); the new
   kernels' registers and spills; K5 (``bwd_group``) with f32 and bf16
   weights, the int8
   stash, and K8's bf16 stash under bf16 and under f32 weights, one 4-block
   group and the whole body walk, K5 reading its weights from one image
   staged per kind (``stage_bwd_weights``, as a training step stages it);
   under f32 weights (3xTF32) the walk's margin: the kernel's and the plain
   walk's (dh, dW, db) against float64, and the walk against plain for
   three more seeds of the weights and dh. Times each kernel and its plain
   version with CUDA events (K3 f32 and K5 with their operations bound,
   f32's as 3xTF32, K5 with the bytes bound of its scratch design; the
   per-step staging of each image, and K3's packing and K4's calibration
   with it), and
   profiles one 4-block call of K5 on the int8 stash and of the int8-dL/dx
   probe's kernel (phase 14) on the same inputs, kernel time by name.
6. Training main path: synthetic ray shards (100 x 4096 rays, record dim 9)
   written with ``write_ray_shards`` into a temporary directory and read
   back through ``RayShardDataset``/``RayBatchLoader``; for the kinds
   ``xla``, ``fused``, ``fused_int8`` and ``fused_int8_bf16stash``
   (``fused_stash_q=False``), in bf16, and ``fused_f32`` (``fused`` at the
   CLI's default compute dtype, f32), canonical W256/D88 distillation
   steps through ``make_distill_step`` with the README's flags (81,920 rays,
   hard ratio 0.2, hard_mul 20, warm-up 0.0001 over 200 steps): 2 warm-up
   steps then 10 timed ones (CUDA events), the loss falling, the first
   step's loss of the bf16 fused kinds against ``xla``'s on the same
   params,
   batch and draws, two copies of a fused state run 3 steps bit-identical,
   the peak device memory, one more step under torch.profiler (kernel time
   by name and the card's idle share), and the K3/K4/K8/K5 launch counts in
   that run, per kind (each fused kind's forward once a step: 19).
7. Teacher kernels vs plain versions on the card: the canonical NeRF teacher
   (8x256, skip at 4, viewdirs, L=10/4; random weights from a seeded
   generator, alpha_linear's bias raised by 1 so the density is positive),
   a random datagen pose's 160,000 rays in the render's five padded
   32,768-ray chunks, each with a coarse pass (S=64, stratified) and a
   fine pass (S=192, sorted depths from sample_pdf): K6 with f32 and with
   bf16 weights, K7 (int8, folded requantize), every output of the ten
   launches against the plain version's, then the ten timed back to back
   (CUDA events), kernel and plain; beside each, its bound (K6 f32: the
   3xTF32 bound it follows and the CUDA cores' f32 one), the weight bytes
   its design reads from L2 in the frame, and its registers, spills (the
   build log) and shared memory per block.
8. Datagen main path: ``generate_pseudo_data`` (``rand`` mode, the README's
   teacher: 64 + 128 samples, perturb, white background, chunk 32768,
   400x400 poses, focal 555.555 x U[1, 2)) into a temporary directory per
   kind: ``f32`` (the default), ``bf16``, ``int8`` (``quantize='int8'``);
   one warm-up pose then timed poses (CUDA events around them), the shard
   names and shapes, the K6/K7 launches, the peak memory, and the first
   pose's rgb column against ``render_frame_nerf`` (plain, f32) on the same
   rays and draws (PSNR).
9. Teacher frame: ``make_nerf_frame_fn(use_pallas=True)`` on 2 lego poses
   against the plain path: ms/frame and PSNR.
10. Teacher training (plain autograd, no kernel, as in JAX) at
   ``configs/lego.txt`` on 16 ray-traced 400x400 views of a coloured sphere
   (no dataset exists): ``make_teacher_step`` (the canonical teacher, random
   weights from seeded generators, with the density floor), 2 warm-up then
   20 timed steps (CUDA events), the MSE of fixed evaluation rays falling
   from before the first step to after the last, the peak memory; then
   ``make_teacher_step_batched`` with fern's training flags on the same
   images' ray pool (``datagen.images_to_ray_records``, shuffled; NDC off,
   the poses are not forward-facing).
11. Images-mode distillation: ``make_distill_step_images`` with the
   README's images flags (and the rays command's learning-rate warm-up) on
   the same images and poses, 2 warm-up then 30 timed steps, the loss
   falling from the first pass over the images to the second, the peak
   memory.
12. The exp/ probes (``r2l_tpu_torch.exp``) at their own sizes: the chain
   (``probe_mxu.chain``, on wgmma since its redesign) in modes full, lean
   and none, each single and dual (dual bit for bit the single), 163,840
   rays x 86 layers and, where the random chain's output is of order one,
   8 layers, timed on its weights staged once (and the staging beside);
   ``bign`` (on wgmma since its redesign), 43 and 4 pairs, each reading
   printed with its share of the limit; ``int8_chain`` (on wgmma since its
   redesign) at 4 and 8 layers (non-zero, bit for bit) and at 86; both
   timed on their images staged once (and the staging beside);
   ``probe_shapes.unchained`` (on wgmma since its redesign) at every
   (M, K, N) of its runner in int8 and bf16, free, and chained at the
   square ones; each against its plain version on the card, timed with it
   (and beside the library call: ``torch.matmul`` of the 64 bf16 products,
   ``torch._int_mm`` of the 64 int8 ones). The chained bf16 shapes at 4
   layers print the share of rows that differ beside the same share for
   the plain version with its channels permuted and for plain versions
   summed in the kernel's k order (16-channel wgmma steps, and 64-channel
   stages), and one mma.sync's and one wgmma's f32 result against the
   round-to-nearest of its exact sum, each held to the truncation of
   ROADMAP C and wgmma's reading to mma.sync's; the mma.sync instrument
   (``probe_shapes.mma_sync_sum``) is first held against the plain version
   at the runner's first bf16 shape.
   Then the two runners as a user runs them (``probe_mxu.main``,
   ``probe_shapes.main``), their JSON records on lines of their own, and
   the four kernels' launches in that run.
13. K2's probes (``r2l_tpu_torch.exp``) at their own sizes: the ResMLP body
   (``probe_int8.resmlp``, on wgmma since its redesign) int8, folded and
   bf16 at 4 and 43 blocks on 163,840 rays, dual bit for bit the single,
   timed on its image staged once (and the staging beside); the wall
   (``probe_wall.wall``, on the int8 chain's wgmma kernel since its
   redesign) in its three modes at 4 and 86 layers, timed on one image
   staged once (and the staging beside); on one
   400x400 lego frame of the canonical student packed as in phase 3, the
   streams (``probe_pipe_lib.apply_int8_pe_streams``, S = 1, 2, 4, schedules
   of K2's Hopper kernel) bit for bit K2 and their plain version, timed in
   turns with K2 deployed, and the epilogues (``probe_epi.apply_variant``,
   v0-v2 as forms of K2's Hopper kernel, on the folded and the unfolded
   packing), v0 bit for bit K2 unfolded and v2 bit for bit v1; each against its plain version
   and timed with it, the epilogues beside K2 unfolded and deployed. Then the
   four runners as a user runs them (``probe_int8``, ``probe_wall``,
   ``probe_pipe``, ``probe_epi``), and the four kernels' launches in that
   run.
14. K5 with an int8 dL/dx (``probe_bwd_qdx``) at the driver's size (81,920
   rays, W256, 43 blocks, K4's stash, 512-ray tiles): ``bwd_group_qdx``
   against its plain version on the card, on the top 4-block group and on
   the whole walk (ten groups of 4, one of 3), at the driver's body_scale
   and at one of order one: dh and the dt scratch bit for bit, dW and db
   norm-relative, the worst as a ``[margin]`` line; two runs bit-identical;
   the top layer's dW and db equal to K5's (K5's own dW pass); kernel,
   plain and walk times, the image's staging time. Then the runner
   as a user runs it (``probe_bwd_qdx.main``: the bf16 and qdx walks, their
   cosines and times), and the kernel's launches: 11 in one walk, and in
   the runner 11 per qdx walk it ran.
15. The frame path's remainder and evaluation, on the phase-4 student (made
   again from the seed). (a) The 16 lego poses' own rays through
   ``make_r2l_givenrays_frame_fn`` for ``pe`` and ``int8`` (calibrated on
   those rays): ``pe`` equal to phase 4's pose frames bit for bit, ``int8``
   against the ``jnp`` frames (PSNR); ms/frame through
   ``make_r2l_givenrays_bench_fn(parts=...)``, its checksum the frames' sum.
   (b) ``render_path_given_rays`` on 4 of those frames through the int8
   frame function, the ``jnp`` frames as ground truth, LPIPS alex on seeded
   weights, into a temporary directory: PSNR/v2/SSIM/FLIP/LPIPS, ms/frame,
   the PNG files; K1/K2 launches in (a) and (b). Then SSIM, FLIP and LPIPS
   alex timed on a 400x400 frame, and SSIM/FLIP/minmax FLIP of
   ``tests/fixtures/metrics_golden.npz`` on the card against the fixture and
   the CPU (with what TF32 convolutions would read). (c) The teacher's
   benchmark (``make_nerf_bench_fn``, f32 weights, 2 poses), fused and
   plain: ms/frame, the fused checksum against ``make_nerf_frame_fn``'s
   frames, K6's launches. (d) ``python3 bench_cuda.py`` as a user runs it:
   its JSON line on a line of its own, the int8 path and this card.

16. Checkpoints, resume and export (``r2l_tpu_torch.checkpoint``,
   ``export``, ``tools.export_torch_ckpt``). (a) The phase-4 student (made
   again from the seed) saved as a native .msgpack and exported from it as
   a reference-schema .tar, each loaded (``load_r2l``) into a new R2L on the
   card: file sizes, save, export and load ms; its ``pe`` (K1) and ``int8``
   (K2) frames of 4 lego poses (``make_r2l_frame_fn`` made after the load)
   equal to the original's bit for bit, and the K1/K2 launches. (b) At the
   README's flags (81,920 rays, hard ratio 0.2, hard_mul 20), kinds
   ``fused`` and ``fused_int8`` (calibrated every step): 3 steps, ``save``
   with the pool, ``resume_distill`` into a state built afresh from other
   weights, 2 steps; params, Adam's moments and counts and the pool equal to
   5 straight steps bit for bit; save and restore ms, MB written, the
   K3/K4/K5 launches. (c) Lego's teacher step at 1,024 rays: 2 steps, save,
   ``resume_teacher`` into networks built afresh, 1 step; equal to 3
   straight bit for bit. (d) ``export_onnx`` of the canonical student: its
   own parity check, MB and seconds.

17. The command line (``main_cuda.py``'s ``app.train`` and
   ``r2l_tpu_torch.tools.create_data``) on 11 ray-traced 400x400 views of
   the sphere written as a Blender folder (PNGs, transforms_*.json), read
   back by the port's loader: the teacher at configs/lego.txt's widths (30
   steps, sigma noise 1, a test eval through K6, teacher.msgpack); every
   create_data mode from it (2 poses each; ``rand`` also as a subprocess
   of the tool, with the same teacher PSNR and the same shards byte for
   byte; ``rand --quantize int8`` through K7; ``convert_rays``); rays-mode
   distillation of the canonical student (README flags, bf16) with
   ``--fused_train_vjp`` (K3 + K5) and ``--fused_train_int8`` (K4 + K5),
   20 steps each with a test eval and ckpt_best; images mode (f32, phase
   10's dtype) on the spiral images; from ckpt_best ``--render_only --render_test`` as a subprocess
   of main_cuda.py and in process (PSNR equal to the training-time eval),
   ``--quantize int8`` (K2), ``--benchmark``, ``--convert_to_onnx``, and
   ``tools.verify_released_ckpt`` on ckpt_best (its K1 path's PSNR that of
   ``--render_only``). ``[main] cli`` lines: wall s, ms/step (the host wall between the
   [TRAIN] lines) or ms/frame beside the direct calls' of phases 4, 6, 8
   and 10, PSNR, peak memory, launches; K1-K7 must each launch.

Prints a JSON line of details, a JSON line of per-kernel results
(``{"kernels": [...]}``: launches on the main path, max-abs error against
the plain version, kernel and plain ms, the least time the card could take
for the same work and what bounds it), the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

H = W = 400
FOCAL = 555.5555155968841  # lego: .5*800/tan(.5*camera_angle_x) at half res
N_SAMPLE, EMBED_L = 16, 10
K = 16                     # frames per kind on the main path
SEED = 0

# Kernel vs its plain version on the same inputs, on the card:
# K1 f32 (and K9 f32): each head and body product as 3xTF32 on the tensor
#   cores (a_hi w_lo + a_lo w_hi + a_hi w_hi, about 21 mantissa bits, sums
#   truncated) against the plain version's true f32, across 88 layers; the
#   CPU emulation reads 5.96e-7, 0.6% of this limit
#   (tests/test_torch_r2l_staging.py), a single TF32 product 3.9e-4, over it.
TOL_PE_F32 = 1e-4
# K1 bf16: a one-ulp difference in a dot can flip a bf16 rounding of an
#   activation, which then propagates (the bound of
#   tests/test_pallas_pe.py:50).
TOL_PE_BF16 = 3e-2
# K2: int8 x int8 -> int32 is exact and the epilogue rounds step by step as
#   the plain version does; a flipped requantize would move a few outputs
#   (the bounds of tests/test_pallas_int8_pe.py:45-46). On the card the
#   plain version runs the card's sinf/cosf too, and phase 3 also holds
#   K2's three forms to it bit for bit.
TOL_INT8_MAX, TOL_INT8_RMS = 2.5e-2, 2.5e-3
# K2 on the canary: equal to its plain version on the card, bit for bit.
#   Against the JAX reference's frozen output: the dequantize is one FMA on
#   both sides (the CPU plain version reproduces the fixture bit for bit),
#   but the card's sin/cos/exp differ from the CPU's by ulps, which leaves
#   outputs one f32 ulp of [0.5, 1) apart (measured 5.96e-8; ROADMAP C).
TOL_CANARY_PLAIN, TOL_CANARY_JAX = 0.0, 6e-8
# Frames of a kernel kind against the plain jnp frames (PSNR, dB).
MIN_PSNR = {"pe": 40.0, "int8": 35.0}

# Training (phases 5-6): the README's distillation flags.
N_RAND = 20 * 4096             # --N_rand 20: 81,920 rays per step
HARD_RATIO, HARD_MUL = 0.2, 20.0
WARMUP = "0.0001,200"
N_SHARDS, SHARD_RAYS = 100, 4096
TIMED_STEPS = 10
# K3 f32: the same f32 chain as its plain version, sums in another order
#   (K1's 1e-4 tightened: the first run measured 4.2e-7 on rgb, 0 on the
#   stash).
TOL_TRAIN_F32 = 1e-5
# K3 bf16: rgb as K1 bf16; each stash row relative to its largest value (a
#   flipped bf16 rounding propagates to the later rows).
TOL_TRAIN_BF16 = 3e-2
# K4 stash: exact int32 sums and the plain version's epilogue, so a q-value
#   moves only where sinf/cosf or an f32 sum order flips a rounding: by one
#   step, on under 0.1% of the values.
MAX_Q_STEP, MAX_Q_SHARE = 1, 1e-3
# K5 (tests/test_train_pallas.py:58, 88-92): f32 weights norm-relative
#   1e-5, sums in another order; the products are 3xTF32, whose error grows
#   with depth: over the canonical walk (43 blocks) the card reads 84-86%
#   of the limit, the kernel's own (PERF.md section 2, the [margin] lines
#   below); the limit stays the reference's. bf16 weights: a flipped bf16
#   rounding of dt1/dt2 propagates down the walk, norm-relative 1e-2 (the
#   test's 5e-2 tightened: the first run measured 2.4e-3 over the whole
#   walk), and under 2e-3 of the entries off by more than 5e-2 of the
#   largest.
TOL_GRAD_F32, TOL_GRAD_BF16, MAX_BAD_BF16 = 1e-5, 1e-2, 2e-3
# K8 stash rows, each relative to its largest value: K3 bf16's rule (a
#   flipped bf16 rounding or requantize propagates to the later rows).
TOL_K8_STASH = 3e-2
# First-step loss of a fused kind against xla's, relative
#   (tests/test_train_pallas.py:119, 158).
RTOL_LOSS = {"fused": 2e-2, "fused_int8": 5e-2, "fused_int8_bf16stash": 5e-2}
# K9 frames through the kernel API against the plain jnp frames (PSNR, dB).
MIN_PSNR_API = 40.0
K_API_F32 = 4          # f32-weight frames (K9 f32 is about 10x slower)
# The student's frame at the CLI's default compute dtype (f32, K1 f32)
# against the plain f32 frames (K1's plain version on the same points):
# 3xTF32 against true f32 (the limit leaves room for the tensor cores'
# truncating sums; measured: see PERF.md).
MIN_PSNR_CLI_F32 = 100.0

# Teacher training (configs/lego.txt: no_batching, 64 + 128 samples,
# N_rand 1024, lrate 5e-4, decay 500, precrop 500 at 0.5, white background)
# on 16 ray-traced 400x400 views of a coloured unit sphere; then the
# batched step with fern's training flags (configs/fern.txt: use_batching,
# 64 + 64 samples, raw_noise_std 1, decay 250) on the same images' rays.
N_TEACHER_IMAGES = 16
TEACHER_WARMUP, TEACHER_TIMED = 2, 20
EVAL_RAYS = 4096      # per image, of the first four, to measure progress
# Images-mode distillation (README.md: --data_mode images, lego_noview.txt:
# N_rand 1024 pixels, precrop 500 at 0.5, decay 500; W256/D88, 16 samples,
# the CLI's f32 compute dtype), with the rays command's --warmup_lr
# 0.0001,200: without a warm-up the first Adam step at 5e-4 saturates the
# random-init student, whose loss then cycles with the images unchanged.
# Two passes over the 16 images; the loss falls from the first to the
# second (each image's loss differs, so whole passes are compared).
IMAGES_WARMUP, IMAGES_TIMED, IMAGES_WARMUP_LR = 2, 30, "0.0001,200"

# Teacher (phases 7-9): the README's datagen teacher (configs/lego.txt with
# the CLI defaults).
T_SAMPLES, T_FINE, T_CHUNK, T_FOCAL = 64, 128, 32768, 555.555
DENSITY_FLOOR = 1.0   # added to alpha_linear's bias: an untrained teacher's
#   density hovers around 0, where the last sample's alpha (its distance is
#   1e10) flips between 0 and 1 at the smallest rounding change
# K6/K7 against their plain versions, ((max-abs, RMS) of rgb, acc and
#   weights, (max-abs, RMS) of depth, a sum of w*z with z up to 6). A
#   weight of this teacher is about 0.005-0.06, so every limit sits well
#   below a weight written one sample off or scaled a few percent wrong.
#   K6 f32: each product as 3xTF32 on the tensor cores (about 21 mantissa
#   bits, sums truncated) against true f32 (measured 8.3e-7 / 7.7e-8, depth
#   2.4e-6 / 2.6e-7, H100, 700 W; 2% of these limits in the CPU emulation,
#   tests/test_torch_nerf_staging.py). K6 bf16: the same bf16 roundings on
#   both sides, an f32 sum order apart, so a flipped rounding moves an
#   activation by one bf16 step (measured 1.4e-5 / 4.4e-7, depth 1.4e-5 /
#   1.0e-6). K7: exact int32 sums, the same one-FMA dequantize and the
#   same compositing on both sides (measured 0): a few f32 ulp.
TOL_TEACHER = {"f32": ((1e-5, 1e-6), (1e-4, 1e-5)),
               "bf16": ((1e-4, 1e-5), (6e-4, 6e-5)),
               "int8": ((5e-7, 5e-8), (3e-6, 3e-7))}
DATAGEN_POSES = {"f32": 2, "bf16": 4, "int8": 4}   # timed, after 1 warm-up
# rgb of a datagen pose against the plain f32 render (PSNR, dB; measured
#   131.9 / 89.6 / 70.1 on the seeded pose), and the fused f32 teacher
#   frame against the plain one (f32; measured 131.9).
MIN_PSNR_TEACHER = {"f32": 100.0, "bf16": 80.0, "int8": 60.0}

# Phase 12, the exp/ probes at their own sizes. Every bf16 check is
#   relative to the largest |plain| output, (max-abs, RMS): the random
#   chains decay, to ~1e-7 (none) and ~2e-14 (bigN) at full depth, and a
#   zero or wrong output reads of order 1. Chain modes, dual and bigN: the
#   same bf16 roundings, f32 sums in another order, so a flipped bf16
#   rounding propagates through the layers (measured at 8 layers or 4 pairs
#   4.0e-3..6.8e-3 / 8.4e-5..1.6e-4; at 86 layers or 43 pairs 5.7e-3 /
#   2.3e-4 full, 5.7e-3 / 1.4e-4 lean, 1.9e-2 / 8.5e-4 none, 2.6e-2 /
#   1.3e-3 bigN). The int8 chain and the int8 shapes: bit for bit.
TOL_PROBE_BF16 = {"shallow": (3e-2, 1e-3), "deep": (5e-2, 5e-3)}
# bf16 shapes. free: f32 sums of the same exact products in another order
#   (measured 1.2e-6 / 2.4e-7 at worst). chained, 64 layers, on two seeds:
#   bf16 roundings flipped by the f32 sum order (measured 2.2e-2..3.5e-2 /
#   2.7e-3..4.6e-3 on the first); each is printed beside the plain version
#   against itself with the channels permuted (the same function, its sums
#   in another order), the spread that order alone makes. chained, 4
#   layers, where a kernel that skipped the bf16 rounding between layers
#   would show: a plain version without it reads 3e-3 / 8e-4 and differs in
#   every row (CPU, 4,096 rows), the permuted plain 1.2e-3..2.0e-3 /
#   6e-5..1.2e-4 in 5-16% of the rows. The share of rows that differ: the
#   kernel differs from every plain version summed in an IEEE order (cuBLAS,
#   channels permuted, the kernel's own 64- or 16-channel k order) in
#   7.0-8.4% of rows at K=N=256 and 28.1-29.9% at 512, while those differ
#   among themselves in 3.6-5.6% and 12.3-16.6%: one mma.sync does not
#   round its sum to nearest but truncates (96% of the differing results
#   have the smaller magnitude; PERF.md section 2). Measured 0.286 at
#   K=N=512 (H100, 700 W); the limit leaves room for other inputs, far below
#   a skipped rounding's every row.
TOL_SHAPES_FREE, TOL_SHAPES_CHAINED = (1e-5, 2e-6), (1e-1, 1e-2)
TOL_SHAPES_CHAINED_SHALLOW, MAX_SHAPES_DIFFER_SHARE = (5e-3, 4e-4), 0.35
# One mma.sync's and one wgmma's f32 sum (probe_shapes.mma_rounding, k = 16
#   and 32): the share of rows that differ from the f32 round-to-nearest of
#   the exact sum, the share of those of the smaller magnitude (truncation;
#   an IEEE sum lands on either side about equally, 51% on the CPU), and the
#   largest distance from the exact sum, held to k ulps of the largest
#   product. Measured 32.66% / 49.88%, 95.5% / 90.7%, 7.25 / 9.89 (H100,
#   700 W); a kernel that returned zeros reads about 2^23 ulps.
MIN_MMA_DIFFER_SHARE, MIN_MMA_TRUNCATED_SHARE = 0.1, 0.8
PROBE_SHAPES_SHALLOW = 4
PROBE_INT8_DEPTHS = (4, 8)   # the check's depths: at 86 the output is 0
# Phase 13, K2's probes. The int8 bodies, the wall's modes, the streams and
#   the epilogues: exact int32 dots and the plain versions' roundings, bit
#   for bit (the streams also equal K2 and their plain version, v0 K2
#   unfolded, v2 v1); epi against the plain version at K2's bounds (the
#   card's sinf/cosf against torch's could flip a requantize; phase 3 holds
#   K2 itself bit for bit on this frame). The bf16
#   control at the chains' relative bounds (TOL_PROBE_BF16), at 4 blocks and
#   43, with a tighter RMS at 4 blocks: the kernel read 7.3e-5 there (H100,
#   700 W), and a plain version that skips the bf16 rounding of each block's
#   t reads 6.2e-4 on this input (CPU), under the chains' 1e-3.
PROBE_RESMLP_SHALLOW, PROBE_WALL_SHALLOW = 4, 4
TOL_PROBE_RESMLP_BF16_SHALLOW = (TOL_PROBE_BF16["shallow"][0], 2.5e-4)

# Phase 14, the int8-dL/dx probe. dh and the dt scratch: exact int32 dots,
#   IEEE quotients for the tile's scale and the column multipliers, and the
#   one-FMA update on both sides, so bit for bit. dW and db: K5's wgmma
#   passes over that scratch against the plain version's matmuls, sums in
#   other orders, norm-relative (K5 f32's bound; the [margin] line); the top
#   layer's, whose dt2 is K5's, equal to K5's.
TOL_QDX_DW = 1e-5

# Phase 15, the frame path's remainder and evaluation. A pe given-rays frame
#   on a pose's own rays is that pose's frame bit for bit (sample_test is
#   frame_rays then sample_train's even depths); int8, calibrated on the
#   rays, holds MIN_PSNR["int8"] against the jnp frames. SSIM and FLIP on
#   the card against the reference torch code's frozen values at the
#   fixture's tolerances (tests/test_lpips_flip.py: SSIM rtol 2e-4 atol
#   2e-5, FLIP rtol 2e-3 atol 2e-4), and against the CPU's at the port's
#   bound against JAX (tests/test_torch_metrics.py, f32 sums in another
#   order): measured 6e-8 (H100, 700 W), while TF32 convolutions move FLIP
#   by 1.95e-4, inside the fixture's tolerance but not this one (printed
#   beside). The teacher's benchmark checksum against the sum of its
#   frames, relative (phase 4's rule).
N_EVAL_FRAMES, N_NERF_BENCH = 4, 2
GOLD_SSIM, GOLD_FLIP, CARD_VS_CPU = (2e-4, 2e-5), (2e-3, 2e-4), (1e-5, 1e-6)
RTOL_CHECKSUM = 1e-4

# Phase 16, checkpoints: the loaded students' frames of CKPT_POSES lego
#   poses and every resumed state (params, Adam's moments and counts, the
#   pool) against the original's, bit for bit; lego's teacher step at
#   CKPT_TEACHER_RAYS rays for its resume.
CKPT_POSES, CKPT_TEACHER_RAYS = 4, 1024

# The card's memory rate (H100 SXM data sheet); its peaks are the probes'
# table, r2l_tpu_torch/exp/_harness.py.
HBM_BYTES_S = 3.35e12


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 3) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def deltas(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad output: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    d = (got.double() - want.double())
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def check(name: str, max_abs: float, rms: float, tol_max: float,
          tol_rms: float | None = None) -> None:
    ok = max_abs <= tol_max and (tol_rms is None or rms <= tol_rms)
    print(f"[check] {name}: max_abs {max_abs:.3e} (tol {tol_max:.1e}) "
          f"rms {rms:.3e}"
          + (f" (tol {tol_rms:.1e})" if tol_rms is not None else "")
          + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")


def nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (a parameter tuple's flags are
    skipped)."""
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound(ops: float, moved: int, kind: str) -> dict:
    """The least time the card could take: the larger of ``ops`` at the
    data-sheet peak of ``kind`` and ``moved`` bytes at the memory rate."""
    from r2l_tpu_torch.exp._harness import PEAK_OPS
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = moved / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lego_poses(k: int) -> np.ndarray:
    from r2l_tpu_torch.rays import pose_spherical
    return np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                     for t in np.linspace(-180, 180, k, endpoint=False)])


def phase_kernels(model, cfg, sampler, poses, dev) -> dict:
    """Each kernel against its plain version at one frame's rays."""
    from r2l_tpu_torch.evaluate import _calibration_points
    from r2l_tpu_torch.exp._harness import chain_ops
    from r2l_tpu_torch.kernels import r2l_fused as F
    dim_pts = cfg.input_dim // (2 * EMBED_L + 1)
    pts = sampler.sample_test(torch.as_tensor(poses[3], device=dev))
    calib = _calibration_points(sampler, poses, dev)
    cases = (
        ("pe_f32", "K1 f32", (TOL_PE_F32, None), F.fused_r2l_apply_pe,
         F.fused_r2l_apply_pe_ref, F.prepare_fused_params_pe(
             model, cfg, dim_pts, EMBED_L, weight_dtype=torch.float32)),
        ("pe", "K1 bf16", (TOL_PE_BF16, None), F.fused_r2l_apply_pe,
         F.fused_r2l_apply_pe_ref, F.prepare_fused_params_pe(
             model, cfg, dim_pts, EMBED_L, weight_dtype=torch.bfloat16)),
        ("int8", "K2", (TOL_INT8_MAX, TOL_INT8_RMS),
         F.fused_r2l_apply_int8_pe, F.fused_r2l_apply_int8_pe_ref,
         F.calibrate_r2l_int8_pe(model, cfg, dim_pts, EMBED_L, calib)),
    )
    out = {}
    for key, label, tols, kernel, plain, fp in cases:
        got = kernel(fp, cfg, pts, dim_pts, EMBED_L)
        want = plain(fp, cfg, pts, dim_pts, EMBED_L)
        mx, rms = deltas(got, want)
        check(f"{label} vs plain", mx, rms, *tols)
        print(f"[check] {label} vs plain: {int((got != want).sum())} of "
              f"{got.numel()} outputs differ", flush=True)
        kind = {"pe_f32": "f32", "pe": "bf16", "int8": "int8"}[key]
        out[key] = {
            "max_abs_err": mx,
            "ms": time_ms(lambda: kernel(fp, cfg, pts, dim_pts, EMBED_L)),
            "plain_ms": time_ms(lambda: plain(fp, cfg, pts, dim_pts,
                                              EMBED_L)),
            **bound(chain_ops(cfg, pts.shape[0], cfg.input_dim),
                    nbytes(pts, got, *fp), kind),
            "library_ms": None}
        print(f"[time] {label}: kernel {out[key]['ms']:.3f} ms, plain "
              f"{out[key]['plain_ms']:.3f} ms at {pts.shape[0]} rays",
              flush=True)
        if key != "int8":
            chain_design(out[key], label, cfg, kind, pts.shape[0],
                         nbytes(pts, got, *fp))
    k2_forms(out["int8"], model, cfg, pts, calib, dp=dim_pts)

    from r2l_tpu_torch.encoding import r2l_embed
    x = r2l_embed(pts, EMBED_L)
    for kind, wd, tol, k1 in (("f32", torch.float32, TOL_PE_F32, "pe_f32"),
                              ("bf16", torch.bfloat16, TOL_PE_BF16, "pe")):
        fp = F.prepare_fused_params(model, cfg, weight_dtype=wd)
        got = F.fused_r2l_apply(fp, cfg, x)
        want = F.fused_r2l_apply_ref(fp, cfg, x)
        mx, rms = deltas(got, want)
        check(f"K9 {kind} vs plain", mx, rms, tol)
        print(f"[check] K9 {kind} vs plain: {int((got != want).sum())} of "
              f"{got.numel()} outputs differ", flush=True)
        r = out[f"api_{kind}"] = {
            "max_abs_err": mx,
            "ms": time_ms(lambda: F.fused_r2l_apply(fp, cfg, x)),
            "plain_ms": time_ms(lambda: F.fused_r2l_apply_ref(fp, cfg, x)),
            **bound(chain_ops(cfg, x.shape[0], cfg.input_dim),
                    nbytes(x, got, *fp), kind),
            "library_ms": None}
        chain_design(r, f"K9 {kind}", cfg, kind, x.shape[0],
                     nbytes(x, got, *fp))
        print(f"[time] K9 {kind}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}), K1 {kind} {out[k1]['ms']:.3f} ms, at "
              f"{x.shape[0]} rays of [{x.shape[1]}] f32", flush=True)
        del fp
    return out


def k2_forms(r: dict, model, cfg, pts, calib, dp: int) -> None:
    """K2 on wgmma s8 (phase 3): its three forms bit for bit against their
    plain versions on the frame, and at W64 and W128 (8-layer students on
    the frame's first 20,000 rays); the s8 image's L2 bytes by design."""
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.models import R2LConfig, init_r2l
    forms = (("deployed", True, True), ("fold", True, False),
             ("unfolded", False, False))
    cases = [("W256", cfg, model, pts)]
    for w in (64, 128):
        c = R2LConfig(netdepth=8, netwidth=w, compute_dtype=torch.bfloat16)
        cases.append((f"W{w}", c, init_r2l(c, torch.Generator().manual_seed(
            SEED + w), pts.device), pts[:20000].contiguous()))
    for name, c, m, q in cases:
        for form, fold, nob in forms:
            fp = F.calibrate_r2l_int8_pe(m, c, dp, EMBED_L, calib,
                                         fold_requant=fold)
            got = F.fused_r2l_apply_int8_pe(fp, c, q, dp, EMBED_L, fold, nob)
            want = F.fused_r2l_apply_int8_pe_ref(fp, c, q, dp, EMBED_L,
                                                 fold, nob)
            check(f"K2 {form} {name} vs plain", *deltas(got, want),
                  TOL_INT8_MAX, TOL_INT8_RMS)
            check_equal(f"K2 {form} {name} vs plain, bit for bit", got, want)
            del fp, got, want
    r["l2_gb_per_frame"] = F.int8_chain_l2_bytes(cfg, dp, EMBED_L,
                                                 pts.shape[0]) / 1e9
    r["engine"] = "wgmma s8"
    print(f"[time] K2 design: {r['l2_gb_per_frame']:.2f} GB of weights from "
          f"L2 per frame; kernel {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} "
          f"ms ({r['bound_by']})", flush=True)


def chain_design(r: dict, label: str, cfg, kind: str, n: int,
                 moved: int) -> None:
    """K1/K9's design beside a row of phase 3 (n rays, ``moved`` bytes in
    and out): f32 runs three TF32 products per multiply-add (3xTF32), so
    its bound is the tensor cores' TF32 one, with the CUDA cores' true-f32
    bound beside it; the weight bytes the design reads from L2 in the
    launch (the staged image once per cluster)."""
    from r2l_tpu_torch.exp._harness import chain_ops
    from r2l_tpu_torch.kernels import r2l_fused as F
    wd = torch.float32 if kind == "f32" else torch.bfloat16
    if kind == "f32":
        r["bound_cuda_cores_ms"] = r["bound_ms"]
        r.update(bound(3 * chain_ops(cfg, n, cfg.input_dim), moved, "tf32"),
                 engine="3xTF32")
        print(f"[time] {label} bounds: 3xTF32 {r['bound_ms']:.3f} ms (three "
              f"TF32 products at 495 TFLOP/s), CUDA cores "
              f"{r['bound_cuda_cores_ms']:.3f} ms (f32 at 67 TFLOP/s); this "
              "instance follows 3xTF32", flush=True)
    else:
        r["engine"] = "wgmma bf16"
    r["l2_gb_per_frame"] = F.chain_l2_bytes(cfg, wd, n) / 1e9
    print(f"[time] {label} design: {r['l2_gb_per_frame']:.2f} GB of weights "
          f"from L2 per frame ({r['l2_gb_per_frame'] / r['ms']:.2f} TB/s), "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)


def phase_canary(dev) -> float:
    """K2 on the frozen int8 epilogue canary (the JAX reference's output of
    ``tools/gen_int8_epilogue_canary.py::build_case``)."""
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.models import R2L, R2LConfig, params_from_jax
    fx = REPO / "tests" / "fixtures"
    case = np.load(fx / "int8_epilogue_canary_case.npz")
    want = torch.from_numpy(np.load(fx / "int8_epilogue_canary.npz")["rgb"])
    cfg = R2LConfig(input_dim=6 * (2 * 4 + 1), netdepth=8, netwidth=64)
    model = R2L(cfg, device=dev)
    model.load_state_dict(params_from_jax(
        {k: {"w": case[f"{k}_w"], "b": case[f"{k}_b"]}
         for k in ("head", "body", "tail")}, cfg))
    calib = torch.from_numpy(case["calib"]).to(dev)
    pts = torch.from_numpy(case["pts"]).to(dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4, calib)
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, 6, 4)
    plain = F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, 6, 4)
    check("K2 canary vs plain on the card", *deltas(got, plain),
          TOL_CANARY_PLAIN)
    mx, rms = deltas(got.cpu(), want)
    print(f"[check] K2 canary vs the JAX fixture: "
          f"{int((got.cpu() != want).sum())} of {want.numel()} outputs "
          "differ", flush=True)
    check("K2 canary vs the JAX fixture", mx, rms, TOL_CANARY_JAX)
    return mx


def phase_main_path(model, cfg, sampler, poses, dev) -> dict:
    """The port's entry points for the three kinds, as a user calls them."""
    from r2l_tpu_torch.evaluate import make_r2l_bench_fn, make_r2l_frame_fn
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.metrics import psnr
    kinds = (("jnp", False, ""), ("pe", True, ""), ("int8", True, "int8"))
    F.fused_r2l_apply_pe.launches = 0
    F.fused_r2l_apply_int8_pe.launches = 0
    frames, res = {}, {}
    for kind, use_pallas, quantize in kinds:
        kw = dict(embed_L=EMBED_L, use_pallas=use_pallas, quantize=quantize,
                  calib_poses=poses)
        frame_fn = make_r2l_frame_fn(model, cfg, sampler, **kw)
        bench_fn = make_r2l_bench_fn(model, cfg, sampler, **kw)
        if frame_fn.kind != kind or bench_fn.kind != kind:
            raise AssertionError(f"asked for {kind}, got {frame_fn.kind}")
        frames[kind] = torch.stack([frame_fn(p) for p in poses])
        f = frames[kind]
        if f.shape != (K, H, W, 3) or not torch.isfinite(f).all() \
                or f.min() < 0 or f.max() > 1:
            raise AssertionError(f"{kind}: bad frames {tuple(f.shape)}")
        checksum = float(bench_fn(poses))
        if abs(checksum - float(f.double().sum())) > 1e-4 * abs(checksum):
            raise AssertionError(f"{kind}: bench checksum {checksum} != "
                                 f"frame sum {float(f.double().sum())}")
        ms = time_ms(lambda: bench_fn(poses), reps=2) / K
        res[kind] = {"ms_per_frame": ms, "fps": 1000.0 / ms}
        if kind != "jnp":
            res[kind]["psnr_vs_jnp"] = float(psnr(f, frames["jnp"]))
        print(f"[main] {kind}: {ms:.3f} ms/frame, {1000.0 / ms:.2f} FPS"
              + (f", PSNR vs jnp {res[kind]['psnr_vs_jnp']:.2f} dB"
                 if kind != "jnp" else ""), flush=True)
    torch.cuda.synchronize()
    res["launches"] = {"pe": F.fused_r2l_apply_pe.launches,
                       "int8": F.fused_r2l_apply_int8_pe.launches}
    print(f"[main] kernel launches in the main path: {res['launches']}",
          flush=True)
    for kind in ("pe", "int8"):
        if res["launches"][kind] <= 0:
            raise AssertionError(f"the main path never launched {kind}")
        if res[kind]["psnr_vs_jnp"] < MIN_PSNR[kind]:
            raise AssertionError(f"{kind} frames {res[kind]['psnr_vs_jnp']} "
                                 f"dB from jnp, below {MIN_PSNR[kind]}")
    return res, frames


def phase_api_frames(model, cfg, sampler, poses, jnp_frames, dev) -> dict:
    """Frames through the exported kernel API (K9), as a caller of
    ``r2l_tpu_torch.kernels`` computes them: the frame's points, encoded
    outside, then ``fused_r2l_apply``; bf16 and f32 weights, K9's count set
    to 0 before and read after each."""
    from r2l_tpu_torch.encoding import r2l_embed
    from r2l_tpu_torch.kernels import fused_r2l_apply, prepare_fused_params
    res = {}
    for kind, wd, k in (("bf16", torch.bfloat16, K),
                        ("f32", torch.float32, K_API_F32)):
        fp = prepare_fused_params(model, cfg, weight_dtype=wd)

        def frame(pose):
            pts = sampler.sample_test(torch.as_tensor(pose, device=dev))
            return fused_r2l_apply(fp, cfg, r2l_embed(pts, EMBED_L)
                                   ).reshape(H, W, 3)
        frame(poses[0])                                  # warm-up
        fused_r2l_apply.launches = 0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        f = torch.stack([frame(p) for p in poses[:k]])
        end.record()
        torch.cuda.synchronize()
        launches = fused_r2l_apply.launches
        if f.shape != (k, H, W, 3) or not torch.isfinite(f).all():
            raise AssertionError(f"K9 {kind}: bad frames {tuple(f.shape)}")
        p = psnr_db(f, jnp_frames[:k])
        res[kind] = {"ms_per_frame": start.elapsed_time(end) / k,
                     "frames": k, "psnr_vs_jnp": p, "launches": launches}
        print(f"[main] kernel API {kind} (K9): "
              f"{res[kind]['ms_per_frame']:.3f} ms/frame over {k} frames, "
              f"PSNR vs jnp {p:.2f} dB (min {MIN_PSNR_API}), K9 launches "
              f"{launches}" + (" ok" if p >= MIN_PSNR_API and launches > 0
                               else " FAILED"), flush=True)
        if launches <= 0 or p < MIN_PSNR_API:
            raise AssertionError(f"kernel API {kind}: {res[kind]}")
        del fp
    return res


def phase_cli_f32_frames(model, cfg, sampler, poses, dev) -> dict:
    """The student's frame at the CLI's default compute dtype (f32), as a
    user gets it: ``make_r2l_frame_fn`` with ``compute_dtype=float32`` picks
    kind ``pe`` with f32 weights, so every frame runs K1 f32. K_API_F32
    frames timed by CUDA events, K1's count set to 0 before and read after;
    the frames against the plain f32 frames (K1's plain version on the same
    points), PSNR."""
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    from r2l_tpu_torch.kernels import r2l_fused as F
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    dim_pts = cfg.input_dim // (2 * EMBED_L + 1)
    k = K_API_F32
    frame_fn = make_r2l_frame_fn(model, cfg32, sampler, embed_L=EMBED_L)
    if frame_fn.kind != "pe":
        raise AssertionError(f"the f32 frame took kind {frame_fn.kind}")
    frame_fn(poses[0])                                   # warm-up
    F.fused_r2l_apply_pe.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    f = torch.stack([frame_fn(p) for p in poses[:k]])
    end.record()
    torch.cuda.synchronize()
    launches = F.fused_r2l_apply_pe.launches
    if f.shape != (k, H, W, 3) or not torch.isfinite(f).all():
        raise AssertionError(f"f32 frames: bad frames {tuple(f.shape)}")
    fp = F.prepare_fused_params_pe(model, cfg32, dim_pts, EMBED_L,
                                   weight_dtype=torch.float32, stage=False)
    plain = torch.stack([F.fused_r2l_apply_pe_ref(
        fp, cfg32, sampler.sample_test(torch.as_tensor(p, device=dev)),
        dim_pts, EMBED_L)[:, :3].reshape(H, W, 3) for p in poses[:k]])
    p = psnr_db(f, plain)
    res = {"ms_per_frame": start.elapsed_time(end) / k, "frames": k,
           "psnr_vs_plain_f32": min(p, 999.0), "launches": launches,
           "max_abs_err": float((f.double() - plain.double()).abs().max())}
    ok = launches > 0 and p >= MIN_PSNR_CLI_F32
    print(f"[main] f32 frame (the CLI default, K1 f32): "
          f"{res['ms_per_frame']:.3f} ms/frame over {k} frames, PSNR vs the "
          f"plain f32 frames {p:.2f} dB (min {MIN_PSNR_CLI_F32}), max-abs "
          f"{res['max_abs_err']:.3e}, K1 launches {launches}"
          + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"f32 frames: {res}")
    del fp, plain
    return res


def synthetic_rays(n: int, seed: int) -> np.ndarray:
    """[n, 9] f32 records o(3) d(3) rgb(3): origins on the radius-4 sphere,
    unit directions toward its centre jittered by up to ~0.3, and targets a
    smooth seeded function of the ray, rgb = 0.5 + 0.45 sin(A d + B o/4 +
    c) per channel (A, B [3, 3] and c [3] normal from ``seed``)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 + 0.3 * rng.uniform(-1.0, 1.0, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a, b, c = (np.random.default_rng(seed + 1).normal(size=sh)
               for sh in ((3, 3), (3, 3), (3,)))
    rgb = 0.5 + 0.45 * np.sin(d @ a + (o / 4.0) @ b + c)
    return np.concatenate([o, d, rgb], axis=1).astype(np.float32)


def grad_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(norm-relative error, share of entries off by more than 5e-2 of the
    largest |want|)."""
    got, want = got.double(), want.double()
    rel = float((got - want).norm() / want.norm().clamp(min=1e-30))
    bad = float(((got - want).abs()
                 > 5e-2 * want.abs().max()).double().mean())
    return rel, bad


def check_grads(name: str, got, want, f32: bool) -> dict:
    errs = [grad_err(g, w) for g, w in zip(got, want)]
    rel, bad = max(e[0] for e in errs), max(e[1] for e in errs)
    ok = rel <= (TOL_GRAD_F32 if f32 else TOL_GRAD_BF16) and (
        f32 or bad <= MAX_BAD_BF16)
    print(f"[check] {name}: worst norm-relative {rel:.3e} (tol "
          f"{TOL_GRAD_F32 if f32 else TOL_GRAD_BF16:.0e})"
          + ("" if f32 else f" share off {bad:.2e} (tol {MAX_BAD_BF16:.0e})")
          + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return {"norm_rel_err": rel, "share_off": bad,
            "max_abs_err": float((got[0].double() - want[0].double())
                                 .abs().max())}


def k5_walk(fn, body_w, stash, dh, cfg, cnt, scale=None, staged=None):
    """The whole body's backward through ``fn`` (K5, given its image
    ``staged``, or its plain version), top-down in groups of ``cnt`` blocks:
    (dh, dW, db) as one call over the body would give them."""
    from r2l_tpu_torch.kernels import r2l_train as T
    kw = {"staged": staged} if fn is T.bwd_group else {}
    dws, dbs, b = [], [], cfg.num_blocks
    while b > 0:
        c = min(cnt, b)
        b -= c
        dh, dw, db = fn(body_w, stash, dh, cfg, b, c, body_scale=scale, **kw)
        dws.insert(0, dw)
        dbs.insert(0, db)
    return dh, torch.cat(dws), torch.cat(dbs)


def k5_walk_f64(body_w, stash, dh, cfg):
    """``bwd_group_ref``'s whole-body walk (f32 weights, an f32 or bf16
    stash) in float64, the function's roundings of dt to f32 kept: the
    value both f32 walks approximate."""
    from r2l_tpu_torch.kernels import r2l_train as T
    nb, rs, f64 = cfg.num_blocks, cfg.res_scale, torch.float64
    dh, dws, dbs = dh.to(f64), [], []
    for b in range(nb - 1, -1, -1):
        h_in, t1r, mask = T._group_inputs(stash, nb, b, body_w.dtype, None)
        dt2 = (dh * rs).float().to(f64)
        dt1 = torch.where(mask, dt2 @ body_w[2 * b + 1].to(f64),
                          0.0).float().to(f64)
        dws += [dt2.T @ t1r.to(f64), dt1.T @ h_in.to(f64)]
        dbs += [dt2.sum(0), dt1.sum(0)]
        dh = dh + dt1 @ body_w[2 * b].to(f64)
    return dh, torch.stack(dws[::-1]), torch.stack(dbs[::-1])


def k5_f32_margin(kind, body_w, stash, dh, cfg, walk, err, pts,
                  dev) -> dict:
    """Where K5 f32's whole-walk error (``err`` against the plain walk, at
    ``dh``) sits: the kernel's walk (``walk(T.bwd_group, dh)``) and the
    plain one each against float64, per output (dh, dW, db); then, for f32
    weights on their own stash, the walk against the plain one for three
    more seeds of the weights (their stash from ``pts`` by K3) and of dh,
    each held to ``TOL_GRAD_F32``."""
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.kernels import r2l_train as T
    from r2l_tpu_torch.models import init_r2l
    exact = k5_walk_f64(body_w, stash, dh, cfg)
    out = {}
    for side, fn in (("kernel", T.bwd_group), ("plain", T.bwd_group_ref)):
        out[f"{side}_vs_f64"] = [grad_err(g, e)[0]
                                 for g, e in zip(walk(fn, dh), exact)]
    del exact
    print(f"[margin] K5 {kind} walk vs float64, norm-relative (dh, dW, db): "
          + "; ".join(f"{side} " + " ".join(f"{e:.3e}" for e in
                                            out[f"{side}_vs_f64"])
                      for side in ("kernel", "plain")), flush=True)
    if kind == "f32":
        out["seeds"] = [err]
        f32 = torch.float32
        for s in (1, 2, 3):
            model = init_r2l(cfg, torch.Generator().manual_seed(SEED + 20 + s),
                             dev)
            fp = F.prepare_fused_params_pe(model, cfg, N_SAMPLE * 3, EMBED_L,
                                           weight_dtype=f32)
            _, st = T.train_fwd(fp, cfg, pts, N_SAMPLE * 3, EMBED_L)
            g = torch.randn(dh.shape, generator=torch.Generator(
                dev).manual_seed(SEED + 20 + s), device=dev)
            img = T.stage_bwd_weights(fp.body_w)
            sides = [k5_walk(fn, fp.body_w, st, g, cfg, 4, staged=img)
                     for fn in (T.bwd_group, T.bwd_group_ref)]
            info = check_grads(f"K5 {kind}, whole body walk vs plain, "
                               f"weights and dh seed {s}", *sides, True)
            out["seeds"].append(info["norm_rel_err"])
            del model, fp, st, img, sides
            torch.cuda.empty_cache()
        print(f"[margin] K5 {kind} walk vs plain over 4 seeds of weights and "
              f"dh: worst {max(out['seeds']):.3e}, "
              f"{max(out['seeds']) / TOL_GRAD_F32:.0%} of {TOL_GRAD_F32:.0e}",
              flush=True)
    return out


def train_points(cfg, sampler, dev) -> torch.Tensor:
    """One canonical step's sample points: ``sample_train`` of synthetic
    rays with stratified depths from a seeded generator."""
    from r2l_tpu_torch.sampler import stratify_z
    n = N_RAND
    rec = torch.from_numpy(synthetic_rays(n, SEED + 10)).to(dev)
    z = stratify_z(sampler.z_vals(dev), (n,),
                   generator=torch.Generator(dev).manual_seed(SEED))
    return sampler.sample_train(rec[:, 0:3], rec[:, 3:6], z).contiguous()


def k3_row_errs(stash, stash_p, kind: str) -> torch.Tensor:
    """K3's error per stash row against the plain version's: max-abs (f32),
    or relative to the row's largest value (bf16)."""
    row = (stash.float() - stash_p.float()).abs().amax(dim=(1, 2))
    if kind == "bf16":
        row = row / stash_p.float().abs().amax(dim=(1, 2)).clamp(min=1)
    return row


def k3_margin_line(label: str, rgb_err: float, row: torch.Tensor,
                   nb: int) -> dict:
    """Print where K3 f32 sits against ``TOL_TRAIN_F32``: rgb, the worst
    stash row (and which), the h rows' (0..nb) and the t rows' worst."""
    worst, at = float(row.max()), int(row.argmax())
    h_rows, t_rows = float(row[:nb + 1].max()), float(row[nb + 1:].max())
    print(f"[margin] K3 f32 {label}: rgb {rgb_err:.3e} "
          f"({rgb_err / TOL_TRAIN_F32:.0%} of {TOL_TRAIN_F32:.0e}); stash "
          f"worst {worst:.3e} at row {at} ({worst / TOL_TRAIN_F32:.0%}); "
          f"h rows {h_rows:.3e}, t rows {t_rows:.3e}", flush=True)
    return {"rgb": rgb_err, "stash_worst": worst, "stash_worst_row": at,
            "h_rows": h_rows, "t_rows": t_rows,
            "rows": [float(x) for x in row]}


def k3_f32_seeds(cfg, pts, dev, first: dict) -> dict:
    """K3 f32 against its plain version at one step's rays for three more
    seeds of the weights (``init_r2l`` seeds SEED + 21..23), rgb and every
    stash row held to ``TOL_TRAIN_F32``; with ``first`` (the canonical
    weights') the worst of the four."""
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.kernels import r2l_train as T
    from r2l_tpu_torch.models import init_r2l
    dp, L, nb = N_SAMPLE * 3, EMBED_L, cfg.num_blocks
    out = {"seed 0": first}
    for s in (1, 2, 3):
        model = init_r2l(cfg, torch.Generator().manual_seed(SEED + 20 + s),
                         dev)
        fp = F.prepare_fused_params_pe(model, cfg, dp, L,
                                       weight_dtype=torch.float32)
        rgb, stash = T.train_fwd(fp, cfg, pts, dp, L)
        rgb_p, stash_p = T.train_fwd_ref(fp, cfg, pts, dp, L)
        err = deltas(rgb, rgb_p)[0]
        row = k3_row_errs(stash, stash_p, "f32")
        out[f"seed {s}"] = k3_margin_line(f"weights seed {s}", err, row, nb)
        check(f"K3 f32 weights seed {s}: rgb vs plain", err, 0.0,
              TOL_TRAIN_F32)
        check(f"K3 f32 weights seed {s}: stash, worst of {row.numel()} "
              "rows", float(row.max()), 0.0, TOL_TRAIN_F32)
        del model, fp, stash, stash_p
        torch.cuda.empty_cache()
    worst = max(max(v["rgb"], v["stash_worst"]) for v in out.values())
    print(f"[margin] K3 f32 over 4 seeds of the weights, rgb and every stash "
          f"row: worst {worst:.3e}, {worst / TOL_TRAIN_F32:.0%} of "
          f"{TOL_TRAIN_F32:.0e}", flush=True)
    out["worst"] = worst
    return out


def train_registers() -> dict:
    """nvcc's register and spill lines of K3's and K4/K8's libraries."""
    from r2l_tpu_torch.kernels import _build
    return {lib: [ln.strip() for ln in _build.compiler_log(lib).splitlines()
                  if "registers" in ln or "spill" in ln]
            for lib in ("r2l_train_fwd", "r2l_train_fwd_int8")}


def phase_train_kernels(model, cfg, sampler, poses, dev) -> dict:
    """K3, K4, K8 and K5 against their plain versions at one step's rays."""
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.kernels import r2l_train as T
    from r2l_tpu_torch.exp._harness import chain_ops
    from r2l_tpu_torch.train import fused_int8_calib_points
    dp, L, nb, W = N_SAMPLE * 3, EMBED_L, cfg.num_blocks, cfg.netwidth
    pts = train_points(cfg, sampler, dev)
    n = pts.shape[0]
    ops = chain_ops(cfg, n, cfg.input_dim)
    res, stashes = {"registers": train_registers()}, {}

    for wd, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        # packed and staged as the step does it, every step
        fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
        rgb, stash = T.train_fwd(fp, cfg, pts, dp, L)
        rgb_p, stash_p = T.train_fwd_ref(fp, cfg, pts, dp, L)
        tol = TOL_TRAIN_F32 if kind == "f32" else TOL_TRAIN_BF16
        check(f"K3 {kind} rgb vs plain", *deltas(rgb, rgb_p), tol)
        row = k3_row_errs(stash, stash_p, kind)
        check(f"K3 {kind} stash, worst of {stash.shape[0]} rows"
              + (" (relative to the row's largest)" if kind == "bf16"
                 else ""), float(row.max()), 0.0, tol)
        del stash_p
        r = res[f"train_fwd_{kind}"] = {
            "max_abs_err": deltas(rgb, rgb_p)[0],
            "stash_row_err": float(row.max()),
            "ms": time_ms(lambda: T.train_fwd(fp, cfg, pts, dp, L)),
            "plain_ms": time_ms(lambda: T.train_fwd_ref(fp, cfg, pts, dp, L)),
            # the step's packing and K1's image, and the image alone
            "pack_ms": time_ms(lambda: F.prepare_fused_params_pe(
                model, cfg, dp, L, weight_dtype=wd)),
            "stage_ms": time_ms(lambda: F.stage_chain_weights(fp)),
            **bound(ops, nbytes(pts, rgb, stash, *fp), kind),
            "library_ms": None}
        if kind == "f32":
            # 3xTF32: three TF32 products per multiply-add; the CUDA cores'
            # true-f32 bound beside it
            r["bound_cuda_cores_ms"] = r["bound_ms"]
            r.update(bound(3 * ops, nbytes(pts, rgb, stash, *fp), "tf32"))
            r["margin"] = k3_f32_seeds(cfg, pts, dev, k3_margin_line(
                "canonical weights (seed 0)", r["max_abs_err"], row, nb))
        stashes[kind] = (fp.body_w, stash)
        torch.cuda.empty_cache()

    calib = fused_int8_calib_points(H, W, FOCAL, N_SAMPLE, 2.0, 6.0, poses,
                                    dev)
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, dp, L, calib,
                                  fold_requant=False, stage=False)
    fp8q = F.stage_int8_train(fp8, cfg, dp, L, True)
    fp8b = F.stage_int8_train(fp8, cfg, dp, L, False)
    rgb, stash = T.train_fwd_int8(fp8q, cfg, pts, dp, L, stash_q=True)
    rgb_p, stash_p = T.train_fwd_int8_ref(fp8, cfg, pts, dp, L, stash_q=True)
    check("K4 rgb vs plain", *deltas(rgb, rgb_p), TOL_INT8_MAX, TOL_INT8_RMS)
    k48_bits("K4", rgb, rgb_p, stash, stash_p)
    dq = (stash.int() - stash_p.int()).abs()
    n_diff, step = int((dq > 0).sum()), int(dq.max())
    share = n_diff / dq.numel()
    print(f"[check] K4 stash: {n_diff} of {dq.numel()} q-values differ "
          f"({share:.2e}, tol {MAX_Q_SHARE:.0e}), by at most {step} "
          f"(tol {MAX_Q_STEP})"
          + (" ok" if share < MAX_Q_SHARE and step <= MAX_Q_STEP
             else " FAILED"), flush=True)
    if share >= MAX_Q_SHARE or step > MAX_Q_STEP:
        raise AssertionError("K4 stash outside its tolerance")
    del stash_p, dq
    res["train_fwd_int8"] = {
        "max_abs_err": deltas(rgb, rgb_p)[0], "stash_q_differ": n_diff,
        "ms": time_ms(lambda: T.train_fwd_int8(fp8q, cfg, pts, dp, L,
                                               stash_q=True)),
        "plain_ms": time_ms(lambda: T.train_fwd_int8_ref(fp8, cfg, pts, dp,
                                                         L, stash_q=True)),
        # the step's calibration and K4's image, and the image alone
        "calib_ms": time_ms(lambda: F.stage_int8_train(
            F.calibrate_r2l_int8_pe(model, cfg, dp, L, calib,
                                    fold_requant=False, stage=False),
            cfg, dp, L, True)),
        "stage_ms": time_ms(lambda: F.stage_int8_train(fp8, cfg, dp, L,
                                                       True)),
        **bound(ops, nbytes(pts, rgb, stash, *fp8), "int8"),
        "library_ms": None}
    body_bf16 = stashes["bf16"][0]
    stashes["int8"] = (body_bf16, stash)
    scale8 = 1.0 / fp8.body_inv

    rgb, stash = T.train_fwd_int8(fp8b, cfg, pts, dp, L, stash_q=False)
    rgb_p, stash_p = T.train_fwd_int8_ref(fp8, cfg, pts, dp, L,
                                          stash_q=False)
    check("K8 rgb vs plain", *deltas(rgb, rgb_p), TOL_INT8_MAX, TOL_INT8_RMS)
    k48_bits("K8", rgb, rgb_p, stash, stash_p)
    if stash.dtype != torch.bfloat16 or stash.shape != stash_p.shape:
        raise AssertionError(f"K8 stash {stash.dtype} {tuple(stash.shape)}")
    row = torch.stack([(a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp(min=1)
                       for a, b in zip(stash, stash_p)])
    check(f"K8 stash, worst of {stash.shape[0]} rows (relative to the row's "
          "largest)", float(row.max()), 0.0, TOL_K8_STASH)
    del stash_p
    res["train_fwd_int8_bf16"] = {
        "max_abs_err": deltas(rgb, rgb_p)[0],
        "stash_row_err": float(row.max()),
        "ms": time_ms(lambda: T.train_fwd_int8(fp8b, cfg, pts, dp, L,
                                               stash_q=False)),
        "stage_ms": time_ms(lambda: F.stage_int8_train(fp8, cfg, dp, L,
                                                       False)),
        "plain_ms": time_ms(lambda: T.train_fwd_int8_ref(
            fp8, cfg, pts, dp, L, stash_q=False)),
        **bound(ops, nbytes(pts, rgb, stash, *fp8), "int8"),
        "library_ms": None}
    stashes["int8_bf16"] = (body_bf16, stash)
    stashes["int8_bf16_f32w"] = (stashes["f32"][0], stash)

    dh = torch.randn((n, W), generator=torch.Generator(dev).manual_seed(
        SEED + 2), device=dev)
    cnt = 4
    for kind in ("f32", "bf16", "int8", "int8_bf16", "int8_bf16_f32w"):
        body_w, stash = stashes[kind]
        scale = scale8 if kind == "int8" else None
        f32 = body_w.dtype == torch.float32
        b0 = nb - cnt
        img = T.stage_bwd_weights(body_w)   # once per step, as _bwd_core
        kw = {"staged": img}

        def group(fn):
            return fn(body_w, stash, dh, cfg, b0, cnt, body_scale=scale,
                      **(kw if fn is T.bwd_group else {}))

        def walk(fn, g=dh):
            return k5_walk(fn, body_w, stash, g, cfg, cnt, scale, img)

        got, again = group(T.bwd_group), group(T.bwd_group)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 {kind}: two runs differ")
        info = check_grads(f"K5 {kind}, blocks {b0}..{nb - 1} vs plain", got,
                           group(T.bwd_group_ref), f32)
        info_walk = check_grads(f"K5 {kind}, whole body walk vs plain",
                                walk(T.bwd_group), walk(T.bwd_group_ref),
                                f32)
        if f32:
            info_walk["margin"] = k5_f32_margin(
                kind, body_w, stash, dh, cfg, walk, info_walk["norm_rel_err"],
                pts, dev)
        moved = (nbytes(dh, *got, body_w[2 * b0:]) + nbytes(stash[0])
                 * 2 * cnt + (nbytes(scale[2 * b0:]) if scale is not None
                              else 0))
        # the scratch design's bytes: dh in and out, the inner stash rows of
        # the mask, dt written and read back, the layer inputs of dW
        dts_bytes = 2 * cnt * n * W * body_w.element_size()
        scratch = (2 * nbytes(dh) + 3 * cnt * nbytes(stash[0])
                   + 2 * dts_bytes)
        res[f"bwd_group_{kind}"] = {
            **info, "walk_norm_rel_err": info_walk["norm_rel_err"],
            "walk_margin": info_walk.get("margin"),
            "ms": time_ms(lambda: group(T.bwd_group)),
            "plain_ms": time_ms(lambda: group(T.bwd_group_ref)),
            "walk_ms": time_ms(lambda: walk(T.bwd_group), reps=2),
            "walk_plain_ms": time_ms(lambda: walk(T.bwd_group_ref), reps=2),
            "stage_ms": time_ms(lambda: T.stage_bwd_weights(body_w)),
            # f32 weights: both passes three TF32 products per
            # multiply-add (3xTF32); the CUDA cores' f32 bound beside it
            **bound(4.0 * n * W * W * 2 * cnt * (3 if f32 else 1), moved,
                    "tf32" if f32 else "bf16"),
            **({"bound_cuda_cores_ms": bound(4.0 * n * W * W * 2 * cnt,
                                             moved, "f32")["bound_ms"]}
               if f32 else {}),
            "bound_scratch_ms": scratch / HBM_BYTES_S * 1e3,
            "library_ms": None}
        del img, kw
        torch.cuda.empty_cache()
    # The passes of one 4-block call under torch.profiler: K5 on K4's int8
    # stash, and the int8-dL/dx probe (phase 14) on the same inputs. Here,
    # because after a profiled training step (phase 6) the profiler sees no
    # kernel for the rest of the process.
    from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
    body_w, stash = stashes["int8"]
    b0 = nb - cnt
    passes = {}
    img = T.stage_bwd_weights(body_w)
    img_q = T.stage_qdx_weights(fp8.body_q)
    for key, fn in (
            ("bwd_group_int8", lambda: T.bwd_group(
                body_w, stash, dh, cfg, b0, cnt, body_scale=scale8,
                staged=img)),
            ("bwd_group_qdx", lambda: PQ.bwd_group_qdx(
                body_w, fp8.body_q, fp8.body_m, stash, dh, cfg, b0, cnt,
                PQ.TILE, scale8, staged=img_q))):
        fn()
        passes[key] = prof = profile_kernels(fn, top=4)
        print(f"[profile] one 4-block call, {key}: " + "; ".join(
            f"{r['name'][:48]} {r['ms']:.3f} ms x{r['calls']}"
            for r in prof["top"]), flush=True)
    for key, r in res.items():
        if key == "registers":
            continue
        print(f"[time] {key}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) at {n} rays"
              + (f"; staging {r['stage_ms']:.3f} ms a step"
                 if "stage_ms" in r else "")
              + (f" (the step's packing with it {r['pack_ms']:.3f} ms)"
                 if "pack_ms" in r else "")
              + (f" (the step's calibration with it {r['calib_ms']:.3f} ms)"
                 if "calib_ms" in r else "")
              + (f"; scratch-bytes bound {r['bound_scratch_ms']:.3f} ms"
                 if "bound_scratch_ms" in r else "")
              + (f"; whole walk {r['walk_ms']:.3f} ms, plain "
                 f"{r['walk_plain_ms']:.3f}" if "walk_ms" in r else "")
              + (f"; 3xTF32 (CUDA cores' f32 bound "
                 f"{r['bound_cuda_cores_ms']:.3f} ms)"
                 if "bound_cuda_cores_ms" in r else ""),
              flush=True)
    res["passes"] = passes
    del stashes
    torch.cuda.empty_cache()
    return res


def k48_bits(label: str, rgb, rgb_p, stash, stash_p) -> dict:
    """Print how many of K4's or K8's outputs differ from the plain
    version's at all (the design keeps every rounding: bit for bit)."""
    d_rgb = int((rgb != rgb_p).sum())
    d_st = int((stash.view(torch.uint8) != stash_p.view(torch.uint8)).sum())
    print(f"[check] {label} vs plain, bit for bit: {d_rgb} of {rgb.numel()} "
          f"rgb values and {d_st} of {stash.numel() * stash.element_size()} "
          "stash bytes differ" + (" (bit for bit)" if d_rgb == d_st == 0
                                  else ""), flush=True)
    return {"rgb_differ": d_rgb, "stash_bytes_differ": d_st}


def profile_kernels(fn, top: int = 12) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel (the
    ``top`` largest) and the sum over all kernels. The profiler slows the
    host several-fold, so a caller takes an idle share against an
    unprofiled time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or getattr(
                e, "is_user_annotation", False):
            continue   # a host op or a named range, not a kernel
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return {"kernel_ms": sum(r[0] for r in rows),
            "top": [{"ms": ms, "calls": c, "name": k[:90]}
                    for ms, c, k in rows[:top]]}


def phase_train_main(cfg, sampler, poses, dev) -> dict:
    """Canonical distillation steps through the entry points, per kind."""
    from r2l_tpu_torch.data import (RayBatchLoader, RayShardDataset,
                                    write_ray_shards)
    from r2l_tpu_torch.hardmine import parse_hard_ratio
    from r2l_tpu_torch.kernels import r2l_train as T
    from r2l_tpu_torch.models import init_r2l
    from r2l_tpu_torch.train import (DistillConfig, clone_train_state,
                                     draw_step, fused_int8_calib_points,
                                     fused_vjp_gate, init_train_state,
                                     make_distill_step)
    n_in, n_out = parse_hard_ratio(HARD_RATIO, N_RAND)
    dcfg = DistillConfig(batch_size=N_RAND, n_hard_in=n_in, n_hard_out=n_out,
                         hard_mul=HARD_MUL, warmup_lr=WARMUP, embed_L=EMBED_L,
                         perturb=True)
    calib = fused_int8_calib_points(H, W, FOCAL, N_SAMPLE, 2.0, 6.0, poses,
                                    dev)
    int8 = {"fused_vjp": True, "fused_quantize": "int8",
            "fused_calib_pts": calib}
    # the four kinds in bf16, then `fused` at the CLI's default compute
    # dtype, f32 (K3 f32 + K5 f32)
    kinds = {"xla": {}, "fused": {"fused_vjp": True}, "fused_int8": int8,
             "fused_int8_bf16stash": {**int8, "fused_stash_q": False},
             "fused_f32": {"fused_vjp": True}}
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_ray_shards(tmp, synthetic_rays(N_SHARDS * SHARD_RAYS, SEED),
                         shard_size=SHARD_RAYS,
                         rng=np.random.default_rng(SEED))
        ds = RayShardDataset(tmp)
        if len(ds) != N_SHARDS * SHARD_RAYS or ds.record_dim != 9:
            raise AssertionError(f"read back {len(ds)} x {ds.record_dim}")
        loader = RayBatchLoader(ds, N_RAND - n_out, seed=SEED, workers=2)
        try:
            batches = [next(loader) for _ in range(3 + TIMED_STEPS + 3)]
        finally:
            loader.close()
    draws = [draw_step(dcfg, N_SAMPLE, torch.Generator(dev).manual_seed(
        100 + i)) for i in range(len(batches))]
    def counts():
        return {"train_fwd": T.train_fwd.launches,
                "train_fwd_int8": T.train_fwd_int8.launches,
                "train_fwd_int8_bf16": T.train_fwd_int8.launches_bf16,
                "bwd_group": T.bwd_group.launches}

    for f in (T.train_fwd, T.train_fwd_int8, T.bwd_group):
        f.launches = 0
    T.train_fwd_int8.launches_bf16 = 0
    per_kind = {}
    for kind, kw in kinds.items():
        kcfg = cfg32 if kind == "fused_f32" else cfg
        if kw.get("fused_vjp") and not fused_vjp_gate(True, kcfg, False):
            raise AssertionError(f"{kind}: the fused gate refused W256/D88")
        before = counts()
        torch.cuda.reset_peak_memory_stats(dev)
        model = init_r2l(kcfg, torch.Generator().manual_seed(SEED), dev)
        state = init_train_state(model, dcfg, device=dev)
        step = make_distill_step(kcfg, dcfg, sampler, device=dev, **kw)
        losses = []
        for i in range(2):                      # warm-up, same draws per kind
            state, m = step(state, batches[i], draws=draws[i])
            losses.append(float(m["loss"]))
        snap = (clone_train_state(state), clone_train_state(state))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ms = []
        for i in range(2, 2 + TIMED_STEPS):
            state, m = step(state, batches[i], draws=draws[i])
            ms.append(m["loss"])
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
        losses += [float(x) for x in ms]
        r = {"ms_per_step": start.elapsed_time(end) / TIMED_STEPS,
             "wall_ms_per_step": wall, "losses": losses,
             "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if not all(np.isfinite(losses)) or not (
                np.mean(losses[-3:]) < losses[0]):
            raise AssertionError(f"{kind}: loss did not fall: {losses}")
        if kind in RTOL_LOSS:   # the bf16 kinds against bf16 xla
            first = res["xla"]["losses"][0]
            rel = abs(losses[0] - first) / abs(first)
            ok = rel <= RTOL_LOSS[kind]
            print(f"[check] {kind} first-step loss {losses[0]:.6f} vs xla "
                  f"{first:.6f}: relative {rel:.2e} (tol "
                  f"{RTOL_LOSS[kind]:.0e})" + (" ok" if ok else " FAILED"),
                  flush=True)
            if not ok:
                raise AssertionError(f"{kind} first-step loss off xla's")
        if kind != "xla":
            runs = []
            for s0 in snap:
                for i in range(2, 5):
                    s0, _ = step(s0, batches[i], draws=draws[i])
                runs.append(s0)
            same = all(torch.equal(a, b) for a, b in zip(
                runs[0].params.state_dict().values(),
                runs[1].params.state_dict().values())) and torch.equal(
                runs[0].pool.rays, runs[1].pool.rays)
            print(f"[check] {kind}: two copies of the state, 3 steps each: "
                  + ("bit-identical ok" if same else "DIFFER"), flush=True)
            if not same:
                raise AssertionError(f"{kind}: repeated steps differ")
            r["repeat_bit_identical"] = same
        r["profile"] = p = profile_kernels(
            lambda: step(state, batches[-1], draws=draws[-1]))
        p["idle_share"] = max(0.0, 1.0 - p["kernel_ms"] / r["ms_per_step"])
        print(f"[profile] train {kind}: kernels {p['kernel_ms']:.3f} ms of "
              f"a {r['ms_per_step']:.3f} ms step (idle {p['idle_share']:.3f})",
              flush=True)
        for row in p["top"]:
            print(f"[profile]   {row['ms']:8.3f} ms  x{row['calls']:<4d} "
                  f"{row['name']}", flush=True)
        print(f"[main] train {kind}: {r['ms_per_step']:.3f} ms/step (CUDA "
              f"events; host {wall:.3f}), loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, peak {r['peak_mem_gb']:.2f} GB", flush=True)
        res[kind] = r
        del state, snap, model, step
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        per_kind[kind] = {k: v - before[k] for k, v in counts().items()}
    res["launches"] = counts()
    res["launches_per_kind"] = per_kind
    print(f"[main] training kernel launches: {res['launches']}; per kind "
          f"{per_kind}", flush=True)
    for name, count in res["launches"].items():
        if count <= 0:
            raise AssertionError(f"the training path never launched {name}")
    # every fused step runs its forward once: warm-up, timed, the repeats'
    # two copies of three steps, the profiled step
    steps = 2 + TIMED_STEPS + 6 + 1
    for kind, fwd in (("fused", "train_fwd"), ("fused_f32", "train_fwd"),
                      ("fused_int8", "train_fwd_int8"),
                      ("fused_int8_bf16stash", "train_fwd_int8_bf16")):
        if per_kind[kind][fwd] != steps:
            raise AssertionError(f"{kind}: {fwd} launched "
                                 f"{per_kind[kind][fwd]} times in {steps} "
                                 "steps")
    return res


def teacher_models(kind: str, dev) -> tuple:
    """(cfg, coarse, fine) canonical teachers of ``kind``'s compute dtype,
    random weights from seeded generators plus the density floor."""
    from r2l_tpu_torch.models import NeRFConfig, init_nerf
    cfg = NeRFConfig(compute_dtype=torch.bfloat16 if kind == "bf16"
                     else torch.float32)
    models = []
    for seed in (SEED + 30, SEED + 31):
        m = init_nerf(cfg, torch.Generator().manual_seed(seed), dev)
        with torch.no_grad():
            m.alpha_linear.bias += DENSITY_FLOOR
        models.append(m)
    return (cfg, *models)


def teacher_vcfg():
    from r2l_tpu_torch.render import VolRenderConfig
    return VolRenderConfig(n_coarse=T_SAMPLES, n_fine=T_FINE, perturb=True,
                           white_bkgd=True, ray_chunk=T_CHUNK)


def datagen_cfg(kind: str, n_pose: int):
    from r2l_tpu_torch.datagen import DataGenConfig
    return DataGenConfig(n_pose=n_pose, H=H, W=W, focal=T_FOCAL,
                         save_every=n_pose, seed=SEED,
                         quantize="int8" if kind == "int8" else "")


def point_macs(cfg) -> int:
    """Multiply-adds of the teacher MLP for one point (unpadded widths)."""
    W_ = cfg.W
    macs = cfg.input_ch * W_ + sum(
        (W_ + cfg.input_ch if i in cfg.skips else W_) * W_
        for i in range(cfg.D - 1))
    if cfg.use_viewdirs:
        return macs + W_ + W_ * W_ + (W_ + cfg.input_ch_views) * (W_ // 2) \
            + (W_ // 2) * 3
    return macs + W_ * cfg.output_ch


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float((a.double() - b.double()).pow(2).mean())
    return float("inf") if mse == 0 else float(-10.0 * np.log10(mse))


def frame_chunks(vcfg, dev) -> tuple[list, int]:
    """One datagen pose's rays in the render's padded 32,768-ray chunks,
    each with its stratified coarse depths and its fine pass's sorted
    depths (``sample_pdf`` on the plain f32 coarse weights):
    ([(o, d, z64, z192)], the pose's ray count)."""
    from r2l_tpu_torch.datagen import _pose_rays
    from r2l_tpu_torch.kernels import nerf_render as NR
    from r2l_tpu_torch.render import _chunks, coarse_z, prepare_fused_teacher
    from r2l_tpu_torch.volume import sample_pdf
    ro, rd = (torch.from_numpy(a.reshape(-1, 3).copy()).to(dev)
              for a in _pose_rays(np.random.default_rng(SEED + 20),
                                  datagen_cfg("f32", 1), 4.0))
    cfg32, mc32, _ = teacher_models("f32", dev)
    fp32 = prepare_fused_teacher(mc32, None, cfg32, vcfg)[0]
    g = torch.Generator(dev).manual_seed(SEED + 21)
    chunks = []
    for o, d, dr in _chunks(vcfg, ro, rd, None, g, True):
        zc = coarse_z(vcfg, o.shape[0], dev, dr.u_strat).contiguous()
        w = NR.fused_nerf_render_ref(fp32, cfg32, o, d, zc, vcfg.multires,
                                     vcfg.multires_views, True)[3]
        zf = sample_pdf(0.5 * (zc[:, 1:] + zc[:, :-1]), w[:, 1:-1], T_FINE,
                        u=dr.u_pdf)
        chunks.append((o, d, zc, torch.sort(torch.cat([zc, zf], -1),
                                            -1).values.contiguous()))
    return chunks, ro.shape[0]


def phase_teacher_kernels(dev) -> dict:
    """K6 (f32, bf16) and K7 against their plain versions over one datagen
    frame's ten launches (coarse then fine per chunk, in the path's order),
    every output checked; the ten timed back to back with CUDA events."""
    from r2l_tpu_torch.datagen import int8_calibration_set
    from r2l_tpu_torch.kernels import nerf_render as NR
    from r2l_tpu_torch.render import prepare_fused_teacher
    vcfg = teacher_vcfg()
    kw = dict(L_pts=vcfg.multires, L_views=vcfg.multires_views,
              white_bkgd=True)
    chunks, n = frame_chunks(vcfg, dev)
    n_launch = 2 * len(chunks)
    calib = tuple(torch.from_numpy(a).to(dev) for a in int8_calibration_set(
        datagen_cfg("int8", 1), vcfg))
    res = {}
    for kind in ("f32", "bf16", "int8"):
        cfg, mc, mf = teacher_models(kind, dev)
        label = f"K{7 if kind == 'int8' else 6} {kind}"
        fpc, fpf = prepare_fused_teacher(
            mc, mf, cfg, vcfg, None, calib if kind == "int8" else None,
            fold_requant=True)

        def frame(fn, events=None):
            outs = []
            if events:
                events[0].record()
            for o, d, zc, zf in chunks:
                for fp, z in ((fpc, zc), (fpf, zf)):
                    outs.append(fn(fp, cfg, o, d, z, **kw))
                    if events:
                        events[len(outs)].record()
            return outs

        def timed(fn, reps):
            """Mean ms of the frame's launches: (all, coarse, fine)."""
            tot = [0.0, 0.0, 0.0]
            for _ in range(reps):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(n_launch + 1)]
                frame(fn, ev)
                torch.cuda.synchronize()
                step = [ev[k].elapsed_time(ev[k + 1])
                        for k in range(n_launch)]
                for k, v in enumerate((ev[0].elapsed_time(ev[-1]),
                                       sum(step[0::2]), sum(step[1::2]))):
                    tot[k] += v / reps
            return tot

        got = frame(NR.fused_nerf_render)        # also the warm-up
        want = frame(NR.fused_nerf_render_ref)   # also the warm-up
        (tol, tol_rms), (tol_d, tol_d_rms) = TOL_TEACHER[kind]
        r = {"max_abs_err": 0.0}
        for p, S in ((0, T_SAMPLES), (1, T_SAMPLES + T_FINE)):
            for j, what in enumerate(("rgb", "acc", "depth", "weights")):
                a, b = (torch.cat([x[2 * i + p][j]
                                   for i in range(len(chunks))])
                        for x in (got, want))
                mx, rms = deltas(a, b)
                check(f"{label} frame S={S} {what} vs plain", mx, rms,
                      *((tol_d, tol_d_rms) if what == "depth"
                        else (tol, tol_rms)))
                r["max_abs_err"] = max(r["max_abs_err"], mx)
            differ = sum(int((g[0] != w[0]).sum())
                         for g, w in zip(got[p::2], want[p::2]))
            # what a limit must stay under: the size of a weight
            r[f"weights_S{S}"] = ws = {"median": float(b[b > 0].median()),
                                      "max": float(b.max())}
            print(f"[check] {label} frame S={S}: {differ} of "
                  f"{len(chunks) * chunks[0][0].numel()} rgb values differ; "
                  f"plain weights > 0: median {ws['median']:.3e}, max "
                  f"{ws['max']:.3e}", flush=True)
        del got, want
        r["ms"], r["coarse_ms"], r["fine_ms"] = timed(
            NR.fused_nerf_render, 1 if kind == "f32" else 3)
        r["plain_ms"], r["plain_coarse_ms"], r["plain_fine_ms"] = timed(
            NR.fused_nerf_render_ref, 1)
        # The work of the pose's n rays (the padded rays are not needed):
        # both passes' points; o, d and both passes' depths read, both
        # passes' rgb, acc, depth and weights written, both networks read
        # (the packed fields once: the staged image is their copy).
        S_all = 2 * T_SAMPLES + T_FINE
        moved = 4 * n * (6 + S_all + 2 * 5 + S_all) + nbytes(
            *fpc[:-2], *fpf[:-2])
        ops = 2.0 * n * S_all * point_macs(cfg)
        r.update(bound(ops, moved, kind), library_ms=None,
                 launches_timed=n_launch)
        if kind == "f32":
            # K6 f32 runs three TF32 products per multiply-add (3xTF32);
            # beside that bound, the CUDA cores' true-f32 one
            r["bound_cuda_cores_ms"] = r["bound_ms"]
            r.update(bound(3 * ops, moved, "tf32"), engine="3xTF32")
        wd = fpc.pts_w.dtype
        l2 = sum(NR.staged_l2_bytes(cfg, wd, o.shape[0], z.shape[1],
                                    vcfg.multires, vcfg.multires_views)
                 for o, _, zc, zf in chunks for z in (zc, zf))
        regs, spill = kernel_registers(kind)
        r.update(l2_gb_per_frame=l2 / 1e9, registers=regs,
                 spill_bytes=spill, smem_bytes=NR.kernel_smem(
                     cfg, wd, vcfg.multires, vcfg.multires_views))
        print(f"[time] {label}, one frame's {n_launch} launches back to "
              f"back ({len(chunks)} chunks of {chunks[0][0].shape[0]} rays, "
              f"S={T_SAMPLES} then {T_SAMPLES + T_FINE}): kernel "
              f"{r['ms']:.3f} ms (coarse {r['coarse_ms']:.3f}, fine "
              f"{r['fine_ms']:.3f}), plain {r['plain_ms']:.3f} ms (coarse "
              f"{r['plain_coarse_ms']:.3f}, fine {r['plain_fine_ms']:.3f}), "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}) for the "
              f"pose's {n} rays", flush=True)
        if kind == "f32":
            print(f"[time] {label} bounds: 3xTF32 {r['bound_ms']:.3f} ms "
                  f"(three TF32 products at 495 TFLOP/s), CUDA cores "
                  f"{r['bound_cuda_cores_ms']:.3f} ms (f32 at 67 TFLOP/s); "
                  f"this instance follows 3xTF32", flush=True)
        rate = r["l2_gb_per_frame"] / r["ms"]
        print(f"[time] {label} design: {r['l2_gb_per_frame']:.1f} GB of "
              f"weights from L2 per frame ({rate:.2f} TB/s), {regs} "
              f"registers, {spill} bytes spilled, "
              f"{r['smem_bytes']} bytes of shared memory per block",
              flush=True)
        res[kind] = r
        del fpc, fpf, mc, mf
        torch.cuda.empty_cache()
    return res


def kernel_registers(kind: str) -> tuple[int, int]:
    """(registers, spill-store bytes) of the canonical W256 instance of K6
    (f32, bf16) or K7 (int8), from nvcc's build log."""
    import re
    from r2l_tpu_torch.kernels import _build
    lib, inst = {"f32": ("nerf_render", "kernelIfLi256E"),
                 "bf16": ("nerf_render", "kernelI13__nv_bfloat16Li256E"),
                 "int8": ("nerf_render_int8", "kernelIaLi256E")}[kind]
    log = _build.compiler_log(lib).splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and inst in line:
            rest = "\n".join(log[i + 1:i + 5])
            spill = re.search(r"(\d+) bytes spill stores", rest)
            regs = re.search(r"Used (\d+) registers", rest)
            return int(regs.group(1)), int(spill.group(1))
    raise AssertionError(f"{lib}: no build log entry for {inst}")


def phase_datagen(dev) -> dict:
    """``generate_pseudo_data`` per kind through its entry point."""
    from r2l_tpu_torch.datagen import _pose_rays, generate_pseudo_data, \
        pose_seed
    from r2l_tpu_torch.kernels import nerf_render as NR
    from r2l_tpu_torch.render import render_frame_nerf
    vcfg = teacher_vcfg()
    res = {}
    for kind, n_timed in DATAGEN_POSES.items():
        cfg, mc, mf = teacher_models(kind, dev)
        gcfg = datagen_cfg(kind, 1 + n_timed)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def progress(done, total):
            if done == 1:
                events[0].record()
            if done == total:
                events[1].record()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        NR.fused_nerf_render.launches = 0
        NR.fused_nerf_render.launches_int8 = 0
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            n_rays = generate_pseudo_data(mc, mf, cfg, vcfg, gcfg, tmp,
                                          progress=progress, device=dev)
            wall = time.perf_counter() - t0
            launches = (NR.fused_nerf_render.launches_int8
                        if kind == "int8" else NR.fused_nerf_render.launches)
            other = (NR.fused_nerf_render.launches if kind == "int8"
                     else NR.fused_nerf_render.launches_int8)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            names = sorted(os.listdir(tmp))
            shards = [np.load(os.path.join(tmp, f), mmap_mode="r")
                      for f in names]
            shapes = [tuple(a.shape) for a in shards]
            recs = np.concatenate(shards)
        ms = events[0].elapsed_time(events[1]) / n_timed
        print(f"[main] datagen {kind}: {ms:.3f} ms/pose over {n_timed} "
              f"timed poses, {H * W / ms * 1e3:.0f} rays/s; K"
              f"{7 if kind == 'int8' else 6} launches {launches}; shards "
              f"{names} {shapes}; peak {peak:.2f} GB; host wall "
              f"{wall:.1f} s for {1 + n_timed} poses", flush=True)
        if launches <= 0 or other != 0:
            raise AssertionError(f"datagen {kind}: launches {launches}, "
                                 f"other kernel {other}")
        if (n_rays != (1 + n_timed) * H * W or names != ["pseudo_000000.npy"]
                or shapes != [((1 + n_timed) * H * W, 9)]
                or recs.dtype != np.float32 or not np.isfinite(recs).all()):
            raise AssertionError(f"datagen {kind}: wrote {n_rays} rays as "
                                 f"{names} {shapes} {recs.dtype}")
        # The first pose's records against the plain f32 render of the same
        # rays with the same generator's draws.
        ro, rd = (a.reshape(-1, 3) for a in _pose_rays(
            np.random.default_rng(gcfg.seed), gcfg, 4.0))
        mine = recs[(recs[:, :3] == ro[0]).all(1)]
        if mine.shape[0] != H * W:
            raise AssertionError(f"datagen {kind}: pose 0 has "
                                 f"{mine.shape[0]} records")
        ref = render_frame_nerf(
            mc, mf, dataclasses.replace(cfg, compute_dtype=torch.float32),
            vcfg, torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev),
            generator=torch.Generator(dev).manual_seed(
                pose_seed(gcfg.seed, 0)))["rgb"].cpu().numpy()
        want = np.concatenate([ro, rd, ref], 1)
        mine = mine[np.lexsort(mine[:, 3:6].T)]
        want = want[np.lexsort(want[:, 3:6].T)]
        if not np.array_equal(mine[:, :6], want[:, :6]):
            raise AssertionError(f"datagen {kind}: pose 0's rays differ")
        p = psnr_db(torch.from_numpy(mine[:, 6:9]),
                    torch.from_numpy(want[:, 6:9]))
        print(f"[check] datagen {kind}: pose 0 rgb vs plain f32 render, "
              f"PSNR {p:.2f} dB (min {MIN_PSNR_TEACHER[kind]})"
              + (" ok" if p >= MIN_PSNR_TEACHER[kind] else " FAILED"),
              flush=True)
        if p < MIN_PSNR_TEACHER[kind]:
            raise AssertionError(f"datagen {kind}: PSNR {p}")
        res[kind] = {"ms_per_pose": ms, "rays_per_s": H * W / ms * 1e3,
                     "launches": launches, "timed_poses": n_timed,
                     "shards": dict(zip(names, shapes)), "peak_mem_gb": peak,
                     "psnr_vs_plain_f32": p, "host_wall_s": wall}
        del mc, mf, recs, shards
        torch.cuda.empty_cache()
    return res


def phase_teacher_frame(dev, poses) -> dict:
    """The teacher's frame (``--test_teacher``), fused against plain."""
    from r2l_tpu_torch.evaluate import make_nerf_frame_fn
    from r2l_tpu_torch.kernels import nerf_render as NR
    from r2l_tpu_torch.sampler import PointSampler
    cfg, mc, mf = teacher_models("f32", dev)
    sampler = PointSampler(H=H, W=W, focal=FOCAL, n_sample=T_SAMPLES,
                           near=2.0, far=6.0)
    res, frames = {}, {}
    NR.fused_nerf_render.launches = 0
    for kind, fused in (("plain", False), ("fused", True)):
        fn = make_nerf_frame_fn(mc, mf, cfg, teacher_vcfg(), sampler,
                                use_pallas=fused, device=dev)
        if fn.kind != kind:
            raise AssertionError(f"asked for {kind}, got {fn.kind}")
        fn(poses[0])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        frames[kind] = torch.stack([fn(p) for p in poses[:2]])
        end.record()
        torch.cuda.synchronize()
        res[kind] = {"ms_per_frame": start.elapsed_time(end) / 2}
    f = frames["fused"]
    if f.shape != (2, H, W, 3) or not torch.isfinite(f).all():
        raise AssertionError(f"teacher frames {tuple(f.shape)}")
    res["psnr_fused_vs_plain"] = p = psnr_db(f, frames["plain"])
    res["launches"] = NR.fused_nerf_render.launches
    print(f"[main] teacher frame (f32 weights): fused "
          f"{res['fused']['ms_per_frame']:.3f} ms/frame, plain "
          f"{res['plain']['ms_per_frame']:.3f} ms/frame, PSNR fused vs "
          f"plain {p:.2f} dB, K6 launches {res['launches']}", flush=True)
    if res["launches"] <= 0 or p < MIN_PSNR_TEACHER["f32"]:
        raise AssertionError(f"teacher frame: {res}")
    return res


def sphere_scene(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n training views (images [n, H, W, 3] f32, poses [n, 3, 4]) of a unit
    sphere at the origin coloured by its surface point (0.5 p + 0.5) on
    white, ray-traced in numpy (the formula of the verify recipe's scene
    generator, gen_scene.py, at 400x400 and the lego focal);
    poses on the radius-4 sphere, theta U[-180, 180], phi U[-60, -20]."""
    from r2l_tpu_torch.rays import pose_spherical
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W / 2) / FOCAL, -(j - H / 2) / FOCAL,
                     -np.ones_like(i)], -1)
    images, poses = [], []
    for _ in range(n):
        c2w = pose_spherical(rng.uniform(-180, 180), rng.uniform(-60, -20),
                             4.0)[:3, :4]
        rd = dirs @ c2w[:3, :3].T
        ro = np.broadcast_to(c2w[:3, 3], rd.shape)
        b = np.sum(ro * rd, -1)
        a = np.sum(rd * rd, -1)
        c = np.sum(ro * ro, -1) - 1.0
        disc = b * b - a * c
        t = (-b - np.sqrt(np.maximum(disc, 0))) / a
        col = np.clip((ro + rd * t[..., None]) * 0.5 + 0.5, 0, 1)
        images.append(np.where((disc > 0)[..., None], col, 1.0))
        poses.append(c2w)
    return (np.stack(images).astype(np.float32),
            np.stack(poses).astype(np.float32))


def timed_steps(run, n_warm: int, n_timed: int) -> dict:
    """``run(i) -> metrics`` for n_warm then n_timed steps: ms/step of the
    timed ones (CUDA events), the losses, the peak memory."""
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [run(i)["loss"] for i in range(n_warm)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses += [run(i)["loss"] for i in range(n_warm, n_warm + n_timed)]
    end.record()
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    return {"ms_per_step": start.elapsed_time(end) / n_timed,
            "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def check_falling(name: str, r: dict, k: int) -> None:
    """The mean of the last k losses below the mean of the first k, all
    finite."""
    ls = r["losses"]
    ok = all(np.isfinite(ls)) and np.mean(ls[-k:]) < np.mean(ls[:k])
    print(f"[main] {name}: {r['ms_per_step']:.3f} ms/step (CUDA events), "
          f"loss {np.mean(ls[:k]):.5f} -> {np.mean(ls[-k:]):.5f} (means of "
          f"the first and last {k} of {len(ls)}), peak "
          f"{r['peak_mem_gb']:.2f} GB"
          + (" ok" if ok else " FAILED: the loss did not fall"), flush=True)
    if not ok:
        raise AssertionError(f"{name}: loss did not fall: {ls}")


def teacher_eval_batches(images, poses, dev) -> list:
    """The teacher phases' fixed evaluation rays: 4,096 pixels of each of
    the first four images, inside the precrop box, as [n, 9] records."""
    from r2l_tpu_torch.train import _image_batch
    g = torch.Generator(dev).manual_seed(SEED + 56)
    hh, ww = (torch.randint(n // 4, 3 * n // 4, (EVAL_RAYS,), generator=g,
                            device=dev) for n in (H, W))
    return [_image_batch(images[k], poses[k], H, W, FOCAL, hh, ww)
            for k in range(4)]


def teacher_eval(state, cfg, vcfg, batches) -> float:
    """Mean fine-pass MSE of deterministic renders (no jitter, no sigma
    noise) of the fixed evaluation rays."""
    from r2l_tpu_torch.render import render_rays_nerf
    v = dataclasses.replace(vcfg, raw_noise_std=0.0)
    with torch.no_grad():
        return float(torch.stack([torch.mean((render_rays_nerf(
            state.model_c, state.model_f, cfg, v, b[:, 0:3], b[:, 3:6]
        ).rgb_map - b[:, 6:9]) ** 2) for b in batches]).mean())


def phase_teacher_train(images, poses, dev) -> dict:
    """``make_teacher_step`` (lego) and ``make_teacher_step_batched`` (fern's
    flags) through their entry points, random weights from seeded
    generators (lego's with the density floor: at random init its fine
    network's density is 0 at every point, where ReLU passes no gradient,
    and the loss of the evaluation rays does not move). Progress is the
    evaluation rays' MSE before the first step and after the last: the
    steps' own losses are of other images and pixels each step."""
    from r2l_tpu_torch.datagen import images_to_ray_records
    from r2l_tpu_torch.models import NeRFConfig, init_nerf
    from r2l_tpu_torch.render import VolRenderConfig
    from r2l_tpu_torch.train import (TeacherTrainConfig, init_teacher_state,
                                     make_teacher_step,
                                     make_teacher_step_batched)
    cfg = NeRFConfig()
    imgs = torch.from_numpy(images).to(dev)
    pss = torch.from_numpy(poses).to(dev)
    evals = teacher_eval_batches(imgs, pss, dev)
    res = {}

    def train(name, vcfg, tcfg, seed, floor, run_step):
        g = torch.Generator().manual_seed(seed)
        models = [init_nerf(cfg, g, dev) for _ in range(2)]
        with torch.no_grad():
            for m in models:
                m.alpha_linear.bias += floor
        box = [init_teacher_state(*models, tcfg)]
        gen = torch.Generator(dev).manual_seed(seed + 1)
        before = teacher_eval(box[0], cfg, vcfg, evals)

        def run(i):
            box[0], m = run_step(box[0], i, gen)
            return m
        r = timed_steps(run, TEACHER_WARMUP, TEACHER_TIMED)
        r["eval_mse_before"] = before
        r["eval_mse_after"] = after = teacher_eval(box[0], cfg, vcfg, evals)
        ls, ok = r["losses"], after < before and all(np.isfinite(r["losses"]))
        print(f"[main] {name}: {r['ms_per_step']:.3f} ms/step (CUDA events) "
              f"over {TEACHER_TIMED} steps, MSE of the {4 * EVAL_RAYS} "
              f"evaluation rays {before:.5f} -> {after:.5f} (the steps' "
              f"losses {np.mean(ls[:3]):.5f} -> {np.mean(ls[-3:]):.5f}), "
              f"peak {r['peak_mem_gb']:.2f} GB"
              + (" ok" if ok else " FAILED: the loss did not fall"),
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: {r}")
        return r

    vcfg = VolRenderConfig(n_coarse=T_SAMPLES, n_fine=T_FINE, perturb=True,
                           white_bkgd=True)
    tcfg = TeacherTrainConfig(n_rand=1024, lrate=5e-4, lrate_decay=500,
                              precrop_iters=500, precrop_frac=0.5)
    step = make_teacher_step(cfg, vcfg, tcfg, H, W, FOCAL, device=dev)
    res["images"] = train(
        "teacher lego (make_teacher_step, 64+128 samples, 1024 rays)", vcfg,
        tcfg, SEED + 50, DENSITY_FLOOR,
        lambda st, i, gen: step(st, imgs, pss, generator=gen))

    rng = np.random.default_rng(SEED + 53)
    pool_np = images_to_ray_records(images, poses, H, W, FOCAL, device=dev)
    pool = torch.from_numpy(pool_np[rng.permutation(len(pool_np))]).to(dev)
    vcfg_b = VolRenderConfig(n_coarse=64, n_fine=64, perturb=True,
                             raw_noise_std=1.0)
    tcfg_b = TeacherTrainConfig(n_rand=1024, lrate=5e-4, lrate_decay=250)
    step_b = make_teacher_step_batched(cfg, vcfg_b, tcfg_b, device=dev)
    res["batched"] = train(
        "teacher fern flags (make_teacher_step_batched, 64+64 samples, "
        f"sigma noise 1, pool of {pool.shape[0]} rays)", vcfg_b, tcfg_b,
        SEED + 54, 0.0,
        lambda st, i, gen: step_b(st, pool, i * tcfg_b.n_rand,
                                  generator=gen))
    res["batched"]["pool_rays"] = int(pool.shape[0])
    del pool
    torch.cuda.empty_cache()
    return res


def phase_images_distill(images, poses, sampler, dev) -> dict:
    """``make_distill_step_images`` with the README's images flags."""
    from r2l_tpu_torch.models import R2LConfig, init_r2l
    from r2l_tpu_torch.train import (DistillConfig, init_train_state,
                                     make_distill_step_images)
    cfg = R2LConfig(compute_dtype=torch.float32)
    dcfg = DistillConfig(batch_size=1024, lrate=5e-4, lrate_decay=500,
                         warmup_lr=IMAGES_WARMUP_LR, embed_L=EMBED_L,
                         perturb=True)
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED + 60), dev)
    box = [init_train_state(model, dcfg, device=dev)]
    step = make_distill_step_images(cfg, dcfg, sampler, H, W, FOCAL,
                                    precrop_iters=500, precrop_frac=0.5,
                                    device=dev)
    imgs = torch.from_numpy(images).to(dev)
    pss = torch.from_numpy(poses).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 61)

    def run(i):
        k = i % imgs.shape[0]
        box[0], m = step(box[0], imgs[k], pss[k], generator=gen)
        return m
    r = timed_steps(run, IMAGES_WARMUP, IMAGES_TIMED)
    check_falling("images distill (make_distill_step_images, W256/D88 f32, "
                  "1024 pixels)", r, k=len(images))
    del box[0], model
    torch.cuda.empty_cache()
    return r


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    deltas(got, want)
    same = torch.equal(got, want)
    print(f"[check] {name}: " + ("bit for bit ok" if same else
                                 f"{int((got != want).sum())} values DIFFER"),
          flush=True)
    if not same:
        raise AssertionError(f"{name} differs")


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor,
              tol_max: float, tol_rms: float) -> dict:
    """``check`` of the max-abs and RMS error relative to the largest
    |want|; returns the absolute max-abs error and the relative pair."""
    mx, rms = deltas(got, want)
    top = float(want.abs().max())
    check(f"{name}, relative to the largest |plain| {top:.3e}", mx / top,
          rms / top, tol_max, tol_rms)
    return {"max_abs_err": mx, "max_rel_err": mx / top,
            "rms_rel_err": rms / top}


def staged_chained_ref(x: torch.Tensor, w: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """The chained bf16 shape with every product summed in a k order of the
    kernel's: an f32 accumulator takes ``chunk`` input channels at a time,
    each chunk's sum exact (float64) and rounded once as it is added (16:
    one wgmma k16 step, the kernel's order, as an IEEE sum rounded to
    nearest would give it; 64: the ring's stage, if each stage were summed
    apart)."""
    h = x
    for i in range(w.shape[0]):
        hd, wd = h.double(), w[i].double()
        acc = torch.zeros((h.shape[0], wd.shape[0]), dtype=torch.float32,
                          device=h.device)
        for k0 in range(0, h.shape[1], chunk):
            acc = (acc.double() + hd[:, k0:k0 + chunk]
                   @ wd[:, k0:k0 + chunk].T).float()
        h = acc.to(torch.bfloat16)
    return h.double().sum(dim=1, keepdim=True).float()


def check_chained_bf16(PS, name: str, shape: tuple, gens: tuple,
                       dev) -> dict:
    """A chained bf16 shape against its plain version: at 64 layers on each
    generator's inputs, beside the plain version against itself with the
    channels permuted (its sums in another order); and at
    PROBE_SHAPES_SHALLOW layers on the first's, with the share of rows that
    differ, beside that share for the permuted plain version and for the
    plain versions summed in the kernel's k order (``staged_chained_ref``,
    16-channel wgmma steps and 64-channel stages), each against the plain
    version and the kernel."""
    M, K, N = shape
    perm = torch.randperm(K, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    res = {}
    for k, g in enumerate(gens):
        x, w = PS.shape_inputs(M, K, N, torch.bfloat16, g, device=dev)
        want = PS.unchained_ref(x, w, True)
        alt = PS.unchained_ref(x[:, perm], w[:, perm][:, :, perm], True)
        top = float(want.abs().max())
        spread = [v / top for v in deltas(alt, want)]
        r = res[f"inputs_{k}"] = check_rel(
            f"{name} vs plain, inputs {k} (the plain version permuted: "
            f"{spread[0]:.3e} / {spread[1]:.3e})", PS.unchained(x, w, True),
            want, *TOL_SHAPES_CHAINED)
        r["plain_permuted_rel_err"] = spread
        if k == 0:
            L = PROBE_SHAPES_SHALLOW
            xs, ws = x, w[:L]
            got, want = PS.unchained(xs, ws, True), PS.unchained_ref(
                xs, ws, True)
            r = res[f"{L}_layers"] = check_rel(
                f"{name} vs plain, {L} layers", got, want,
                *TOL_SHAPES_CHAINED_SHALLOW)
            r["differ_share"] = float((got != want).double().mean())
            others = {
                "plain_permuted": PS.unchained_ref(
                    xs[:, perm], ws[:, perm][:, :, perm], True),
                "staged_64": staged_chained_ref(xs, ws, 64),
                "staged_16": staged_chained_ref(xs, ws, 16)}
            for key, o in others.items():
                r[f"{key}_vs_plain_differ_share"] = float(
                    (o != want).double().mean())
                r[f"kernel_vs_{key}_differ_share"] = float(
                    (got != o).double().mean())
            print(f"[step0] {name}, {L} layers, share of rows that differ: "
                  f"kernel vs plain {r['differ_share']:.4f}; "
                  + "; ".join(
                      f"{key} vs plain {r[f'{key}_vs_plain_differ_share']:.4f}"
                      f", kernel vs {key} "
                      f"{r[f'kernel_vs_{key}_differ_share']:.4f}"
                      for key in others), flush=True)
            print(f"[check] {name}, {L} layers: {r['differ_share']:.3f} of "
                  f"the rows differ (limit {MAX_SHAPES_DIFFER_SHARE})",
                  flush=True)
            if r["differ_share"] > MAX_SHAPES_DIFFER_SHARE:
                raise AssertionError(f"{name}: too many rows differ")
            del others
    return res


def probe_checks(dev) -> dict:
    """Each probe kernel against its plain version at the probes' sizes,
    timed (kernel, plain, and the library call where there is one)."""
    from r2l_tpu_torch.exp import probe_mxu as PM
    from r2l_tpu_torch.exp import probe_shapes as PS

    def gen(k):
        return torch.Generator().manual_seed(SEED + 70 + k)
    x = torch.randn((PM.N_RAYS, PM.W), generator=gen(0)).to(dev)
    out_bytes = x.numel() * 4
    res = {}

    # The random chains decay (0.05-scaled weights): at the probe's depth
    # the outputs of none and bigN are about 1e-7 and smaller, so each is
    # also checked at a depth whose output is of order one.
    w, b = PM.variant_weights("full", gen(1), dev)
    img = PM.stage_chain(w)   # once, as the runner stages it
    r = res["probe_chain"] = {"max_abs_err": 0.0}
    for mode in PM.MODES:
        check_rel(f"probe_chain {mode} vs plain, 8 layers", PM.chain(
            x, w[:8], b[:8], mode), PM.chain_ref(x, w[:8], b[:8], mode),
            *TOL_PROBE_BF16["shallow"])
        got, want = PM.chain(x, w, b, mode), PM.chain_ref(x, w, b, mode)
        c = check_rel(f"probe_chain {mode} vs plain ({PM.N_LAYERS} layers, "
                      f"{x.shape[0]} rays)", got, want,
                      *TOL_PROBE_BF16["deep"])
        check_equal(f"probe_chain {mode}: dual vs single", PM.chain(
            x, w, b, mode, dual=True), got)
        r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
        r[mode] = {**c, "differ": int((got != want).sum()),
                   "ms": time_ms(lambda: PM.chain(x, w, b, mode,
                                                  staged=img)),
                   "dual_ms": time_ms(lambda: PM.chain(
                       x, w, b, mode, dual=True, staged=img))}
        del got, want
        print(f"[time] probe_chain {mode}: single {r[mode]['ms']:.3f} ms, "
              f"dual {r[mode]['dual_ms']:.3f} ms", flush=True)
    r["ms"] = r["full"]["ms"]
    r["staging_ms"] = time_ms(lambda: PM.stage_chain(w))
    r["plain_ms"] = time_ms(lambda: PM.chain_ref(x, w, b, "full"), reps=1)
    r.update(bound(PM.ops_per_frame("full"), nbytes(x, w, b) + out_bytes,
                   "bf16"), library_ms=None)
    print(f"[time] probe_chain: the weights' staging, once per weights, "
          f"{r['staging_ms']:.3f} ms", flush=True)
    del w, b, img

    w1, w2 = PM.variant_weights("bigN", gen(2), dev)
    img = PM.stage_bign(w1, w2)   # once, as the runner stages it
    r = res["probe_bign"] = {}
    for depth, P in (("shallow", 4), ("deep", PM.N_LAYERS // 2)):
        c = r[depth] = check_rel(
            f"probe_bign vs plain, {P} pairs", PM.bign(
                x, w1[:P], w2[:P], staged=img if P == w1.shape[0] else None),
            PM.bign_ref(x, w1[:P], w2[:P]), *TOL_PROBE_BF16[depth])
        c["share_of_limit"] = [c["max_rel_err"] / TOL_PROBE_BF16[depth][0],
                               c["rms_rel_err"] / TOL_PROBE_BF16[depth][1]]
        print(f"[margin] probe_bign, {P} pairs: max-abs "
              f"{c['max_rel_err']:.3e} is {c['share_of_limit'][0]:.1%} of "
              f"{TOL_PROBE_BF16[depth][0]:g}, RMS {c['rms_rel_err']:.3e} "
              f"{c['share_of_limit'][1]:.1%} of {TOL_PROBE_BF16[depth][1]:g} "
              f"(the tensor cores truncate each k16 step's sum; K = 512 "
              f"in the second product)", flush=True)
    r.update({k: r["deep"][k] for k in ("max_abs_err", "max_rel_err",
                                         "rms_rel_err")})
    r.update(ms=time_ms(lambda: PM.bign(x, w1, w2, staged=img)),
             staging_ms=time_ms(lambda: PM.stage_bign(w1, w2)),
             plain_ms=time_ms(lambda: PM.bign_ref(x, w1, w2), reps=1),
             **bound(PM.ops_per_frame("bigN"),
                     nbytes(x, w1, w2) + out_bytes, "bf16"),
             library_ms=None)
    print(f"[time] probe_bign: the weights' staging, once per weights, "
          f"{r['staging_ms']:.3f} ms", flush=True)
    del w1, w2, img

    wq, s = PM.variant_weights("int8_static", gen(3), dev)
    img = PM.stage_int8_chain(wq, s)   # once, as the runner stages it
    for L in (*PROBE_INT8_DEPTHS, PM.N_LAYERS):
        got = PM.int8_chain(x, wq[:L], s[:L],
                            staged=img if L == wq.shape[0] else None)
        check_equal(f"probe_int8_chain vs plain, {L} layers", got,
                    PM.int8_chain_ref(x, wq[:L], s[:L]))
        nonzero = int((got != 0).sum())
        print(f"[check] probe_int8_chain, {L} layers: {nonzero} of "
              f"{got.numel()} outputs non-zero", flush=True)
        if L in PROBE_INT8_DEPTHS and nonzero == 0:
            raise AssertionError(f"probe_int8_chain at {L} layers is all 0")
    res["probe_int8_chain"] = {
        "max_abs_err": 0.0, "nonzero_at_86": nonzero,
        "ms": time_ms(lambda: PM.int8_chain(x, wq, s, staged=img)),
        "staging_ms": time_ms(lambda: PM.stage_int8_chain(wq, s)),
        "plain_ms": time_ms(lambda: PM.int8_chain_ref(x, wq, s), reps=1),
        **bound(PM.ops_per_frame("int8_static"),
                nbytes(x, wq, s) + out_bytes, "int8"), "library_ms": None}
    print(f"[time] probe_int8_chain: the image's staging, once per "
          f"weights, {res['probe_int8_chain']['staging_ms']:.3f} ms",
          flush=True)
    del got, wq, s, x, img

    r = res["probe_shapes"] = {"max_abs_err": 0.0, "bf16_max_rel_err": 0.0,
                               "bf16_chained": {}}
    for i, (dtype, (M, K, N), chained) in enumerate(
            [(dt, shape, False) for dt in (torch.int8, torch.bfloat16)
             for shape in PS.SHAPES]
            + [(dt, shape, True) for dt in (torch.int8, torch.bfloat16)
               for shape in PS.SHAPES if shape[1] == shape[2]]):
        name = f"probe_shapes {PS.shape_name(M, K, N, dtype, chained)}"
        if dtype == torch.bfloat16 and chained:
            c = r["bf16_chained"][name] = check_chained_bf16(
                PS, name, (M, K, N), (gen(10 + i), gen(40 + i)), dev)
            r["bf16_max_rel_err"] = max(r["bf16_max_rel_err"], *(
                c[f"inputs_{k}"]["max_rel_err"] for k in (0, 1)))
            continue
        xs, ws = PS.shape_inputs(M, K, N, dtype, gen(10 + i), device=dev)
        got = PS.unchained(xs, ws, chained)
        want = PS.unchained_ref(xs, ws, chained)
        if dtype == torch.int8:
            check_equal(f"{name} vs plain", got, want)
        else:
            c = check_rel(f"{name} vs plain", got, want, *TOL_SHAPES_FREE)
            r["bf16_max_rel_err"] = max(r["bf16_max_rel_err"],
                                        c["max_rel_err"])
            if (M, K, N) == PS.SHAPES[0] and not chained:
                # mma_rounding's mma.sync instrument computes the function
                c = r["mma_sync_vs_plain"] = check_rel(
                    f"{name} on the mma.sync instrument vs plain",
                    PS.mma_sync_sum(xs, ws), want, *TOL_SHAPES_FREE)
        if (M, K, N) == PS.SHAPES[0] and not chained:
            kind = "int8" if dtype == torch.int8 else "bf16"
            st = PS.stage_shape_weights(ws, False)   # once, as the runner
            t = {"ms": time_ms(lambda: PS.unchained(xs, ws, False, st)),
                 "staging_ms": time_ms(
                     lambda: PS.stage_shape_weights(ws, False)),
                 "plain_ms": time_ms(lambda: PS.unchained_ref(xs, ws),
                                     reps=1),
                 **bound(2.0 * xs.shape[0] * K * N * ws.shape[0],
                         nbytes(xs, ws, got), kind)}
            # the library call: the 64 products alone, without the sum
            # (bf16 [64, rows, N]; int8 [rows, 64 N] int32)
            if kind == "bf16":
                wt = ws.transpose(1, 2)
                t["library"] = "torch.matmul"
                t["library_ms"] = time_ms(lambda: torch.matmul(xs, wt))
            else:
                wt = ws.reshape(-1, K).t()   # [K, 64 N], column-major
                t["library"] = "torch._int_mm"
                t["library_ms"] = time_ms(lambda: torch._int_mm(xs, wt))
            r[kind] = t
            print(f"[time] {name}: kernel {t['ms']:.3f} ms (its weights' "
                  f"staging, once per weights, {t['staging_ms']:.3f} ms), "
                  f"plain {t['plain_ms']:.3f} ms, bound "
                  f"{t['bound_ms']:.3f} ms, "
                  f"{t['library']} of the 64 products (no sum) "
                  f"{t['library_ms']:.3f} ms", flush=True)
        del xs, ws, got, want
    # one instruction, and two in turn: mma.sync through the pre-Hopper
    # instrument, wgmma through the kernel; each truncates (ROADMAP C), and
    # wgmma reads as mma.sync to every digit
    before = PS.mma_sync_sum.launches
    for engine, key in (("mma.sync", "mma_rounding"),
                        ("wgmma", "wgmma_rounding")):
        for k in (16, 32):
            m = r[f"{key}_k{k}"] = PS.mma_rounding(k, device=dev,
                                                   engine=engine)
            print(f"[step0] one {engine}, k={k}: {m['differ_share']:.4f} of "
                  f"rows differ from the f32 round-to-nearest of the exact "
                  f"sum, by at most {m['max_ulp']:.1f} ulp of the result; "
                  f"{m['smaller_magnitude_share']:.3f} of those have the "
                  f"smaller magnitude; at most "
                  f"{m['max_err_in_top_ulp']:.2f} ulp of the largest product "
                  f"from the exact sum", flush=True)
            if not (m["differ_share"] > MIN_MMA_DIFFER_SHARE
                    and m["smaller_magnitude_share"] > MIN_MMA_TRUNCATED_SHARE
                    and m["max_err_in_top_ulp"] <= k):
                raise AssertionError(f"one {engine}, k={k}: not the "
                                     f"truncating sum of ROADMAP C: {m}")
        if engine == "wgmma":
            for k in (16, 32):
                if ({**r[f"mma_rounding_k{k}"], "engine": "wgmma"}
                        != r[f"wgmma_rounding_k{k}"]):
                    raise AssertionError(f"one wgmma, k={k}, does not read "
                                         f"as one mma.sync")
    r["mma_sync_launches"] = PS.mma_sync_sum.launches - before
    print(f"[main] mma.sync instrument launches: {r['mma_sync_launches']}",
          flush=True)
    if r["mma_sync_launches"] != 2:
        raise AssertionError("mma_rounding did not read through mma.sync")
    r.update({k: r["int8"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})
    for key in ("probe_chain", "probe_bign", "probe_int8_chain"):
        q = res[key]
        print(f"[time] {key}: kernel {q['ms']:.3f} ms, plain "
              f"{q['plain_ms']:.3f} ms, bound {q['bound_ms']:.3f} ms "
              f"({q['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    return res


def phase_probes(dev) -> dict:
    """Phase 12: the probe kernels against their plain versions, then the
    two probe runners as a user runs them (``probe_mxu.main``,
    ``probe_shapes.main``: their JSON records print on lines of their own),
    each kernel's count set to 0 just before the runners and read just
    after."""
    from r2l_tpu_torch.exp import probe_mxu as PM
    from r2l_tpu_torch.exp import probe_shapes as PS
    res = probe_checks(dev)
    counted = {"probe_chain": PM.chain, "probe_bign": PM.bign,
               "probe_int8_chain": PM.int8_chain,
               "probe_shapes": PS.unchained}
    for f in counted.values():
        f.launches = 0
    records = PM.main([]) + PS.main([])
    torch.cuda.synchronize()
    res["launches"] = {k: f.launches for k, f in counted.items()}
    print(f"[main] probe kernel launches in the runners: {res['launches']}",
          flush=True)
    for name, count in res["launches"].items():
        if count <= 0:
            raise AssertionError(f"the probe runners never launched {name}")
    res["runners"] = {r["name"]: r.get("ms_per_frame") for r in records
                     if "ms_per_frame" in r}
    return res


def check_nonzero(name: str, got: torch.Tensor) -> None:
    nonzero = int((got != 0).sum())
    print(f"[check] {name}: {nonzero} of {got.numel()} outputs non-zero",
          flush=True)
    if nonzero == 0:
        raise AssertionError(f"{name} is all 0")


def k2_probe_checks(dev) -> dict:
    """Phase 13's checks: each of K2's probe kernels against its plain
    version at the probes' sizes, timed (kernel, plain)."""
    from r2l_tpu_torch.evaluate import _calibration_points
    from r2l_tpu_torch.exp._harness import chain_ops
    from r2l_tpu_torch.exp import probe_epi as PE
    from r2l_tpu_torch.exp import probe_int8 as PI
    from r2l_tpu_torch.exp import probe_mxu as PM
    from r2l_tpu_torch.exp import probe_pipe_lib as PL
    from r2l_tpu_torch.exp import probe_wall as PW
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.models import R2LConfig, init_r2l
    from r2l_tpu_torch.sampler import PointSampler
    x = torch.randn((PI.N_RAYS, PI.W), generator=torch.Generator(
        ).manual_seed(SEED + 80)).to(dev)
    out_bytes = x.numel() * 4
    res = {}

    # The ResMLP body: int8 bit for bit at 2 and 43 blocks, dual bit for
    # bit the single; the bf16 control at the chains' relative bounds.
    r = res["probe_resmlp"] = {"max_abs_err": 0.0}
    for name in ("int8_resmlp", "int8_resmlp_fold", "bf16_resmlp"):
        body = PI.variant_body(name)[0]
        w, m, b = PI.variant_weights(name, dev)
        for nb, tols in ((PROBE_RESMLP_SHALLOW, TOL_PROBE_RESMLP_BF16_SHALLOW),
                         (PI.N_BLOCKS, TOL_PROBE_BF16["deep"])):
            ws = (w[:2 * nb], None if m is None else m[:2 * nb], b[:2 * nb])
            label = f"probe_resmlp {body} vs plain, {nb} blocks"
            got, want = PI.resmlp(x, *ws, body=body), PI.resmlp_ref(
                x, *ws, body=body)
            if body == "bf16":
                c = check_rel(label, got, want, *tols)
                r["bf16_max_rel_err" if nb == PI.N_BLOCKS
                  else "bf16_shallow_max_rel_err"] = c["max_rel_err"]
                r["bf16_max_abs_err"] = c["max_abs_err"]
            else:
                check_equal(label, got, want)
            check_nonzero(label, got)
            check_equal(f"probe_resmlp {body}, {nb} blocks: dual vs single",
                        PI.resmlp(x, *ws, body=body, dual=True), got)
            del got, want
        img = PI.stage_resmlp(w, m, b, body)   # once, as the runner
        r[body] = {"ms": time_ms(lambda: PI.resmlp(x, w, m, b, body=body,
                                                   staged=img)),
                   "dual_ms": time_ms(lambda: PI.resmlp(
                       x, w, m, b, body=body, dual=True, staged=img)),
                   "staging_ms": time_ms(lambda: PI.stage_resmlp(w, m, b,
                                                                 body)),
                   "plain_ms": time_ms(lambda: PI.resmlp_ref(x, w, m, b,
                                                             body=body),
                                       reps=1),
                   **bound(PI.ops_per_frame(), nbytes(x, w, m, b) + out_bytes,
                           "bf16" if body == "bf16" else "int8"),
                   "library_ms": None}
        print(f"[time] probe_resmlp {body}: single {r[body]['ms']:.3f} ms, "
              f"dual {r[body]['dual_ms']:.3f} ms, plain "
              f"{r[body]['plain_ms']:.3f} ms, bound "
              f"{r[body]['bound_ms']:.3f} ms, the weights' staging, once "
              f"per weights, {r[body]['staging_ms']:.3f} ms", flush=True)
        del w, m, b, img
    r.update({k: r["int8"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})

    # The wall: every mode bit for bit at 4 layers and 86; realistic decays
    # to 0 by 8 layers (m = 1e-3), so it is non-zero only at 4.
    w, m = PW.make_weights(torch.Generator().manual_seed(SEED + 81),
                           device=dev)
    img = PM.stage_int8_chain(w, m)   # once, for the three modes
    r = res["probe_wall"] = {"max_abs_err": 0.0}
    for mode in PW.MODES:
        for L in (PROBE_WALL_SHALLOW, PW.N_LAYERS):
            label = f"probe_wall {mode} vs plain, {L} layers"
            got = PW.wall(x, w[:L], m[:L], mode,
                          staged=img if L == w.shape[0] else None)
            check_equal(label, got, PW.wall_ref(x, w[:L], m[:L], mode))
            if mode != "realistic" or L == PROBE_WALL_SHALLOW:
                check_nonzero(label, got)
            del got
        r[mode] = {"ms": time_ms(lambda: PW.wall(x, w, m, mode,
                                                 staged=img)),
                   "plain_ms": time_ms(lambda: PW.wall_ref(x, w, m, mode),
                                       reps=1)}
        print(f"[time] probe_wall {mode}: kernel {r[mode]['ms']:.3f} ms, "
              f"plain {r[mode]['plain_ms']:.3f} ms", flush=True)
    r.update(ms=r["mxu_only"]["ms"], plain_ms=r["mxu_only"]["plain_ms"],
             staging_ms=time_ms(lambda: PM.stage_int8_chain(w, m)),
             **bound(PW.ops_per_frame(), nbytes(x, w) + out_bytes, "int8"),
             library_ms=None)
    print(f"[time] probe_wall: the image's staging, once per weights, "
          f"{r['staging_ms']:.3f} ms", flush=True)
    del w, m, x, img

    # K2 whole on one 400x400 lego frame of the canonical student, packed as
    # phase 3 packs it (and unfolded, for the epilogue probe's v0).
    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), dev)
    sampler = PointSampler(H=H, W=W, focal=FOCAL, n_sample=N_SAMPLE,
                           near=2.0, far=6.0)
    poses = lego_poses(K)
    dp = cfg.input_dim // (2 * EMBED_L + 1)
    pts = sampler.sample_test(torch.as_tensor(poses[3], device=dev))
    calib = _calibration_points(sampler, poses, dev)
    fps = {fold: F.calibrate_r2l_int8_pe(model, cfg, dp, EMBED_L, calib,
                                         fold_requant=fold)
           for fold in (True, False)}
    del model
    ops = chain_ops(cfg, pts.shape[0], cfg.input_dim)
    fp = fps[True]
    k2 = F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, EMBED_L)
    r = res["probe_pipe"] = {}
    want = PL.apply_int8_pe_streams_ref(fp, cfg, pts, dp, EMBED_L)
    check_equal("probe_pipe's plain version vs K2", want, k2)
    for s in PL.STREAMS:
        got = PL.apply_int8_pe_streams(fp, cfg, pts, dp, EMBED_L, streams=s)
        check_equal(f"probe_pipe S={s} vs K2", got, k2)
        check_equal(f"probe_pipe S={s} vs plain", got, want)
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0),
                               deltas(got, want)[0])
    del want
    # S = 1, 2, 4 and K2 deployed timed in turns, there and back
    runs = {f"streams{s}": lambda s=s: PL.apply_int8_pe_streams(
        fp, cfg, pts, dp, EMBED_L, streams=s) for s in PL.STREAMS}
    runs["k2"] = lambda: F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, EMBED_L)
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(time_ms(runs[k]))
    for k, ts in times.items():
        r[f"{k}_ms"] = sum(ts) / len(ts)
    r.update(ms=r["streams2_ms"], plain_ms=time_ms(
        lambda: PL.apply_int8_pe_streams_ref(fp, cfg, pts, dp, EMBED_L),
        reps=1), **bound(ops, nbytes(pts, k2, *fp), "int8"),
        library_ms=None)
    print(f"[time] probe_pipe (K2's Hopper schedules, in turns): S=1 "
          f"{r['streams1_ms']:.3f} ms, S=2 {r['streams2_ms']:.3f} ms, S=4 "
          f"{r['streams4_ms']:.3f} ms, K2 deployed {r['k2_ms']:.3f} ms, "
          f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms at "
          f"{pts.shape[0]} rays", flush=True)

    r = res["probe_epi"] = {"max_abs_err": 0.0}
    for fold, fp in fps.items():
        outs = {}
        for v in PE.VARIANTS:
            got = outs[v] = PE.apply_variant(fp, cfg, pts, dp, EMBED_L, v)
            mx, rms = deltas(got, PE.apply_variant_ref(fp, cfg, pts, dp,
                                                       EMBED_L, v))
            check(f"probe_epi v{v} vs plain, fold_requant={fold}", mx, rms,
                  TOL_INT8_MAX, TOL_INT8_RMS)
            r["max_abs_err"] = max(r["max_abs_err"], mx)
        check_equal(f"probe_epi v0 vs K2 unfolded, fold_requant={fold}",
                    outs[0], F.fused_r2l_apply_int8_pe(
                        fp, cfg, pts, dp, EMBED_L, fold_requant=False,
                        nobf16_inner=False))
        check_equal(f"probe_epi v2 vs v1, fold_requant={fold}", outs[2],
                    outs[1])
        del outs
    fp = fps[True]     # the driver's packing
    runs = {f"v{v}": lambda v=v: PE.apply_variant(fp, cfg, pts, dp, EMBED_L,
                                                  v) for v in PE.VARIANTS}
    runs["k2_unfolded"] = lambda: F.fused_r2l_apply_int8_pe(
        fp, cfg, pts, dp, EMBED_L, fold_requant=False, nobf16_inner=False)
    runs["k2_deployed"] = lambda: F.fused_r2l_apply_int8_pe(
        fp, cfg, pts, dp, EMBED_L)
    times = {k: [] for k in runs}   # in turns, there and back
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(time_ms(runs[k]))
    for k, ts in times.items():
        r[f"{k}_ms"] = sum(ts) / len(ts)
    r.update(ms=r["v1_ms"], plain_ms=time_ms(
        lambda: PE.apply_variant_ref(fp, cfg, pts, dp, EMBED_L, 1), reps=1),
        **bound(ops, nbytes(pts, k2, *fp), "int8"), library_ms=None)
    print(f"[time] probe_epi (K2's Hopper forms): v0 {r['v0_ms']:.3f} ms, "
          f"v1 {r['v1_ms']:.3f} ms, v2 {r['v2_ms']:.3f} ms, K2 unfolded "
          f"{r['k2_unfolded_ms']:.3f} ms, K2 deployed "
          f"{r['k2_deployed_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms at {pts.shape[0]} rays", flush=True)
    del fps, fp, k2
    torch.cuda.empty_cache()
    return res


def phase_k2_probes(dev) -> dict:
    """Phase 13: K2's probe kernels against their plain versions, then the
    four runners as a user runs them (their JSON records print on lines of
    their own), each kernel's count set to 0 just before the runners and
    read just after."""
    from r2l_tpu_torch.exp import probe_epi as PE
    from r2l_tpu_torch.exp import probe_int8 as PI
    from r2l_tpu_torch.exp import probe_pipe as PP
    from r2l_tpu_torch.exp import probe_pipe_lib as PL
    from r2l_tpu_torch.exp import probe_wall as PW
    res = k2_probe_checks(dev)
    counted = {"probe_resmlp": PI.resmlp, "probe_wall": PW.wall,
               "probe_pipe": PL.apply_int8_pe_streams,
               "probe_epi": PE.apply_variant}
    for f in counted.values():
        f.launches = 0
    records = PI.main([]) + PW.main([]) + PP.main([]) + PE.main([])
    torch.cuda.synchronize()
    res["launches"] = {k: f.launches for k, f in counted.items()}
    print(f"[main] K2 probe kernel launches in the runners: "
          f"{res['launches']}", flush=True)
    for name, count in res["launches"].items():
        if count <= 0:
            raise AssertionError(f"the probe runners never launched {name}")
    res["runners"] = {r.get("name", r.get("variant")): r["ms_per_frame"]
                      for r in records if "ms_per_frame" in r}
    return res


def phase_qdx(dev) -> dict:
    """Phase 14: the int8-dL/dx kernel against its plain version at the
    driver's size, timed, then the runner as a user runs it, the kernel's
    count set to 0 just before and read just after."""
    from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
    from r2l_tpu_torch.exp._harness import PEAK_OPS
    from r2l_tpu_torch.kernels import r2l_train as T
    cfg, body_w, fp, stash, dh0 = PQ.setup(dev)
    n, nb, W, gb = dh0.shape[0], cfg.num_blocks, cfg.netwidth, PQ.GB
    img = T.stage_qdx_weights(fp.body_q)   # once per calibration
    scales = {"probe": 1.0 / fp.body_inv,
              "unit": (torch.rand(fp.body_inv.shape, generator=torch.Generator(
                  ).manual_seed(SEED + 90)) * 1.5 + 0.5).to(dev)}
    res = {"max_abs_err": 0.0, "max_dw_rel_err": 0.0}

    def group(fn, b0, cnt, kind, dh):
        dts = torch.empty((2 * cnt, n, W), dtype=torch.bfloat16, device=dev)
        out = fn(body_w, fp.body_q, fp.body_m, stash, dh, cfg, b0, cnt,
                 PQ.TILE, scales[kind], dts, staged=img)
        return out, dts

    def compare(label, got, want):
        (dh, dw, db), dts = got
        (dh_p, dw_p, db_p), dts_p = want
        check_equal(f"{label}: dh vs plain", dh, dh_p)
        check_equal(f"{label}: dt scratch vs plain", dts, dts_p)
        res["max_abs_err"] = max(res["max_abs_err"], deltas(dw, dw_p)[0],
                                 deltas(db, db_p)[0])
        err = max(grad_err(dw, dw_p)[0], grad_err(db, db_p)[0])
        check(f"{label}: dW, db norm-relative vs plain", err, 0.0, TOL_QDX_DW)
        res["max_dw_rel_err"] = max(res["max_dw_rel_err"], err)

    b0 = nb - gb
    for kind in scales:
        label = f"bwd_group_qdx, {kind} scale, blocks {b0}..{nb - 1}"
        got = group(PQ.bwd_group_qdx, b0, gb, kind, dh0)
        want = group(PQ.bwd_group_qdx_ref, b0, gb, kind, dh0)
        compare(label, got, want)
        again = group(PQ.bwd_group_qdx, b0, gb, kind, dh0)
        for a, b in zip(got[0] + (got[1],), again[0] + (again[1],)):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: two runs differ")
        moved = float((got[0][0] != dh0).double().mean())
        print(f"[check] {label}: two runs bit-identical; the group changed "
              f"{moved:.4f} of dh's entries", flush=True)
        res[f"{kind}_dh_changed"] = moved
        if kind == "probe":
            # where dW's gap to the plain version sits: each against dW in
            # float64 from the kernel's own dt scratch
            dts = got[1]
            for name, dw in (("kernel", got[0][1]), ("plain", want[0][1])):
                errs = []
                for k in range(gb):
                    h_in, t1r, _ = T._group_inputs(stash, nb, b0 + k,
                                                   torch.bfloat16, scales[kind])
                    for l, a in ((2 * k + 1, t1r), (2 * k, h_in)):
                        errs.append(grad_err(
                            dw[l], dts[l].double().T @ a.double())[0])
                res[f"{name}_dw_rel_err_vs_f64"] = errs
                print(f"[check] {label}: {name} dW per layer vs float64, "
                      f"norm-relative {min(errs):.3e}..{max(errs):.3e}",
                      flush=True)
            # the top layer's dt is the same on both sides, and its dW and
            # db come from K5's own passes: K5's bit for bit
            _, dw5, db5 = T.bwd_group(body_w, stash, dh0, cfg, b0, gb,
                                      body_scale=scales[kind],
                                      staged=T.stage_bwd_weights(body_w))
            check_equal(f"{label}: top layer's dW vs K5's", got[0][1][-1],
                        dw5[-1])
            check_equal(f"{label}: top layer's db vs K5's", got[0][2][-1],
                        db5[-1])
            del dw5, db5
        del got, want, again
        # the whole walk, group by group, the 3-block last group included
        dh_k, dh_p, b = dh0, dh0, nb
        while b > 0:
            cnt = min(gb, b)
            b -= cnt
            got = group(PQ.bwd_group_qdx, b, cnt, kind, dh_k)
            want = group(PQ.bwd_group_qdx_ref, b, cnt, kind, dh_p)
            compare(f"bwd_group_qdx walk, {kind} scale, blocks "
                    f"{b}..{b + cnt - 1}", got, want)
            dh_k, dh_p = got[0][0], want[0][0]
            del got, want
        torch.cuda.empty_cache()
    print(f"[margin] bwd_group_qdx dW, db vs plain (K5's wgmma pass): "
          f"{res['max_dw_rel_err']:.3e} norm-relative at worst over both "
          f"scales and every group, "
          f"{100 * res['max_dw_rel_err'] / TOL_QDX_DW:.1f}% of {TOL_QDX_DW}",
          flush=True)

    sc = scales["probe"]

    def call(fn):
        return fn(body_w, fp.body_q, fp.body_m, stash, dh0, cfg, b0, gb,
                  PQ.TILE, sc, staged=img)

    ops = 2 * gb * PQ.walk_ops(cfg, n)     # per product kind, one call
    k5_img = T.stage_bwd_weights(body_w)
    t_ops = (ops / PEAK_OPS["int8"] + ops / PEAK_OPS["bf16"]) * 1e3
    dh_out = call(PQ.bwd_group_qdx)
    moved = (nbytes(dh0, *dh_out, fp.body_q[2 * b0:], fp.body_m[2 * b0:],
                    sc[2 * b0:]) + nbytes(stash[0]) * 2 * gb)
    t_bytes = moved / HBM_BYTES_S * 1e3
    res.update(
        ms=time_ms(lambda: call(PQ.bwd_group_qdx)),
        plain_ms=time_ms(lambda: call(PQ.bwd_group_qdx_ref), reps=1),
        k5_ms=time_ms(lambda: T.bwd_group(body_w, stash, dh0, cfg, b0, gb,
                                          body_scale=sc, staged=k5_img)),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None)
    res["stage_ms"] = time_ms(lambda: T.stage_qdx_weights(fp.body_q))
    images = {"qdx": img, "bf16": k5_img}
    for v in PQ.VARIANTS:
        res[f"walk_{v}_ms"] = time_ms(lambda: PQ.walk(
            v, cfg, body_w, fp, stash, dh0, staged=images[v]), reps=5)
        res[f"walk_{v}_bound_ms"] = PQ.walk_bound_ms(v, cfg, n)
    print(f"[time] bwd_group_qdx: kernel {res['ms']:.3f} ms per 4-block "
          f"call (K5 {res['k5_ms']:.3f}), plain {res['plain_ms']:.3f} ms, "
          f"bound {res['bound_ms']:.3f} ms ({res['bound_by']}); walk qdx "
          f"{res['walk_qdx_ms']:.3f} ms (bound "
          f"{res['walk_qdx_bound_ms']:.3f}), bf16 {res['walk_bf16_ms']:.3f} "
          f"ms (bound {res['walk_bf16_bound_ms']:.3f}) at {n} rays; the "
          f"dx products' image staged once per calibration "
          f"{res['stage_ms']:.3f} ms", flush=True)
    del dh_out, k5_img, images

    PQ.bwd_group_qdx.launches = 0
    PQ.walk("qdx", cfg, body_w, fp, stash, dh0, staged=img)
    torch.cuda.synchronize()
    per_walk = PQ.bwd_group_qdx.launches
    print(f"[check] bwd_group_qdx launches in one walk: {per_walk} (want "
          f"{-(-nb // gb)})", flush=True)
    if per_walk != -(-nb // gb):
        raise AssertionError("a qdx walk launched the kernel "
                             f"{per_walk} times")
    del cfg, body_w, fp, stash, dh0, scales, img
    torch.cuda.empty_cache()

    PQ.bwd_group_qdx.launches = 0
    records = PQ.main([])
    torch.cuda.synchronize()
    res["launches"] = PQ.bwd_group_qdx.launches
    walks = 1 + PQ.N_WALKS * (1 + PQ.REPS)
    print(f"[main] bwd_group_qdx launches in the runner: {res['launches']} "
          f"({walks} qdx walks)", flush=True)
    if res["launches"] != per_walk * walks:
        raise AssertionError("the runner's launches are not 11 per walk")
    rec = {r["name"]: r for r in records if "name" in r}
    cos = rec["r3_qdx_cosine"]
    for key in ("cos_dh", "min_cos_dw_group"):
        ok = np.isfinite(cos[key]) and 0.0 < cos[key] <= 1.0
        print(f"[check] runner {key} {cos[key]!r} in (0, 1]"
              + (" ok" if ok else " FAILED"), flush=True)
        if not ok:
            raise AssertionError(f"runner {key} outside (0, 1]")
    res["runner"] = {"cos_dh": cos["cos_dh"],
                     "min_cos_dw_group": cos["min_cos_dw_group"],
                     **{f"walk_{v}_ms": rec[f"r3_qdx_walk_{v}"]["ms"]
                        for v in PQ.VARIANTS}}
    return res


def givenrays_frames(fn, ros, rds) -> torch.Tensor:
    f = torch.stack([fn(ro, rd) for ro, rd in zip(ros, rds)])
    if f.shape != (len(ros), H, W, 3) or not torch.isfinite(f).all():
        raise AssertionError(f"given-rays {fn.kind}: bad frames "
                             f"{tuple(f.shape)}")
    return f


def golden_metrics(dev) -> dict:
    """SSIM, FLIP and minmax FLIP of tests/fixtures/metrics_golden.npz on
    the card against the reference's frozen values and the CPU's; beside
    them, what SSIM and FLIP read with TF32 convolutions."""
    from r2l_tpu_torch import flip as TF
    from r2l_tpu_torch import metrics as TM
    from r2l_tpu_torch.lpips import minmax_rescale
    d = np.load(REPO / "tests" / "fixtures" / "metrics_golden.npz")

    def values(device, impl=False):
        gts = torch.from_numpy(d["gts"]).to(device)
        imgs = torch.from_numpy(d["imgs"]).to(device)
        if impl:   # the metrics' bodies under the caller's flags
            return {"ssim": [float(TM._ssim_impl(i, g))
                             for g, i in zip(gts, imgs)],
                    "flip": [float(TF._flip_impl(g, i, TF.DEFAULT_PPD)
                                   .mean()) for g, i in zip(gts, imgs)]}
        g_mm = torch.clamp(minmax_rescale(gts), 0.0, 1.0)
        i_mm = torch.clamp(minmax_rescale(imgs), 0.0, 1.0)
        return {"ssim": [float(TM.ssim(i, g)) for g, i in zip(gts, imgs)],
                "flip": [float(TF.flip(g, i)) for g, i in zip(gts, imgs)],
                "flip_minmax": [float(TF.flip(g, i))
                                for g, i in zip(g_mm, i_mm)]}

    card, cpu = values(dev), values(torch.device("cpu"))
    res = {"card": card, "cpu": cpu}
    for name, gold in (("ssim", GOLD_SSIM), ("flip", GOLD_FLIP),
                       ("flip_minmax", GOLD_FLIP)):
        for label, ref, (rtol, atol) in (
                ("the fixture", np.asarray(d[name], np.float64), gold),
                ("the CPU", np.asarray(cpu[name]), CARD_VS_CPU)):
            err = np.abs(np.asarray(card[name]) - ref)
            ok = bool(np.all(err <= atol + rtol * np.abs(ref)))
            print(f"[check] {name} on the card vs {label}: max-abs "
                  f"{err.max():.3e} (rtol {rtol:.0e}, atol {atol:.0e})"
                  + (" ok" if ok else " FAILED"), flush=True)
            if not ok:
                raise AssertionError(f"{name} on the card vs {label}")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = values(dev, impl=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    res["tf32_max_abs"] = {
        k: float(np.abs(np.asarray(tf32[k]) - np.asarray(card[k])).max())
        for k in tf32}
    print(f"[main] with TF32 convolutions the fixture would read SSIM "
          f"{res['tf32_max_abs']['ssim']:.3e} and FLIP "
          f"{res['tf32_max_abs']['flip']:.3e} max-abs from these", flush=True)
    return res


def phase_givenrays(cfg, sampler, poses, pose_frames, dev) -> dict:
    """Phase 15 (a, b): the given-rays path on the K lego poses' own rays,
    then the eval loop over N_EVAL_FRAMES of them, then the metrics on the
    card."""
    from r2l_tpu_torch.evaluate import (make_r2l_givenrays_bench_fn,
                                        make_r2l_givenrays_frame_fn,
                                        render_path_given_rays)
    from r2l_tpu_torch.flip import flip
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.lpips import init_lpips, lpips
    from r2l_tpu_torch.metrics import frame_metrics
    from r2l_tpu_torch.models import init_r2l
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), dev)
    pairs = [sampler.frame_rays(torch.as_tensor(p, dtype=torch.float32,
                                                device=dev)) for p in poses]
    ros = torch.stack([o for o, _ in pairs])
    rds = torch.stack([d for _, d in pairs])
    res, fns, given = {}, {}, {}
    F.fused_r2l_apply_pe.launches = 0
    F.fused_r2l_apply_int8_pe.launches = 0
    for kind, quantize in (("pe", ""), ("int8", "int8")):
        fn = make_r2l_givenrays_frame_fn(model, cfg, sampler, H, W,
                                         embed_L=EMBED_L, quantize=quantize,
                                         calib_rays=(ros, rds))
        if fn.kind != kind:
            raise AssertionError(f"given rays: asked for {kind}, got "
                                 f"{fn.kind}")
        fns[kind] = fn
        f = given[kind] = givenrays_frames(fn, ros, rds).cpu()
        bench = make_r2l_givenrays_bench_fn(model, cfg, sampler, H, W,
                                            embed_L=EMBED_L, parts=fn.parts)
        checksum = float(bench(ros, rds))
        want = float(f.double().sum())
        if abs(checksum - want) > RTOL_CHECKSUM * abs(want):
            raise AssertionError(f"given rays {kind}: checksum {checksum} "
                                 f"!= frame sum {want}")
        ms = time_ms(lambda: bench(ros, rds), reps=2) / K
        r = {"ms_per_frame": ms}
        if kind == "pe":
            r["pixels_differing_from_pose_frames"] = n_diff = int(
                (f != pose_frames["pe"]).sum())
            ok = n_diff == 0
            what = f"{n_diff} pixels differ from phase 4's pose frames"
        else:
            r["psnr_vs_jnp"] = p = psnr_db(f, pose_frames["jnp"])
            ok = p >= MIN_PSNR["int8"]
            what = f"PSNR vs jnp {p:.2f} dB (min {MIN_PSNR['int8']})"
        res[kind] = r
        print(f"[main] given rays {kind}: {ms:.3f} ms/frame over {K} "
              f"frames, {what}" + (" ok" if ok else " FAILED"), flush=True)
        if not ok:
            raise AssertionError(f"given rays {kind}: {r}")

    lp = init_lpips(torch.Generator().manual_seed(SEED + 50), "alex",
                    device=dev)
    gt = pose_frames["jnp"][:N_EVAL_FRAMES].numpy()
    with tempfile.TemporaryDirectory() as tmp:
        ev = render_path_given_rays(
            None, cfg, sampler, ros[:N_EVAL_FRAMES].cpu().numpy(),
            rds[:N_EVAL_FRAMES].cpu().numpy(), H, W, gt_images=gt,
            savedir=tmp, lpips_params=lp, frame_fn=fns["int8"])
        pngs = sorted(os.listdir(tmp))
    want_pngs = sorted(f"{i:03d}{s}.png" for i in range(N_EVAL_FRAMES)
                       for s in ("", "_err", "_gt"))
    torch.cuda.synchronize()
    res["launches"] = {"pe": F.fused_r2l_apply_pe.launches,
                       "int8": F.fused_r2l_apply_int8_pe.launches}
    res["eval"] = {k: getattr(ev, k) for k in (
        "test_psnr", "test_psnr_v2", "test_ssim", "test_flip", "test_lpips",
        "ms_per_frame")}
    vals = [res["eval"][k] for k in ("test_psnr", "test_psnr_v2",
                                     "test_ssim", "test_flip", "test_lpips")]
    # the eval loop's frames are the int8 frames above: its PSNR (of the
    # mean f32 MSE) is theirs, to f32 rounding
    want_psnr = psnr_db(given["int8"][:N_EVAL_FRAMES], torch.from_numpy(gt))
    ok = pngs == want_pngs and all(np.isfinite(v) for v in vals) \
        and abs(ev.test_psnr - want_psnr) < 1e-3
    print(f"[main] render_path_given_rays int8, {N_EVAL_FRAMES} frames vs "
          f"the jnp frames: PSNR {ev.test_psnr:.4f} (v2 "
          f"{ev.test_psnr_v2:.4f}) SSIM {ev.test_ssim:.6f} FLIP "
          f"{ev.test_flip:.6f} LPIPS alex (seeded weights) "
          f"{ev.test_lpips:.6f}, {ev.ms_per_frame:.3f} ms/frame, "
          f"{len(pngs)} PNGs (PSNR of the same frames in float64 "
          f"{want_psnr:.4f})" + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"render_path_given_rays: {res['eval']}, "
                             f"{pngs}")
    print(f"[main] given-rays launches: {res['launches']}", flush=True)
    if min(res["launches"].values()) <= 0:
        raise AssertionError("the given-rays path launched no kernel")

    g = torch.from_numpy(gt[0]).to(dev)
    img = givenrays_frames(fns["int8"], ros[:1], rds[:1])[0]
    res["metric_ms"] = {
        "frame_metrics": time_ms(lambda: frame_metrics(img, g)),
        "flip": time_ms(lambda: flip(g, img)),
        "lpips_alex": time_ms(lambda: lpips(lp, g, img))}
    print("[time] metrics per 400x400 frame: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in res["metric_ms"].items()), flush=True)
    res["golden"] = golden_metrics(dev)
    del model, fns, ros, rds
    torch.cuda.empty_cache()
    return res


def phase_nerf_bench(dev, poses) -> dict:
    """Phase 15 (c): the teacher's benchmark (``make_nerf_bench_fn``) on
    N_NERF_BENCH poses, fused and plain; the fused checksum against the sum
    of ``make_nerf_frame_fn``'s frames, K6's launches in the fused run."""
    from r2l_tpu_torch.evaluate import make_nerf_bench_fn, make_nerf_frame_fn
    from r2l_tpu_torch.kernels import nerf_render as NR
    from r2l_tpu_torch.sampler import PointSampler
    cfg, mc, mf = teacher_models("f32", dev)
    sampler = PointSampler(H=H, W=W, focal=FOCAL, n_sample=T_SAMPLES,
                           near=2.0, far=6.0)
    k = N_NERF_BENCH
    frame = make_nerf_frame_fn(mc, mf, cfg, teacher_vcfg(), sampler,
                               use_pallas=True, device=dev)
    want = sum(float(frame(p).double().sum()) for p in poses[:k])
    res = {}
    for kind, fused in (("fused", True), ("plain", False)):
        bench = make_nerf_bench_fn(mc, mf, cfg, teacher_vcfg(), sampler,
                                   use_pallas=fused, device=dev)
        if bench.kind != kind:
            raise AssertionError(f"teacher bench: asked for {kind}, got "
                                 f"{bench.kind}")
        if fused:
            NR.fused_nerf_render.launches = 0
            checksum = float(bench(poses[:k]))
            res["launches"] = NR.fused_nerf_render.launches
            if abs(checksum - want) > RTOL_CHECKSUM * abs(want) \
                    or res["launches"] <= 0:
                raise AssertionError(f"teacher bench: checksum {checksum} "
                                     f"vs frames {want}, K6 launches "
                                     f"{res['launches']}")
        res[kind] = {"ms_per_frame": time_ms(lambda: bench(poses[:k]),
                                             reps=1) / k}
    print(f"[main] teacher benchmark (f32 weights, {k} poses): fused "
          f"{res['fused']['ms_per_frame']:.3f} ms/frame, plain "
          f"{res['plain']['ms_per_frame']:.3f} ms/frame, checksum = the "
          f"frames' sum, K6 launches {res['launches']}", flush=True)
    del mc, mf
    torch.cuda.empty_cache()
    return res


def phase_bench_cuda(smi: str, main_res: dict) -> dict:
    """Phase 15 (d): ``python3 bench_cuda.py`` as a user runs it; its JSON
    line on a line of its own, the int8 path and this card."""
    out = subprocess.run([sys.executable, str(REPO / "bench_cuda.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench_cuda.py exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    rec = json.loads(line)
    extra = rec["extra"]
    ok = extra["path"] == "cuda-int8-pe-fused" and extra["device"] == smi
    print(f"[main] bench_cuda.py: {rec['value']} {rec['unit']}, "
          f"{extra['ms_per_frame']} ms/frame on the {extra['path']} path "
          f"(phase 4's int8: {main_res['int8']['ms_per_frame']:.3f})"
          + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"bench_cuda.py's record: {rec}")
    return rec


def check_states_equal(name: str, got: dict, want: dict) -> None:
    """``check_equal`` over two ``train_snapshot``s, one line."""
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"[check] {name}: {len(want)} tensors "
          + ("bit for bit ok" if not bad else f"DIFFER: {bad[:5]}"),
          flush=True)
    if bad or list(got) != list(want):
        raise AssertionError(f"{name}: {bad[:5]} differ")


def train_snapshot(state) -> dict:
    """A distillation or teacher state's parameters, Adam moments and
    counts, hard pool and step counts, as tensors."""
    out = {}
    nets = ([("", state.params)] if hasattr(state, "pool") else
            [("c.", state.model_c), ("f.", state.model_f)])
    for tag, net in nets:
        for name, p in net.named_parameters():
            st = state.optimizer.state[p]
            out[tag + name] = p.detach()
            for k in ("exp_avg", "exp_avg_sq", "step"):
                out[f"{tag}{name}.{k}"] = st[k]
    if hasattr(state, "pool"):
        out.update({f"pool.{k}": getattr(state.pool, k)
                    for k in state.pool._fields})
    out["step"] = torch.tensor(state.step)
    out["lr_count"] = torch.tensor(state.lr_count)
    return out


def ckpt_load_paths(cfg, sampler, poses, tmp: str, dev) -> dict:
    """Phase 16 (a): the phase-4 student through a native .msgpack and a
    reference-schema .tar (the export tool's), each loaded into a new R2L
    on the card; its pe (K1) and int8 (K2) frames of CKPT_POSES poses
    against the original's, bit for bit."""
    from r2l_tpu_torch import checkpoint as C
    from r2l_tpu_torch.evaluate import make_r2l_frame_fn
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.models import init_r2l, params_to_jax
    from r2l_tpu_torch.tools.export_torch_ckpt import main as export_tar
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), dev)
    native, tar = os.path.join(tmp, "r2l.msgpack"), os.path.join(tmp,
                                                                 "r2l.tar")
    res = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.save_checkpoint(native, {"params": params_to_jax(model, cfg)},
                      meta={"global_step": 0})
    res["msgpack_save_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    export_tar(["--ckpt", native, "--out", tar])
    res["tar_export_ms"] = (time.perf_counter() - t0) * 1e3
    loaded = {}
    arch = ("input_dim", "netwidth", "netdepth", "num_blocks", "n_learnable",
            "linear_tail", "compute_dtype")
    for kind, path in (("msgpack", native), ("tar", tar)):
        t0 = time.perf_counter()
        loaded[kind] = C.load_r2l(path, dev, compute_dtype=cfg.compute_dtype)
        torch.cuda.synchronize()
        res[f"{kind}_load_ms"] = (time.perf_counter() - t0) * 1e3
        res[f"{kind}_mb"] = os.path.getsize(path) / 1e6
        got = loaded[kind][1]
        if any(getattr(got, a) != getattr(cfg, a) for a in arch):
            raise AssertionError(f"{kind}: inferred {got}")
    print(f"[ckpt] W256/D88 student: .msgpack {res['msgpack_mb']:.2f} MB "
          f"saved in {res['msgpack_save_ms']:.1f} ms, loaded in "
          f"{res['msgpack_load_ms']:.1f} ms; .tar {res['tar_mb']:.2f} MB "
          f"exported in {res['tar_export_ms']:.1f} ms, loaded in "
          f"{res['tar_load_ms']:.1f} ms", flush=True)
    F.fused_r2l_apply_pe.launches = 0
    F.fused_r2l_apply_int8_pe.launches = 0
    for kind, quantize in (("pe", ""), ("int8", "int8")):
        frames = {}
        for src, (m, mcfg) in (("original", (model, cfg)),
                               *((k, v[:2]) for k, v in loaded.items())):
            fn = make_r2l_frame_fn(m, mcfg, sampler, embed_L=EMBED_L,
                                   quantize=quantize, calib_poses=poses)
            if fn.kind != kind:
                raise AssertionError(f"asked for {kind}, got {fn.kind}")
            frames[src] = torch.stack([fn(p) for p in poses[:CKPT_POSES]])
        for src in loaded:
            check_equal(f"{kind} frames of the student loaded from the "
                        f"{src} vs the original's", frames[src],
                        frames["original"])
    torch.cuda.synchronize()
    res["launches"] = {"pe": F.fused_r2l_apply_pe.launches,
                       "int8": F.fused_r2l_apply_int8_pe.launches}
    print(f"[main] checkpoint frames: K1/K2 launches {res['launches']}",
          flush=True)
    if min(res["launches"].values()) <= 0:
        raise AssertionError("the loaded frames launched no kernel")
    return res


def ckpt_resume(cfg, sampler, poses, tmp: str, dev) -> dict:
    """Phase 16 (b): distillation at the README's flags, kinds fused (K3 +
    K5) and fused_int8 (K4 + K5, calibrated every step): 3 steps, a save
    with the pool, a restore into a state built afresh from other weights,
    2 steps; equal to 5 straight steps, bit for bit."""
    from r2l_tpu_torch import checkpoint as C
    from r2l_tpu_torch.hardmine import parse_hard_ratio
    from r2l_tpu_torch.kernels import r2l_train as T
    from r2l_tpu_torch.models import init_r2l
    from r2l_tpu_torch.train import (DistillConfig, draw_step,
                                     fused_int8_calib_points,
                                     init_train_state, make_distill_step)
    n_in, n_out = parse_hard_ratio(HARD_RATIO, N_RAND)
    dcfg = DistillConfig(batch_size=N_RAND, n_hard_in=n_in, n_hard_out=n_out,
                         hard_mul=HARD_MUL, warmup_lr=WARMUP, embed_L=EMBED_L,
                         perturb=True)
    n_fresh = N_RAND - n_out
    rays = torch.from_numpy(synthetic_rays(5 * n_fresh, SEED + 60)).to(dev)
    batches = rays.reshape(5, n_fresh, -1)
    draws = [draw_step(dcfg, N_SAMPLE, torch.Generator(dev).manual_seed(
        300 + i)) for i in range(5)]
    calib = fused_int8_calib_points(H, W, FOCAL, N_SAMPLE, 2.0, 6.0, poses,
                                    dev)
    kinds = {"fused": {"fused_vjp": True},
             "fused_int8": {"fused_vjp": True, "fused_quantize": "int8",
                            "fused_calib_pts": calib,
                            "fused_calib_every": 1}}
    res = {}
    for f in (T.train_fwd, T.train_fwd_int8, T.bwd_group):
        f.launches = 0
    for kind, kw in kinds.items():
        step = make_distill_step(cfg, dcfg, sampler, device=dev, **kw)

        def fresh(seed):
            return init_train_state(init_r2l(cfg, torch.Generator(
            ).manual_seed(seed), dev), dcfg, device=dev)
        straight = fresh(SEED)
        for i in range(5):
            straight, _ = step(straight, batches[i], draws=draws[i])
        half = fresh(SEED)
        for i in range(3):
            half, _ = step(half, batches[i], draws=draws[i])
        path = os.path.join(tmp, f"{kind}.msgpack")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C.save(path, half, half.step, -1.0, -1, save_pool=True)
        save_ms = (time.perf_counter() - t0) * 1e3
        del half
        resumed = fresh(SEED + 1)
        log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed, _, _ = C.resume_distill(resumed, path, log=log.append)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        if (resumed.step, resumed.lr_count) != (3, 3) or not any(
                "restored hard-ray pool" in m for m in log):
            raise AssertionError(f"{kind}: resume gave step "
                                 f"{resumed.step}: {log}")
        for i in range(3, 5):
            resumed, _ = step(resumed, batches[i], draws=draws[i])
        check_states_equal(f"{kind}: save at 3 + restore + 2 steps vs 5 "
                           "straight (params, mu, nu, counts, pool)",
                           train_snapshot(resumed), train_snapshot(straight))
        res[kind] = {"save_ms": save_ms, "restore_ms": load_ms,
                     "mb": os.path.getsize(path) / 1e6,
                     "pool_size": int(resumed.pool.size)}
        print(f"[ckpt] resume {kind}: full state {res[kind]['mb']:.2f} MB "
              f"(pool of {resumed.pool.rays.shape[0]} rays, "
              f"{res[kind]['pool_size']} held), saved in {save_ms:.1f} ms, "
              f"restored in {load_ms:.1f} ms", flush=True)
        del straight, resumed, step
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    res["launches"] = {"train_fwd": T.train_fwd.launches,
                       "train_fwd_int8": T.train_fwd_int8.launches,
                       "bwd_group": T.bwd_group.launches}
    print(f"[main] resume: K3/K4/K5 launches {res['launches']}", flush=True)
    if min(res["launches"].values()) <= 0:
        raise AssertionError("the resumed steps launched no kernel")
    return res


def ckpt_teacher_resume(images, img_poses, tmp: str, dev) -> dict:
    """Phase 16 (c): lego's teacher step at CKPT_TEACHER_RAYS rays: 2 steps,
    save, restore into networks built afresh, 1 more; equal to 3 straight,
    bit for bit."""
    from r2l_tpu_torch import checkpoint as C
    from r2l_tpu_torch.models import NeRFConfig, init_nerf
    from r2l_tpu_torch.render import VolRenderConfig
    from r2l_tpu_torch.train import (TeacherTrainConfig, init_teacher_state,
                                     make_teacher_step)
    cfg = NeRFConfig()
    vcfg = VolRenderConfig(n_coarse=T_SAMPLES, n_fine=T_FINE, perturb=True,
                           white_bkgd=True)
    tcfg = TeacherTrainConfig(n_rand=CKPT_TEACHER_RAYS, lrate=5e-4,
                              lrate_decay=500, precrop_iters=500,
                              precrop_frac=0.5)
    step = make_teacher_step(cfg, vcfg, tcfg, H, W, FOCAL, device=dev)
    imgs = torch.from_numpy(images).to(dev)
    pss = torch.from_numpy(img_poses).to(dev)

    def fresh(seed):
        g = torch.Generator().manual_seed(seed)
        nets = [init_nerf(cfg, g, dev) for _ in range(2)]
        with torch.no_grad():
            for m in nets:
                m.alpha_linear.bias += DENSITY_FLOOR
        return init_teacher_state(*nets, tcfg)

    def run(state, i):
        return step(state, imgs, pss, generator=torch.Generator(
            dev).manual_seed(400 + i))[0]
    straight = fresh(SEED + 50)
    for i in range(3):
        straight = run(straight, i)
    half = fresh(SEED + 50)
    for i in range(2):
        half = run(half, i)
    path = os.path.join(tmp, "teacher.msgpack")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.save(path, half, half.step, -1.0, -1)
    save_ms = (time.perf_counter() - t0) * 1e3
    resumed = fresh(SEED + 51)
    t0 = time.perf_counter()
    resumed, _, _ = C.resume_teacher(resumed, path, log=lambda s: None)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    resumed = run(resumed, 2)
    check_states_equal("teacher: save at 2 + restore + 1 step vs 3 "
                       "straight (coarse, fine, mu, nu, counts)",
                       train_snapshot(resumed), train_snapshot(straight))
    res = {"save_ms": save_ms, "restore_ms": load_ms,
           "mb": os.path.getsize(path) / 1e6, "rays": CKPT_TEACHER_RAYS}
    print(f"[ckpt] resume teacher lego ({CKPT_TEACHER_RAYS} rays/step): "
          f"{res['mb']:.2f} MB saved in {save_ms:.1f} ms, restored in "
          f"{load_ms:.1f} ms", flush=True)
    return res


def ckpt_onnx(cfg, tmp: str, dev) -> dict:
    """Phase 16 (d): ``export_onnx`` of the canonical student, with its own
    parity check."""
    from r2l_tpu_torch.export import export_onnx
    from r2l_tpu_torch.models import init_r2l
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), dev)
    log = []
    t0 = time.perf_counter()
    path = export_onnx(model, cfg, os.path.join(tmp, "onnx"), log=log.append)
    res = {"s": time.perf_counter() - t0, "mb": os.path.getsize(path) / 1e6,
           "log": log[-1]}
    ok = "parity check passed" in log[-1]
    print(f"[ckpt] ONNX export of the W256/D88 student: {res['mb']:.2f} MB "
          f"in {res['s']:.2f} s: {log[-1]}" + (" ok" if ok else " FAILED"),
          flush=True)
    if not ok:
        raise AssertionError(f"ONNX export: {log}")
    return res


def phase_checkpoints(cfg, sampler, poses, images, img_poses, dev) -> dict:
    """Phase 16: checkpoints, resume and export on the card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = {"load": ckpt_load_paths(cfg, sampler, poses, tmp, dev)}
        torch.cuda.empty_cache()
        res["resume"] = ckpt_resume(cfg, sampler, poses, tmp, dev)
        res["teacher"] = ckpt_teacher_resume(images, img_poses, tmp, dev)
        torch.cuda.empty_cache()
        res["onnx"] = ckpt_onnx(cfg, tmp, dev)
    res["phase_s"] = time.perf_counter() - t0
    print(f"[main] phase 16 took {res['phase_s']:.1f} s", flush=True)
    return res


# Phase 17, the command line on the card: a 400x400 sphere scene written as
# a Blender folder (PNG and transforms_*.json), then main_cuda.py's
# app.train and the create-data tool as a user runs them (README.md's flags:
# configs/lego.txt's teacher, the canonical student, bf16 compute, depth
# and poses cut to fit the phase). Two commands run as subprocesses of the
# real entries; the rest in process, so the launch counters can be read.
CLI_SPLITS = (("train", 8), ("val", 1), ("test", 2))
CLI_TEACHER_STEPS, CLI_DISTILL_STEPS, CLI_IMAGES_STEPS = 30, 20, 10
CLI_POSES = 2          # per create_data mode
CLI_MODES = ("rand", "spiral_evenly_spaced", "rand_tworays", "3x3rays",
             "rand_images", "16x16patches")
CLI_STUDENT = (f"--model_name R2L --config {REPO}/configs/lego_noview.txt "
               "--half_res 0 --n_sample_per_ray 16 --netwidth 256 "
               "--netdepth 88 --use_residual --trial.ON --trial.body_arch "
               "resmlp --compute_dtype bfloat16").split()
CLI_TEACHER = (f"--config {REPO}/configs/lego.txt --model_name nerf "
               "--half_res 0").split()
CLI_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def cli_counts() -> dict:
    """The launch counters of the kernels the command line reaches."""
    from r2l_tpu_torch.kernels import nerf_render as NR
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.kernels import r2l_train as T
    return {"K1": F.fused_r2l_apply_pe.launches,
            "K2": F.fused_r2l_apply_int8_pe.launches,
            "K3": T.train_fwd.launches, "K4": T.train_fwd_int8.launches,
            "K5": T.bwd_group.launches, "K6": NR.fused_nerf_render.launches,
            "K7": NR.fused_nerf_render.launches_int8}


def write_blender_scene(base: Path, images: np.ndarray,
                        poses: np.ndarray) -> None:
    """Sphere views as a Blender folder: 8-bit PNGs through the port's own
    writer and transforms_{train,val,test}.json at the lego focal."""
    from r2l_tpu_torch.evaluate import to8b, write_png
    cax = 2.0 * float(np.arctan(0.5 * W / FOCAL))
    i = 0
    for split, n in CLI_SPLITS:
        (base / split).mkdir(parents=True)
        frames = []
        for k in range(n):
            write_png(str(base / split / f"r_{k}.png"), to8b(images[i]))
            c2w = np.concatenate([poses[i], [[0.0, 0.0, 0.0, 1.0]]])
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": c2w.tolist()})
            i += 1
        with open(base / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": cax, "frames": frames}, f)


def cli_inproc(fn, dev) -> tuple:
    """Run ``fn()`` (an entry's in-process call): (its result, {wall_s,
    peak_gb, launches of each kernel in the call})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = cli_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                 "launches": {k: v - before[k]
                              for k, v in cli_counts().items()
                              if v != before[k]}}


def cli_subprocess(argv: list) -> tuple[str, float]:
    """Run an entry as a user does (``python3 <argv>``) from the checkout:
    (its stdout, wall seconds); a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        print(out.stdout[-3000:], out.stderr[-3000:], sep="\n", flush=True)
        raise AssertionError(f"cli: {' '.join(argv[:3])} exited "
                             f"{out.returncode}")
    return out.stdout, wall


def cli_log(exps: Path, name: str) -> str:
    (path,) = exps.glob(f"{name}-*/log/log.txt")
    return path.read_text()


def cli_weights(exps: Path, name: str, file: str) -> str:
    (path,) = exps.glob(f"{name}-*/weights/{file}")
    return str(path)


def cli_found(pattern: str, text: str, what: str) -> list:
    got = re.findall(pattern, text)
    if not got:
        raise AssertionError(f"cli: no {what} in the output")
    return got


def cli_step_ms(marks: list, n_iters: int) -> float:
    """The CLI's ms/step as its user sees it: the host wall between the
    [TRAIN] lines at n/2 and at n over the steps between (the second line
    is printed after its metrics are read back, which waits for the card,
    so the steps' device time is inside)."""
    t = dict(marks)
    h = n_iters // 2
    return (t[n_iters] - t[h]) * 1e3 / (n_iters - h)


def cli_line(name: str, r: dict, extra: str) -> None:
    print(f"[main] cli {name}: {r['wall_s']:.2f} s wall, {extra}, peak "
          f"{r['peak_gb']:.2f} GB, launches {r['launches']}", flush=True)


def phase_cli(dev, direct: dict) -> dict:
    """Phase 17: the port's command line on the card (see CLI_* above).
    ``direct`` holds the direct calls' numbers of phases 4, 6, 8 and 10 to
    print beside the CLI's."""
    from r2l_tpu_torch import app
    from r2l_tpu_torch import logging_ as LG
    from r2l_tpu_torch.configs import parse_args
    from r2l_tpu_torch.tools import create_data as tcd
    from r2l_tpu_torch.tools import verify_released_ckpt as tvr
    t_phase = time.perf_counter()
    res: dict = {}
    marks: list = []   # (iteration, host time) of each [TRAIN] line
    log_print = LG.Logger.print

    def print_marked(self, *msg, **kw):
        m = re.match(r"\[TRAIN\] Iter (\d+)/", " ".join(map(str, msg)))
        if m:
            marks.append((int(m.group(1)), time.perf_counter()))
        return log_print(self, *msg, **kw)
    n_views = sum(n for _, n in CLI_SPLITS)
    images, poses = sphere_scene(n_views, SEED + 70)
    start = cli_counts()
    with mock.patch.object(LG.Logger, "print", print_marked), \
            tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        scene, exps = tmp / "scene", tmp / "exps"
        write_blender_scene(scene, images, poses)
        common = ["--datadir", str(scene), "--testskip", "1",
                  "--experiments_dir", str(exps)]

        def run(name, argv):
            marks.clear()
            out, r = cli_inproc(lambda: app.train(parse_args(
                argv + ["--experiment_name", name])), dev)
            res[name] = r
            return out, r

        # the teacher at lego's widths; sigma noise keeps a random-init
        # teacher's ReLUs alive (the verify recipe's dead-ReLU collapse)
        n = CLI_TEACHER_STEPS
        (_, tbest), r = run("teacher", CLI_TEACHER + common + [
            "--N_iters", str(n), "--i_print", str(n // 2), "--i_testset",
            str(n), "--i_weights", str(n), "--raw_noise_std", "1"])
        r["ms_per_step"] = cli_step_ms(marks, n)
        r["psnr_v2"] = tbest
        cli_line("main_cuda.py --model_name nerf (lego, 64+128 samples)", r,
                 f"{r['ms_per_step']:.3f} ms/step (host wall, steps "
                 f"{n // 2 + 1}-{n}) vs phase 10's direct {direct['teacher_ms']:.3f}, "
                 f"test PSNRv2 {tbest:.4f}")
        teacher = cli_weights(exps, "teacher", "teacher.msgpack")

        # create_data: rand through the tool's entry as a subprocess and in
        # process (the same teacher PSNR and the same shards), then every
        # other mode, rand with the int8 teacher, and convert_rays
        dargv = CLI_TEACHER + common + [
            "--teacher_ckpt", teacher, "--n_pose_kd", str(CLI_POSES),
            "--create_data_chunk", str(CLI_POSES)]
        out, wall = cli_subprocess(
            ["-m", "r2l_tpu_torch.tools.create_data", *dargv,
             "--create_data", "rand", "--test_teacher", "--datadir_kd",
             str(tmp / "rand_sub"), "--experiment_name", "cd_sub"])
        psnr_sub = cli_found(r"teacher test PSNR ([0-9.]+)", out,
                             "teacher PSNR")[-1]
        res["create_data_subprocess"] = {"wall_s": wall}
        dirs = {}
        for mode in CLI_MODES + ("rand_int8", "convert_rays"):
            name = f"cd_{mode}"
            flags = ["--create_data", mode.replace("_int8", "")]
            if mode == "rand":
                flags += ["--test_teacher"]
            if mode == "rand_int8":
                flags += ["--quantize", "int8"]
            dirs[mode] = tmp / mode
            _, r = cli_inproc(lambda: tcd.main(
                dargv + flags + ["--datadir_kd", str(dirs[mode]),
                                 "--experiment_name", name]), dev)
            res[name] = r
            files = sorted(os.listdir(dirs[mode]))
            if not files:
                raise AssertionError(f"cli create_data {mode}: no files")
            r["files"] = files
            kind = "K7" if mode == "rand_int8" else "K6"
            r["ms_per_pose"] = r["wall_s"] * 1e3 / CLI_POSES
            extra = (f"{r['ms_per_pose']:.1f} ms/pose (host wall, packing "
                     f"included) vs phase 8's direct "
                     f"{direct['datagen_ms'][kind]:.1f}, files {files}")
            if mode == "convert_rays":
                extra = f"files {files}"
            if mode == "rand":
                psnr_in = cli_found(r"teacher test PSNR ([0-9.]+)",
                                    cli_log(exps, name), "teacher PSNR")[-1]
                same = all((dirs[mode] / f).read_bytes()
                           == (tmp / "rand_sub" / f).read_bytes()
                           for f in files) and sorted(
                    os.listdir(tmp / "rand_sub")) == files
                ok = psnr_in == psnr_sub and same
                print(f"[check] cli create_data rand: teacher PSNR "
                      f"subprocess {psnr_sub} in process {psnr_in}, shards "
                      + ("equal byte for byte" if same else "DIFFER")
                      + (" ok" if ok else " FAILED"), flush=True)
                if not ok:
                    raise AssertionError("cli create_data rand: the "
                                         "subprocess and in-process runs "
                                         "differ")
                r["teacher_psnr"] = float(psnr_in)
                extra += (f", teacher test PSNR {psnr_in} (the wall holds "
                          "--test_teacher's 2 frames)")
            cli_line(f"create_data {mode}", r, extra)

        # distillation, rays mode on the rand shards: fused (K3 + K5), then
        # fused int8 (K4 + K5); images mode on the spiral images
        n = CLI_DISTILL_STEPS
        rays = CLI_STUDENT + common + [
            "--data_mode", "rays", "--datadir_kd", str(dirs["rand"]),
            "--N_rand", "20", "--hard_ratio", "0.2", "--hard_mul", "20",
            "--warmup_lr", "0.0001,200", "--N_iters", str(n), "--i_print",
            str(n // 2), "--i_testset", str(n), "--fused_train_vjp"]
        for name, extra_flags, kind in (
                ("distill", [], "fused"),
                ("distill_int8", ["--fused_train_int8"], "fused_int8")):
            (_, best), r = run(name, rays + extra_flags)
            log = cli_log(exps, name)
            r["ms_per_step"] = cli_step_ms(marks, n)
            r["psnr_v2"] = best
            r["test_psnr"] = cli_found(r"\[TEST\] Iter \d+ TestPSNR "
                                       r"([0-9.]+)", log, "[TEST]")[-1]
            d = direct["train"][kind]
            cli_line(f"main_cuda.py --data_mode rays ({kind})", r,
                     f"{r['ms_per_step']:.3f} ms/step (host wall, "
                     f"steps {n // 2 + 1}-{n}) vs phase 6's direct "
                     f"{d['ms_per_step']:.3f} (host {d['wall_ms_per_step']:.3f})"
                     f", test PSNR {r['test_psnr']} PSNRv2 {best:.4f}")
        n = CLI_IMAGES_STEPS
        (_, best), r = run("images", CLI_STUDENT + common + [
            "--data_mode", "images", "--datadir_kd",
            str(dirs["spiral_evenly_spaced"]), "--N_rand", "1024",
            "--pseudo_ratio", "0.5", "--warmup_lr", "0.0001,200",
            "--N_iters", str(n), "--i_print", str(n // 2), "--i_testset",
            str(n), "--compute_dtype", "float32"])
        r["ms_per_step"] = cli_step_ms(marks, n)
        cli_line("main_cuda.py --data_mode images (f32, phase 10's dtype)",
                 r, f"{r['ms_per_step']:.3f} ms/step (host wall, steps "
                 f"{n // 2 + 1}-{n}) vs phase 10's direct "
                 f"{direct['images_ms']:.3f}, PSNRv2 {best:.4f}")

        # from the checkpoint: --render_only as a subprocess of main_cuda.py
        # and in process (both equal to the training-time eval), int8,
        # --benchmark, --convert_to_onnx
        best_ckpt = cli_weights(exps, "distill", "ckpt_best.msgpack")
        ro = CLI_STUDENT + common + ["--render_only", "--render_test",
                                     "--pretrained_ckpt", best_ckpt]
        out, wall = cli_subprocess(["main_cuda.py", *ro,
                                    "--experiment_name", "ro_sub"])
        psnr_sub = cli_found(r"render_only: PSNR ([0-9.]+)", out,
                             "render_only PSNR")[-1]
        res["render_only_subprocess"] = {"wall_s": wall, "psnr": psnr_sub}
        rres, r = run("render_only", ro)
        r.update(psnr=rres.test_psnr, psnr_v2=rres.test_psnr_v2,
                 ms_per_frame=rres.ms_per_frame)
        train_eval = res["distill"]["test_psnr"]
        ok = (psnr_sub == train_eval == f"{rres.test_psnr:.4f}"
              and rres.test_psnr_v2 == res["distill"]["psnr_v2"])
        print(f"[check] cli --render_only from ckpt_best: PSNR subprocess "
              f"{psnr_sub}, in process {rres.test_psnr:.4f} (PSNRv2 "
              f"{rres.test_psnr_v2!r}), training-time eval {train_eval} "
              f"(PSNRv2 {res['distill']['psnr_v2']!r})"
              + (" equal ok" if ok else " FAILED"), flush=True)
        if not ok:
            raise AssertionError("cli: --render_only differs from the "
                                 "training-time eval")
        cli_line("main_cuda.py --render_only --render_test (K1 bf16)", r,
                 f"{rres.ms_per_frame:.3f} ms/frame vs phase 4's direct "
                 f"{direct['frame_ms']['pe']:.3f}, PSNR {rres.test_psnr:.4f};"
                 f" the subprocess {wall:.1f} s wall")
        qres, r = run("render_int8", ro + ["--quantize", "int8"])
        r.update(psnr=qres.test_psnr, ms_per_frame=qres.ms_per_frame)
        cli_line("main_cuda.py --render_only --quantize int8 (K2)", r,
                 f"{qres.ms_per_frame:.3f} ms/frame vs phase 4's direct "
                 f"{direct['frame_ms']['int8']:.3f}, PSNR "
                 f"{qres.test_psnr:.4f} (bf16 {rres.test_psnr:.4f})")
        fps, r = run("benchmark", CLI_STUDENT + common + [
            "--benchmark", "--pretrained_ckpt", best_ckpt])
        r["ms_per_frame"] = 1e3 / fps
        cli_line("main_cuda.py --benchmark (K1 bf16)", r,
                 f"{r['ms_per_frame']:.3f} ms/frame vs phase 4's direct "
                 f"{direct['frame_ms']['pe']:.3f}")
        path, r = run("onnx", CLI_STUDENT + common + [
            "--convert_to_onnx", "--pretrained_ckpt", best_ckpt])
        r["mb"] = os.path.getsize(path) / 1e6
        cli_line("main_cuda.py --convert_to_onnx", r,
                 f"{r['mb']:.2f} MB ONNX, parity checked")
        # the released-checkpoint harness on ckpt_best, report-only: its
        # pallas path (K1 bf16) renders the --render_only frames
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, r = cli_inproc(lambda: tvr.main([
                "--ckpt", best_ckpt, "--datadir", str(scene), "--paths",
                "xla,pallas,int8"]), dev)
        rep = json.loads(out.getvalue().strip().splitlines()[-1])
        res["verify_released_ckpt"] = r
        r["results"] = rep["results"]
        pallas = rep["results"]["pallas"]["psnr"]
        ok = rc == 0 and f"{pallas:.4f}" == f"{rres.test_psnr:.4f}"
        cli_line("verify_released_ckpt --paths xla,pallas,int8", r,
                 "PSNR " + ", ".join(f"{k} {v['psnr']:.4f}" for k, v in
                                     rep["results"].items())
                 + f"; pallas = --render_only's {rres.test_psnr:.4f}"
                 + (" ok" if ok else " FAILED"))
        if not ok:
            raise AssertionError(f"verify_released_ckpt: rc {rc}, {rep}")
    res["launches"] = {k: v - start[k] for k, v in cli_counts().items()}
    res["phase_s"] = time.perf_counter() - t_phase
    missing = [k for k in CLI_KERNELS if res["launches"][k] <= 0]
    print(f"[main] cli launches in phase 17: {res['launches']}"
          + (f" FAILED: never launched {missing}" if missing else " ok")
          + f"; phase 17 took {res['phase_s']:.1f} s", flush=True)
    if missing:
        raise AssertionError(f"cli: kernels never launched: {missing}")
    return res




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "r2l_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no r2l_tpu_torch package beside {__file__}; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from r2l_tpu_torch.kernels import _build
    from r2l_tpu_torch.models import R2LConfig, init_r2l
    from r2l_tpu_torch.sampler import PointSampler

    # Full f32 for every plain f32 matmul (PyTorch's default, stated).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    t0 = time.time()
    seconds = _build.build()
    build_s = time.time() - t0
    print(f"[build] {build_s:.1f} s ({seconds})", flush=True)
    for kname in _build.KERNELS:
        for line in _build.compiler_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}", flush=True)

    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), dev)
    sampler = PointSampler(H=H, W=W, focal=FOCAL, n_sample=N_SAMPLE,
                           near=2.0, far=6.0)
    poses = lego_poses(K)

    kern = phase_kernels(model, cfg, sampler, poses, dev)
    canary = phase_canary(dev)
    main_res, frames = phase_main_path(model, cfg, sampler, poses, dev)
    api = phase_api_frames(model, cfg, sampler, poses, frames["jnp"], dev)
    pose_frames = {k: frames[k].cpu() for k in ("jnp", "pe")}
    del frames
    cli_f32 = phase_cli_f32_frames(model, cfg, sampler, poses, dev)
    tkern = phase_train_kernels(model, cfg, sampler, poses, dev)
    del model
    torch.cuda.empty_cache()
    train = phase_train_main(cfg, sampler, poses, dev)
    torch.cuda.empty_cache()
    teacher = phase_teacher_kernels(dev)
    dgen = phase_datagen(dev)
    tframe = phase_teacher_frame(dev, poses)
    images, img_poses = sphere_scene(N_TEACHER_IMAGES, SEED + 40)
    ttrain = phase_teacher_train(images, img_poses, dev)
    idist = phase_images_distill(images, img_poses, sampler, dev)
    probes = phase_probes(dev)
    k2_probes = phase_k2_probes(dev)
    qdx = phase_qdx(dev)
    given = phase_givenrays(cfg, sampler, poses, pose_frames, dev)
    del pose_frames
    nbench = phase_nerf_bench(dev, poses)
    bench_line = phase_bench_cuda(smi, main_res)
    torch.cuda.empty_cache()
    ck = phase_checkpoints(cfg, sampler, poses, images, img_poses, dev)
    torch.cuda.empty_cache()
    cli = phase_cli(dev, {
        "teacher_ms": ttrain["images"]["ms_per_step"],
        "images_ms": idist["ms_per_step"],
        "datagen_ms": {"K6": dgen["f32"]["ms_per_pose"],
                       "K7": dgen["int8"]["ms_per_pose"]},
        "train": {k: train[k] for k in ("fused", "fused_int8")},
        "frame_ms": {k: main_res[k]["ms_per_frame"] for k in ("pe", "int8")}})

    print(json.dumps({"details": {
        "device": smi, "frame": f"{H}x{W}",
        "model": "R2L W256 D88, 16 samples, L=10", "build_s": build_s,
        "pe_f32": kern["pe_f32"], "canary_max_abs_err": canary,
        "main_path": {k: v for k, v in main_res.items()
                      if k != "launches"},
        "kernel_api_frames": api, "cli_f32_frames": cli_f32,
        "pe_bf16": kern["pe"], "api_f32": kern["api_f32"],
        "api_bf16": kern["api_bf16"],
        "train_kernels": tkern,
        "train_main_path": {k: v for k, v in train.items()
                            if k != "launches"},
        "teacher": "NeRF 8x256 skip 4, viewdirs, L=10/4, 64+128 samples, "
                   f"chunk {T_CHUNK}, white, density floor {DENSITY_FLOOR}",
        "teacher_kernels": teacher, "datagen": dgen,
        "teacher_frame": tframe,
        "teacher_train": ttrain, "images_distill": idist,
        "probes": probes, "k2_probes": k2_probes, "bwd_qdx": qdx,
        "givenrays": given, "nerf_bench": nbench,
        "bench_cuda": bench_line, "checkpoints": ck,
        "cli": {k: v for k, v in cli.items()}}}))
    src = "r2l_tpu_torch/kernels/csrc/"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                **{k: r[k] for k in keys}}

    tr = "r2l_tpu/kernels/r2l_train_pallas.py"
    print(json.dumps({"kernels": [
        entry("fused_r2l_apply_pe", "r2l_pe_fused.cu",
              "r2l_tpu/kernels/r2l_pallas.py:164",
              main_res["launches"]["pe"] + given["launches"]["pe"]
              + ck["load"]["launches"]["pe"] + cli["launches"]["K1"],
              kern["pe"]),
        entry("fused_r2l_apply_pe_f32", "r2l_pe_fused.cu",
              "r2l_tpu/kernels/r2l_pallas.py:164", cli_f32["launches"],
              kern["pe_f32"]),
        entry("fused_r2l_apply_int8_pe", "r2l_int8_hopper.cu",
              "r2l_tpu/kernels/r2l_pallas.py:571",
              main_res["launches"]["int8"] + given["launches"]["int8"]
              + ck["load"]["launches"]["int8"] + cli["launches"]["K2"],
              kern["int8"]),
        entry("train_fwd", "r2l_train_fwd.cu", tr + ":54",
              train["launches_per_kind"]["fused"]["train_fwd"]
              + ck["resume"]["launches"]["train_fwd"]
              + cli["launches"]["K3"],
              tkern["train_fwd_bf16"]),
        entry("train_fwd_f32", "r2l_train_fwd.cu", tr + ":54",
              train["launches_per_kind"]["fused_f32"]["train_fwd"],
              tkern["train_fwd_f32"]),
        entry("train_fwd_int8", "r2l_train_fwd_int8.cu", tr + ":182",
              train["launches"]["train_fwd_int8"]
              + ck["resume"]["launches"]["train_fwd_int8"]
              + cli["launches"]["K4"],
              tkern["train_fwd_int8"]),
        entry("train_fwd_int8_bf16stash", "r2l_train_fwd_int8.cu",
              tr + ":182", train["launches"]["train_fwd_int8_bf16"],
              tkern["train_fwd_int8_bf16"]),
        entry("bwd_group", "r2l_bwd_group.cu", tr + ":356",
              train["launches"]["bwd_group"]
              + ck["resume"]["launches"]["bwd_group"]
              + cli["launches"]["K5"],
              tkern["bwd_group_bf16"]),
        *(entry(f"fused_r2l_apply_{kind}", "r2l_fused.cu",
                "r2l_tpu/kernels/r2l_pallas.py:270", api[kind]["launches"],
                kern[f"api_{kind}"]) for kind in ("f32", "bf16")),
        *(entry(f"fused_nerf_render_{kind}", "nerf_render_int8.cu"
                if kind == "int8" else "nerf_render.cu",
                "r2l_tpu/kernels/nerf_render_pallas.py:336",
                dgen[kind]["launches"]
                + (nbench["launches"] + cli["launches"]["K6"]
                   if kind == "f32" else 0)
                + (cli["launches"]["K7"] if kind == "int8" else 0),
                teacher[kind])
          for kind in ("f32", "bf16", "int8")),
        *(entry(name, f"{name}.cu", replaces, probes["launches"][name],
                probes[name])
          for name, replaces in (
              ("probe_chain", "exp/probe_mxu.py:144"),
              ("probe_bign", "exp/probe_mxu.py:188"),
              ("probe_int8_chain", "exp/probe_mxu.py:225"),
              ("probe_shapes", "exp/probe_shapes.py:55"))),
        *(entry(name, source, replaces, k2_probes["launches"][name],
                k2_probes[name])
          for name, source, replaces in (
              ("probe_resmlp", "probe_resmlp.cu", "exp/probe_int8.py:201"),
              ("probe_wall", "probe_int8_chain.cu", "exp/probe_wall.py:73"),
              ("probe_pipe", "r2l_int8_hopper.cu",
               "exp/probe_pipe_lib.py:19"),
              ("probe_epi", "r2l_int8_hopper.cu", "exp/probe_epi.py:112"))),
        entry("bwd_group_qdx", "r2l_bwd_qdx.cu", "exp/probe_bwd_qdx.py:70",
              qdx["launches"], qdx),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
