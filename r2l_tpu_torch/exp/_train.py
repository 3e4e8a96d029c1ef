"""The training drivers' shared setup (``exp/probe_train.py:29-39``, repeated
by ``probe_train_int8.py``, ``probe_train_decomp.py``,
``probe_calib_dispatch.py`` and ``probe_strat.py``) and their step timing.

The canonical W256/D88 student in bf16 (random weights from a seeded
generator) distilled at the reference's training configuration: 81,920
rays a step with hard mining (8,192 in, 16,384 out, a pool of 20 x the
batch), L = 10, a 400x400 sampler (16 samples, near 2, far 6, focal
555.555), no warm-up; the int8 kinds calibrate on ``sample_test`` of four
32x32 poses (focal / 12.5) at theta 0, 90, 180 and 270. The fresh rays of a
step are one fixed batch of uniform records, as the JAX drivers feed.

A driver times its variants as N steps back to back after one warm-up step,
between two CUDA events with one synchronisation (the JAX drivers' one
readback after N queued steps); with ``--reps R`` the fastest of R such
calls. Each setup function takes an explicit device and a seeded
``torch.Generator``, so the tests build the same pieces on the CPU at
small sizes.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..models.r2l import R2L, R2LConfig, init_r2l
from ..rays import pose_spherical
from ..sampler import PointSampler
from ..train import DistillConfig, init_train_state, make_distill_step
from . import _harness

B = 81920
N_HARD_IN, N_HARD_OUT = 8192, 16384
HARD_MUL = 20.0
EMBED_L = 10
HW, FOCAL = 400, 555.555
N_SAMPLE = 16
CALIB_HW = 32
CALIB_THETAS = (0.0, 90.0, 180.0, 270.0)
N_STEPS = 50            # timed steps after one warm-up
REPS = 1                # calls of N steps timed (the JAX drivers' one)
SEED = 0                # the student's weights
DATA_SEED = 2           # the fresh batch
STEP_SEED = 10          # the steps' draws


def distill_config(batch: int = B, n_in: int = N_HARD_IN,
                   n_out: int = N_HARD_OUT, **kw) -> DistillConfig:
    return DistillConfig(batch_size=batch, n_hard_in=n_in, n_hard_out=n_out,
                         hard_mul=HARD_MUL, embed_L=EMBED_L, **kw)


def sampler(hw: int = HW, focal: float = FOCAL) -> PointSampler:
    return PointSampler(H=hw, W=hw, focal=focal, n_sample=N_SAMPLE,
                        near=2.0, far=6.0)


def calib_points(device, hw: int = CALIB_HW,
                 focal: float = FOCAL / 12.5) -> torch.Tensor:
    """The int8 kinds' calibration points [4 * hw * hw, 48]."""
    sub = PointSampler(H=hw, W=hw, focal=focal, n_sample=N_SAMPLE, near=2.0,
                       far=6.0)
    return torch.cat([sub.sample_test(torch.as_tensor(
        np.asarray(pose_spherical(t, -30.0, 4.0))[:3, :4],
        dtype=torch.float32, device=device)) for t in CALIB_THETAS])


def student(generator: torch.Generator, device,
            cfg: R2LConfig | None = None) -> tuple[R2LConfig, R2L]:
    """(cfg, model): the canonical bf16 student (or ``cfg``)."""
    cfg = cfg or R2LConfig(compute_dtype=torch.bfloat16)
    return cfg, init_r2l(cfg, generator, device)


def uniform(shape: tuple, generator: torch.Generator, device,
            lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """U[lo, hi) f32 of ``shape``, drawn on the CPU, moved to ``device``."""
    return (torch.rand(shape, generator=generator) * (hi - lo) + lo
            ).to(device)


def variant_step(model: R2L, cfg: R2LConfig, dcfg: DistillConfig,
                 smp: PointSampler, device, **kw):
    """A fresh training state around a copy of ``model`` (the variants
    start from the same weights) and its step of kind ``kw``."""
    state = init_train_state(copy.deepcopy(model), dcfg, device=device)
    return state, make_distill_step(cfg, dcfg, smp, device=device, **kw)


def time_steps(step, state, batch: torch.Tensor, n: int, device,
               reps: int = 1) -> tuple[dict, object]:
    """One warm-up step, then ``reps`` calls of ``n`` steps each, queued
    back to back between two CUDA events; every step draws from one
    generator on ``device`` seeded ``STEP_SEED``. -> ({ms_per_step (the
    fastest call's), all_ms, warmup_s, loss_first (the warm-up step's),
    loss (the last)}, state). A scanned step (``scan_steps`` k) counts as
    k steps: ``batch`` is then [k, ...] and ``n`` counts dispatches."""
    gen = torch.Generator(device).manual_seed(STEP_SEED)
    per = batch.shape[0] if batch.dim() == 3 else 1
    t0 = time.time()
    state, m = step(state, batch, generator=gen)
    first = float(m["loss"].reshape(-1)[0])
    warmup_s = time.time() - t0

    def call():
        nonlocal state, m
        for _ in range(n):
            state, m = step(state, batch, generator=gen)

    t, _ = _harness.time_calls(call, reps, n * per, warm=False)
    return {"ms_per_step": t["ms"], "all_ms": t["all_ms"],
            "warmup_s": warmup_s, "loss_first": first,
            "loss": float(m["loss"].reshape(-1)[-1])}, state


def step_record(name: str, t: dict, dcfg: DistillConfig, cfg: R2LConfig,
                extra: dict | None = None) -> dict:
    """A step variant's record: ms/step, rays/s, the losses, and the share
    of the bf16 peak of the step's products (a forward and two backward
    products per layer: 3 x the chain's operations)."""
    rec = {"name": name, **t,
           "rays_per_sec": dcfg.batch_size / (t["ms_per_step"] * 1e-3),
           "device": torch.cuda.get_device_name(0)}
    _harness.rate(rec, 3.0 * _harness.chain_ops(cfg, dcfg.batch_size,
                                                cfg.input_dim), "bf16",
                  t["ms_per_step"])
    rec.update(extra or {})
    return rec
