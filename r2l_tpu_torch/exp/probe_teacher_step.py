"""The NeRF teacher's training step at the reference's lego configuration.

Port of ``exp/probe_teacher_step.py:39-84``: two W256/D8 networks (coarse
and fine, with view directions), 64 + 128 samples perturbed, sigma noise 1,
a white background, 4,096 rays a step from a pool of 2^20 uniform records,
lrate 5e-4 decaying over 500k steps, through ``make_teacher_step_batched``
(the ``use_batching`` step; plain autograd, as the JAX package leaves it to
XLA):

* ``r3_teacher_step_scan1``: one step a call, 64 calls;
* ``r3_teacher_step_scan16``: 16 steps a call (``scan_steps=16``), 4 calls.

Each starts from the same weights, takes one warm-up call, then its calls
back to back timed with CUDA events (call i at pool offset i): ms/step,
rays/s, and the hours 200k steps would take.

    python -m r2l_tpu_torch.exp.probe_teacher_step [--steps N] [--reps R]
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import copy
import time

import torch

from ..models.nerf import NeRFConfig, init_nerf
from ..render import VolRenderConfig
from ..train import (TeacherTrainConfig, init_teacher_state,
                     make_teacher_step_batched)
from . import _harness, _teacher, _train

SCANS = (1, 16)
N_STEPS = 64            # timed steps per variant
POOL = 1 << 20
SEED, POOL_SEED, STEP_SEED = 0, 2, 3


def configs(W: int = 256, n_coarse: int = 64, n_fine: int = 128,
            n_rand: int = 4096):
    """(ncfg, vcfg, tcfg) of the lego teacher's training (a test passes
    smaller sizes)."""
    return (NeRFConfig(D=8, W=W, use_viewdirs=True),
            VolRenderConfig(n_coarse=n_coarse, n_fine=n_fine, perturb=True,
                            raw_noise_std=1.0, white_bkgd=True, near=2.0,
                            far=6.0, lindisp=False),
            TeacherTrainConfig(n_rand=n_rand, lrate=5e-4, lrate_decay=500))


def networks(ncfg: NeRFConfig, generator: torch.Generator, device):
    """(coarse, fine) from ``generator``, in that order."""
    return (init_nerf(ncfg, generator, device),
            init_nerf(ncfg, generator, device))


def step_ops(ncfg: NeRFConfig, vcfg: VolRenderConfig, n_rand: int) -> float:
    """Operations of one step: the coarse and fine passes' points, forward
    and two backward products per layer."""
    pts = vcfg.n_coarse + vcfg.n_coarse + vcfg.n_fine
    return 3.0 * _teacher.point_ops(ncfg) * n_rand * pts


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_teacher_step", __doc__,
        steps=N_STEPS, reps=_train.REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    ncfg, vcfg, tcfg = configs()
    recs = [log({**_harness.device_record(), "config": "W256D8 x2, 64+128 "
                 f"samples, N_rand {tcfg.n_rand}"})]
    nets = networks(ncfg, torch.Generator().manual_seed(SEED), dev)
    pool = _train.uniform((POOL, 9), torch.Generator().manual_seed(
        POOL_SEED), dev)
    for scan in SCANS:
        mc, mf = (copy.deepcopy(m) for m in nets)
        state = init_teacher_state(mc, mf, tcfg)
        step = make_teacher_step_batched(ncfg, vcfg, tcfg, ncfg_fine=ncfg,
                                         scan_steps=scan, device=dev)
        gen = torch.Generator(dev).manual_seed(STEP_SEED)
        t0 = time.time()
        state, m = step(state, pool, 0, generator=gen)
        float(m["loss"].reshape(-1)[-1])
        warmup_s = time.time() - t0
        n = max(args.steps // scan, 1)

        def calls():
            st = state
            for i in range(n):
                st, _ = step(st, pool, i, generator=gen)

        t, _ = _harness.time_calls(calls, args.reps, n * scan, warm=False)
        ms = t["ms"]
        recs.append(log(_harness.rate(
            {"name": f"r3_teacher_step_scan{scan}", "ms_per_step": ms,
             "rays_per_sec": tcfg.n_rand / (ms * 1e-3),
             "iters_200k_hours": 200000 * ms / 3.6e6,
             "warmup_s": warmup_s, "loss": float(m["loss"].reshape(-1)[-1])},
            step_ops(ncfg, vcfg, tcfg.n_rand), "f32", ms)))
        del state, step, mc, mf
        torch.cuda.empty_cache()
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
