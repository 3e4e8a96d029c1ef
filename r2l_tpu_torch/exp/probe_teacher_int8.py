"""The teacher frame three ways: K6 bf16, K7 int8, and the plain render.

Port of ``exp/probe_teacher_int8.py:40-116``, at the canonical size
(``_teacher``: 8x256 with the skip, view directions, 64 + 128 samples,
400x400, chunks of 32,768 rays):

* ``fused_bf16``: ``render_frame_nerf_fused`` with bf16 weights (K6);
* ``fused_int8``: the same with the weights in static-scale int8 (K7),
  calibrated on every 640th ray of the K frames at 9 depths, requantize not
  folded (the render's default);
* ``xla``: ``render_frame_nerf``, the plain render through the ``NeRF``
  module.

Each variant packs its networks once (``prepare_fused_teacher``; the pack
and calibration time is recorded apart), renders frame 0 (which also warms
up and builds), then the K = 4 frames back to back, the fastest of 3 calls
timed with CUDA events. On frame 0 the int8 and plain frames are held
against the bf16 one: ``rgb_err_vs_bf16_max``/``_mean`` as the JAX driver
records them, and the PSNR. Where a variant fails the driver raises (the
JAX driver logs an error row and goes on).

    python -m r2l_tpu_torch.exp.probe_teacher_int8 [--frames K] [--reps R]
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import time

import torch

from ..render import (prepare_fused_teacher, render_frame_nerf,
                      render_frame_nerf_fused)
from . import _harness, _teacher

K = _teacher.K          # frames per call
REPS = 3
VARIANTS = ("fused_bf16", "fused_int8", "xla")


def setup(device, generator: torch.Generator, k: int = K, ncfg=None,
          vcfg=None, hw: int = _teacher.H, focal: float = _teacher.FOCAL):
    """(ncfg, vcfg, (coarse, fine), rays_o, rays_d [k, N, 3], calibration):
    the canonical teacher (or ``ncfg``/``vcfg``) from ``generator``."""
    ncfg = ncfg or _teacher.nerf_cfg()
    vcfg = vcfg or _teacher.vol_cfg()
    nets = _teacher.networks(ncfg, generator, device)
    ro, rd = _teacher.frame_rays(k, device, hw, focal)
    return ncfg, vcfg, nets, ro, rd, _teacher.calibration(ro, rd)


def variant(name: str, nets: tuple, ncfg, vcfg, calib: tuple):
    """The variant's frame function (rays_o, rays_d [N, 3]) -> rgb [N, 3],
    its networks packed (and calibrated) once here."""
    mc, mf = nets
    if name == "xla":
        return lambda o, d: render_frame_nerf(mc, mf, ncfg, vcfg, o,
                                              d)["rgb"]
    if name not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {name!r}")
    packed = prepare_fused_teacher(
        mc, mf, ncfg, vcfg, int8_calib=calib if name == "fused_int8"
        else None)
    return lambda o, d: render_frame_nerf_fused(mc, mf, ncfg, vcfg, o, d,
                                                packed=packed)["rgb"]


def frames_sum(frame, ro: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """The sum of each frame's rgb sum, frame after frame."""
    return torch.stack([frame(o, d).sum() for o, d in zip(ro, rd)]).sum()


def time_teacher_frames(name: str, frame, ro, rd, reps: int, log,
                        ops: float, peak: str, extra: dict
                        ) -> tuple[dict, torch.Tensor]:
    """Frame 0 (the warm-up), then ``reps`` calls of the k frames: the
    record and frame 0's rgb."""
    t0 = time.time()
    rgb0 = frame(ro[0], rd[0])
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    t, checksum = _harness.time_calls(lambda: frames_sum(frame, ro, rd),
                                      reps, ro.shape[0], warm=False)
    rec = _harness.rate({"name": name, "ms_per_frame": t["ms"],
                         "all_ms": t["all_ms"], "warmup_s": warmup_s,
                         "checksum": float(checksum), **extra}, ops, peak,
                        t["ms"])
    return rec, rgb0


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_teacher_int8", __doc__,
        frames=K, reps=REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    ncfg, vcfg, nets, ro, rd, calib = setup(
        dev, torch.Generator().manual_seed(_teacher.SEED), args.frames)
    ops = _teacher.frame_ops(ncfg, vcfg, ro.shape[1])
    ref = None
    for name in VARIANTS:
        t0 = time.time()
        frame = variant(name, nets, ncfg, vcfg, calib)
        torch.cuda.synchronize()
        pack_s = time.time() - t0
        rec, rgb0 = time_teacher_frames(
            name, frame, ro, rd, args.reps, log, ops,
            "int8" if name == "fused_int8" else "bf16", {"pack_s": pack_s})
        if ref is None:
            ref = rgb0
        else:
            rec.update(_teacher.rgb_errors(rgb0, ref, "bf16"))
        recs.append(log(rec))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
