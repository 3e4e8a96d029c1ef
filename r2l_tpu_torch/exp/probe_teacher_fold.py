"""K7's requantize folded or not, on the teacher frame.

Port of ``exp/probe_teacher_fold.py:30-100``: the canonical teacher and its
int8 calibration (``_teacher``, as ``probe_teacher_int8``) rendered by
``render_frame_nerf_fused`` in int8 (K7), packed with
``prepare_fused_nerf(..., fold_requant=)``:

* ``r3_int8_unfolded_ctrl``: the inverse scales applied in the epilogue;
* ``r3_int8_folded``: each consumer's inverse scale folded into its
  producer's multiplier and bias, the requantize round and clip alone;
* ``r3_int8_unfolded_rerun``: the control again, to bracket drift.

Each packs once, renders frame 0 (the warm-up), then the K = 4 frames, the
fastest of 4 calls timed with CUDA events; frame 0 of the second and third
is held against the control's (``rgb_err_vs_ctrl_max``/``_mean``, the
PSNR). The JAX driver's ray tile (4096) is TPU scheduling.

    python -m r2l_tpu_torch.exp.probe_teacher_fold [--reps R] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import time

import torch

from ..render import prepare_fused_teacher, render_frame_nerf_fused
from . import _harness, _teacher
from .probe_teacher_int8 import setup, time_teacher_frames

K = _teacher.K          # frames per call
REPS = 4
VARIANTS = (("r3_int8_unfolded_ctrl", False), ("r3_int8_folded", True),
            ("r3_int8_unfolded_rerun", False))


def variant(fold: bool, nets: tuple, ncfg, vcfg, calib: tuple):
    """K7's frame function (rays_o, rays_d) -> rgb with the requantize
    folded or not, packed and calibrated once here."""
    mc, mf = nets
    packed = prepare_fused_teacher(mc, mf, ncfg, vcfg, int8_calib=calib,
                                   fold_requant=fold)
    return lambda o, d: render_frame_nerf_fused(mc, mf, ncfg, vcfg, o, d,
                                                packed=packed)["rgb"]


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_teacher_fold", __doc__,
        reps=REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    ncfg, vcfg, nets, ro, rd, calib = setup(
        dev, torch.Generator().manual_seed(_teacher.SEED))
    ops = _teacher.frame_ops(ncfg, vcfg, ro.shape[1])
    ref = None
    for name, fold in VARIANTS:
        t0 = time.time()
        frame = variant(fold, nets, ncfg, vcfg, calib)
        torch.cuda.synchronize()
        rec, rgb0 = time_teacher_frames(
            name, frame, ro, rd, args.reps, log, ops, "int8",
            {"fold_requant": fold, "pack_s": time.time() - t0})
        if ref is None:
            ref = rgb0
        else:
            rec.update(_teacher.rgb_errors(rgb0, ref, "ctrl"))
            rec["bit_for_bit_vs_ctrl"] = bool(torch.equal(rgb0, ref))
        recs.append(log(rec))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
