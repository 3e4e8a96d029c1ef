"""The teacher frame at two ray chunks, int8 (K7) and bf16 (K6).

Port of ``exp/probe_teacher_chunk.py:45-69``: the canonical teacher and its
int8 calibration (``_teacher``, as ``probe_teacher_int8``) rendered by
``render_frame_nerf_fused`` with ``ray_chunk`` 65,536 and 160,000 (the whole
400x400 frame in one chunk), each in ``int8`` (K7, requantize not folded)
and ``bf16`` (K6). Each mode's networks are packed once (the chunk does not
change the packing); each of the four renders K = 4 frames, one warm-up call
and the fastest of 3 timed with CUDA events. The JAX driver's ray tile
(4096) is TPU scheduling.

    python -m r2l_tpu_torch.exp.probe_teacher_chunk [--reps R] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import dataclasses

import torch

from ..render import prepare_fused_teacher, render_frame_nerf_fused
from . import _harness, _teacher
from .probe_teacher_int8 import frames_sum, setup

K = _teacher.K          # frames per call
REPS = 3
CHUNKS = (65536, 160000)
MODES = ("int8", "bf16")


def packings(nets: tuple, ncfg, vcfg, calib: tuple) -> dict:
    """mode -> the (coarse, fine) packing: int8 calibrated, or bf16."""
    mc, mf = nets
    return {mode: prepare_fused_teacher(
        mc, mf, ncfg, vcfg, int8_calib=calib if mode == "int8" else None)
        for mode in MODES}


def frame_fn(nets: tuple, ncfg, vcfg, packed: tuple, chunk: int):
    """(rays_o, rays_d) -> rgb, rendered in chunks of ``chunk`` rays."""
    mc, mf = nets
    vc = dataclasses.replace(vcfg, ray_chunk=chunk)
    return lambda o, d: render_frame_nerf_fused(mc, mf, ncfg, vc, o, d,
                                                packed=packed)["rgb"]


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_teacher_chunk", __doc__,
        reps=REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    ncfg, vcfg, nets, ro, rd, calib = setup(
        dev, torch.Generator().manual_seed(_teacher.SEED))
    packs = packings(nets, ncfg, vcfg, calib)
    ops = _teacher.frame_ops(ncfg, vcfg, ro.shape[1])
    for chunk in CHUNKS:
        for mode in MODES:
            frame = frame_fn(nets, ncfg, vcfg, packs[mode], chunk)
            recs.append(_harness.timed(
                f"chunk{chunk}_{mode}", lambda f=frame: frames_sum(f, ro, rd),
                args.reps, ro.shape[0], log, ops=ops, peak=mode,
                extra={"chunk": chunk, "mode": mode}))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
