"""K7's inner dequantize in f32 or in bf16 (``bf16_requant``), on the
teacher frame.

Port of ``exp/probe_teacher_bf16rq.py``: the canonical teacher (``_teacher``:
8x256 with the skip, view directions, L = 10 / 4, 64 + 128 samples, 400x400
frames in chunks of 32,768 rays) in static-scale int8 with the requantize
folded (K7), each chunk rendered as the JAX driver's ``chunk_full``: the
coarse depths, K7's coarse pass, ``sample_pdf`` (deterministic) on its
weights, K7's fine pass on the sorted union. One row per distinct function:

* ``r5_bf16rq_rgb_rms_delta``: frame 0's first chunk (its coarse and fine
  pass) rendered with the f32 and with the bf16 dequantize; the RMS
  (``rms``) and the largest (``max``) of their rgb's difference;
* ``r5_f32rq`` and ``r5_bf16rq``: K frames of each (``--frames``), timed in
  interleaved rounds as the JAX driver's A/B (one warm-up call each, its
  seconds ``warmup_s`` where the JAX driver records ``compile_s``, then
  ``--rounds`` rounds of one call each in turn, the fastest of each), with
  frame 0's first chunk held against its plain version (max-abs, bit for
  bit, the plain version's ms).

The frames, the networks and the int8 calibration are the other teacher
drivers' (``_teacher``, ``probe_teacher_int8.setup``): K lego poses and a
calibration on their rays, where the JAX driver renders one pose K times
(offset by up to 1e-5) and calibrates on 4,096 uniform points. Not ported:
``sample_pairs`` (8) and the ray tiles (1024, 2048), TPU scheduling that
changes no number: one row per function, where the JAX driver has one a
tile.

    python -m r2l_tpu_torch.exp.probe_teacher_bf16rq [--frames K]
        [--rounds R] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import time

import torch

from ..kernels.nerf_render import fused_nerf_render, fused_nerf_render_ref
from ..render import coarse_z, prepare_fused_teacher
from ..volume import sample_pdf
from . import _harness, _teacher
from .probe_teacher_int8 import setup

K = _teacher.K          # frames per call
ROUNDS = 3
VARIANTS = (("r5_f32rq", False), ("r5_bf16rq", True))


def chunk_rgb(packed: tuple, ncfg, vcfg, o: torch.Tensor, d: torch.Tensor,
              bf16_requant: bool, render=fused_nerf_render) -> torch.Tensor:
    """One chunk's rgb (the JAX driver's ``chunk_full``): K7's coarse pass on
    the even depths, ``sample_pdf`` on its weights, its fine pass on the
    sorted union (``render``: the kernel, or its plain version)."""
    fpc, fpf = packed
    kw = dict(L_pts=vcfg.multires, L_views=vcfg.multires_views,
              white_bkgd=vcfg.white_bkgd, bf16_requant=bf16_requant)
    z = coarse_z(vcfg, o.shape[0], o.device).contiguous()
    w = render(fpc, ncfg, o, d, z, **kw)[3]
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_samp = sample_pdf(z_mid, w[:, 1:-1], vcfg.n_fine, det=True)
    z_all = torch.sort(torch.cat([z, z_samp], -1), -1).values.contiguous()
    return render(fpf, ncfg, o, d, z_all, **kw)[0]


def frames_sum(packed: tuple, ncfg, vcfg, ro: torch.Tensor,
               rd: torch.Tensor, bf16_requant: bool) -> torch.Tensor:
    """The sum of the k frames' rgb, chunk after chunk."""
    total = torch.zeros((), dtype=torch.float32, device=ro.device)
    for o, d in zip(ro, rd):
        for c in range(0, o.shape[0], vcfg.ray_chunk):
            s = slice(c, c + vcfg.ray_chunk)
            total += chunk_rgb(packed, ncfg, vcfg, o[s], d[s],
                               bf16_requant).sum()
    return total


def plain_check(packed: tuple, ncfg, vcfg, o, d, bf16_requant: bool
                ) -> dict:
    """The chunk's rgb against its plain version: max-abs, bit for bit and
    the plain version's ms (one call, CUDA events)."""
    got = chunk_rgb(packed, ncfg, vcfg, o, d, bf16_requant)
    t, want = _harness.time_calls(
        lambda: chunk_rgb(packed, ncfg, vcfg, o, d, bf16_requant,
                          fused_nerf_render_ref), 1, warm=False)
    return {"max_abs_err_vs_plain": float((got - want).abs().max()),
            "bit_for_bit": bool(torch.equal(got, want)),
            "plain_ms": t["ms"]}


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_teacher_bf16rq", __doc__,
        frames=K, rounds=ROUNDS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    ncfg, vcfg, (mc, mf), ro, rd, calib = setup(
        dev, torch.Generator().manual_seed(_teacher.SEED), args.frames)
    packed = prepare_fused_teacher(mc, mf, ncfg, vcfg, int8_calib=calib,
                                   fold_requant=True)
    o0, d0 = ro[0, :vcfg.ray_chunk], rd[0, :vcfg.ray_chunk]
    a, b = (chunk_rgb(packed, ncfg, vcfg, o0, d0, brq)
            for brq in (False, True))
    diff = (a - b).double()
    recs.append(log({"name": "r5_bf16rq_rgb_rms_delta",
                     "rms": float(diff.pow(2).mean().sqrt()),
                     "max": float(diff.abs().max())}))
    ops = _teacher.frame_ops(ncfg, vcfg, ro.shape[1])
    calls = {name: (lambda brq=brq: frames_sum(packed, ncfg, vcfg, ro, rd,
                                               brq))
             for name, brq in VARIANTS}
    best, warmup_s = {name: float("inf") for name in calls}, {}
    for name, fn in calls.items():   # warm up both before any timing
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        warmup_s[name] = time.time() - t0
    for _ in range(args.rounds):     # interleaved rounds
        for name, fn in calls.items():
            t, _ = _harness.time_calls(fn, 1, args.frames, warm=False)
            best[name] = min(best[name], t["ms"])
    for name, brq in VARIANTS:
        recs.append(log(_harness.rate(
            {"name": name, "ms_per_frame": best[name],
             "warmup_s": warmup_s[name], "bf16_requant": brq,
             **plain_check(packed, ncfg, vcfg, o0, d0, brq)},
            ops, "int8", best[name])))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
