"""K2's requantize epilogues and its bf16 global residual over 16 frames,
each beside its plain version.

Port of ``exp/probe_epi2.py:70-85`` and ``exp/probe_epi3.py:62-65`` (the
JAX follow-up appends to the first one's log, so here they are one
driver). The canonical W256/D88 student (random weights from a seeded
generator), calibrated on every other of the 16 lego poses at 50x50
(focal / 8) twice: unfolded, and with the requantize folded. K2's forms by
its flags ``(fold_requant, nobf16_inner, bf16_resid)``, each on its own
packing; ``probe_epi2``'s four rows (``EPI2_FORMS``):

* ``base`` (False, False, False): the unfolded packing, the inner
  product's inverse scale applied in the epilogue;
* ``bf16_resid`` (False, False, True): ``base`` with the global residual in
  bf16 (h0 rounded to bf16, the tail's input h + h0 added in bf16);
* ``fold_requant`` (True, False, False): the folded packing, the
  within-block activation rounded to bf16 before round and clip;
* ``both`` (True, False, True): ``fold_requant`` with the bf16 residual;

then ``probe_epi3``'s row:

* ``fold+nobf16`` (True, True, False): the folded packing, f32 straight
  into round and clip (the deployed form).

Every flag is passed as the JAX driver means it: the port's defaults are
the deployed form, JAX's are ``base``. Each form renders the frames
(``sample_test`` -> K2 -> the frame's sum, one warm-up then the fastest of
5 calls) and is held on pose 0 against its plain version
(``fused_r2l_apply_int8_pe_ref``), timed once. Then the fastest of the
four ``probe_epi2`` rows is named (``best``) and timed again last
(``<best>-rerun``), as the JAX driver names its winner and brackets drift.
Not ported: the tile sweeps (TPU scheduling, one row each).

    python -m r2l_tpu_torch.exp.probe_epi2 [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from ..kernels.r2l_fused import (calibrate_r2l_int8_pe,
                                  fused_r2l_apply_int8_pe,
                                  fused_r2l_apply_int8_pe_ref)
from ..models.r2l import R2LConfig, init_r2l
from ..sampler import PointSampler
from . import _harness

H = W = _harness.LEGO_HW
FOCAL = _harness.LEGO_FOCAL
K = 16          # frames per call
REPS = 5
L = 10
DIM = 48        # 16 samples x 3
CALIB_HW = 50   # the calibration sampler's side (focal / 8)
SEED = 0        # the student's weights
# (name, fold_requant, nobf16_inner, bf16_resid): exp/probe_epi2.py:70-74's
# rows, then exp/probe_epi3.py:62's
EPI2_FORMS = (("base", False, False, False),
              ("bf16_resid", False, False, True),
              ("fold_requant", True, False, False),
              ("both", True, False, True))
FORMS = EPI2_FORMS + (("fold+nobf16", True, True, False),)


def setup(device, generator: torch.Generator, k: int = K,
          cfg: R2LConfig | None = None, hw: int = H, focal: float = FOCAL,
          calib_hw: int = CALIB_HW):
    """(cfg, {fold_requant: packing}, sampler, poses [k, 3, 4]): the
    canonical student (or ``cfg``) from ``generator``, calibrated on
    ``sample_test`` of poses 0, 2, 4, ... at ``calib_hw`` (focal / 8),
    unfolded and folded."""
    cfg = cfg or R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, generator, device)
    sampler, poses = _harness.lego_frames(k, device, hw, focal)
    sub = PointSampler(H=calib_hw, W=calib_hw, focal=focal / 8, n_sample=16,
                       near=2.0, far=6.0)
    calib = torch.cat([sub.sample_test(poses[i]) for i in range(0, k, 2)])
    fps = {fold: calibrate_r2l_int8_pe(model, cfg, DIM, L, calib,
                                       fold_requant=fold)
           for fold in (False, True)}
    return cfg, fps, sampler, poses


def form(fps: dict, cfg: R2LConfig, pts: torch.Tensor, fold: bool,
         nobf16: bool, bf16_resid: bool = False) -> torch.Tensor:
    """K2 in the form (fold, nobf16, bf16_resid) on its packing: pts ->
    rgb."""
    return fused_r2l_apply_int8_pe(fps[fold], cfg, pts, DIM, L,
                                   fold_requant=fold, nobf16_inner=nobf16,
                                   bf16_resid=bf16_resid)


def form_ref(fps: dict, cfg: R2LConfig, pts: torch.Tensor, fold: bool,
             nobf16: bool, bf16_resid: bool = False) -> torch.Tensor:
    """The form's plain version."""
    return fused_r2l_apply_int8_pe_ref(fps[fold], cfg, pts, DIM, L,
                                       fold_requant=fold,
                                       nobf16_inner=nobf16,
                                       bf16_resid=bf16_resid)


def plain_check(fps: dict, cfg: R2LConfig, pts: torch.Tensor, fold: bool,
                nobf16: bool, bf16_resid: bool = False) -> dict:
    """The form on ``pts`` against its plain version: max-abs, RMS, bit
    for bit, and the plain version's ms (one call, CUDA events)."""
    got = form(fps, cfg, pts, fold, nobf16, bf16_resid)
    t, want = _harness.time_calls(
        lambda: form_ref(fps, cfg, pts, fold, nobf16, bf16_resid), 1,
        warm=False)
    d = (got - want).double()
    return {"max_abs_err_vs_plain": float(d.abs().max()),
            "rms_err_vs_plain": float(d.pow(2).mean().sqrt()),
            "bit_for_bit": bool(torch.equal(got, want)),
            "plain_ms": t["ms"]}


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_epi2",
                          __doc__)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, fps, sampler, poses = setup(
        dev, torch.Generator().manual_seed(SEED))
    pts0 = sampler.sample_test(poses[0])
    ops = _harness.chain_ops(cfg, sampler.H * sampler.W, cfg.input_dim)
    ms = {}
    for name, fold, nobf16, br in FORMS:
        rec = _harness.time_frames(
            "variant", name,
            lambda q, f=fold, b=nobf16, r=br: form(fps, cfg, q, f, b, r),
            sampler, poses, log, REPS, ops,
            extra={"fold_requant": fold, "nobf16_inner": nobf16,
                   "bf16_resid": br,
                   **plain_check(fps, cfg, pts0, fold, nobf16, br)})
        ms[name] = rec["ms_per_frame"]
        recs.append(rec)
    best = min((f[0] for f in EPI2_FORMS), key=ms.get)
    recs.append(log({"name": "best", "variant": best, "ms_per_frame":
                     ms[best]}))
    _, fold, nobf16, br = next(f for f in FORMS if f[0] == best)
    recs.append(_harness.time_frames(
        "variant", f"{best}-rerun",
        lambda q: form(fps, cfg, q, fold, nobf16, br), sampler, poses, log,
        REPS, ops))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
