"""The student frame's wide form on the pass skeleton
``kernels/csrc/wide_hopper.cuh``, measured on the card: K1, K9 and K2
above W256 (``kernels/csrc/r2l_wide.cu``: the head's input written once,
every layer a pass of the skeleton, the tail's reduction): what sets their
pace, and this checkout's build against a parent's.

Each row (``ROWS``) is one whole call at ``chip_smoke.py``'s phase 21
shapes on the points of a 400x400 lego frame (160,000 rays, 16 samples,
L=10), seeded weights (``chip_smoke.wide_student``): ``k1_bf16``
(W512/D24), ``k1_f32`` (W512/D12), ``k9_bf16`` and ``k9_f32`` (W512/D24,
on ``r2l_embed`` of the points), K2's three forms ``k2_deployed``,
``k2_fold`` and ``k2_unfolded`` (W512/D50, calibrated on phase 21's
points) and ``k1_bf16_w384`` (W384/D44: twice the passes, each narrower),
packed and staged by the module that runs it.

A variant is a copy of ``kernels/csrc`` with a few source edits
(``VARIANTS``), built with the repository's nvcc flags and swapped in for
the frame's wide library, timed against the build in turns base / variant
/ variant / base (``_harness.in_turns``), timing only:

* ``noepi``: the skeleton's passes without their epilogue (no bias, no
  side tensor, no staging tile, no TMA store; the accumulators summed into
  a test that never stores, so the products stay);
* ``nomma``: without the products as well (the loads and the barriers
  alone).

The head's input and the tail run as built in both, so base minus variant
is the passes' share.

``--parent TREE`` times instead this checkout's wide forms against a
parent checkout's (unpacked with ``git archive``), the parent's imported
from the tree as a package of its own, its images and libraries its own:
each row's rgb held to the parent's (f32 within ``TOL_PE_F32``, bf16
within ``TOL_PE_BF16``, K2 bit for bit), each record saying whether they
were bit for bit, then timed in turns this checkout / parent / parent /
this checkout.

    python -m r2l_tpu_torch.exp.frame_wide_variants [--variants noepi,...] \\
        [--out PATH]
    python -m r2l_tpu_torch.exp.frame_wide_variants --parent PARENT \\
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import contextlib
import importlib
import tempfile
from pathlib import Path

import torch

from . import _harness
from .teacher_wide_variants import EPILOGUE, HEADER, MMA_SS, MMA_TF32, SINK
from .teacher_wide_variants import parent_package

LIB = "r2l_wide"
VARIANTS = {
    "noepi": ([(HEADER, EPILOGUE, SINK)], False),
    "nomma": ([(HEADER, EPILOGUE, "  fence_regs(d);"),
               (HEADER, MMA_SS, ""), (HEADER, MMA_TF32, "")], False),
}
# (row, width, depth): phase 21's shapes
ROWS = (("k1_bf16", 512, 24), ("k1_f32", 512, 12), ("k9_bf16", 512, 24),
        ("k9_f32", 512, 24), ("k2_deployed", 512, 50), ("k2_fold", 512, 50),
        ("k2_unfolded", 512, 50), ("k1_bf16_w384", 384, 44))
# K2's forms: (fold_requant, nobf16_inner)
FORMS = {"deployed": (True, True), "fold": (True, False),
         "unfolded": (False, False)}
REPS = 3


def _frame(dev):
    """Phase 21's sampler, the points of its first pose's frame and K2's
    calibration points."""
    import chip_smoke as cs
    from ..evaluate import _calibration_points
    from ..sampler import PointSampler
    sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL,
                           n_sample=cs.N_SAMPLE, near=2.0, far=6.0)
    poses = cs.lego_poses(cs.K)
    pts = sampler.sample_test(torch.as_tensor(poses[0], device=dev))
    return pts, _calibration_points(sampler, poses, dev)


def _row(F, kind: str, model, cfg, pts, calib):
    """``run()``: one call of the row ``kind`` through the module ``F``
    (``kernels.r2l_fused`` of a checkout), packed and staged by that
    checkout's own functions."""
    import chip_smoke as cs
    from ..encoding import r2l_embed
    dp, L = pts.shape[1], cs.EMBED_L
    wd = torch.float32 if kind.endswith("f32") else torch.bfloat16
    if kind.startswith("k1"):
        fp = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd)
        return lambda: F.fused_r2l_apply_pe(fp, cfg, pts, dp, L)
    if kind.startswith("k9"):
        fp = F.prepare_fused_params(model, cfg, weight_dtype=wd)
        x = r2l_embed(pts, L)
        return lambda: F.fused_r2l_apply(fp, cfg, x)
    fold, nob = FORMS[kind[3:]]
    fp = F.calibrate_r2l_int8_pe(model, cfg, dp, L, calib,
                                 fold_requant=fold)
    return lambda: F.fused_r2l_apply_int8_pe(fp, cfg, pts, dp, L, fold, nob)


def _bounds(kind: str, cfg, n: int) -> dict:
    """A row's operations bound (f32 three TF32 products a multiply-add)
    and its design's bytes at the memory rate
    (``chip_smoke.wide_frame_design_bytes``)."""
    import chip_smoke as cs
    from ._harness import chain_ops
    ops = chain_ops(cfg, n, cfg.input_dim)
    f32 = kind.endswith("f32")
    peak = "tf32" if f32 else "int8" if kind.startswith("k2") else "bf16"
    design = cs.wide_frame_design_bytes(
        {"k1": "pe", "k9": "K9", "k2": "int8"}[kind[:2]], 4 if f32 else 2, n,
        cfg.netwidth, cfg.input_dim, cfg.num_blocks, cfg.n_learnable,
        cfg.use_residual)
    return {"bound_ms": _harness.bound_ms(3 * ops if f32 else ops, peak),
            "design_bytes_ms": design / cs.HBM_BYTES_S * 1e3}


def _each_row(dev, fn) -> None:
    """fn(kind, cfg, model, pts, calib, bounds) for every row, one
    student on the card at a time."""
    import chip_smoke as cs
    pts, calib = _frame(dev)
    for kind, width, depth in ROWS:
        dtype = torch.float32 if kind.endswith("f32") else torch.bfloat16
        cfg, model = cs.wide_student(width, depth, dtype, dev)
        fn(kind, cfg, model, pts, calib, _bounds(kind, cfg, pts.shape[0]))
        del model
        torch.cuda.empty_cache()


def _same(kind: str, got, want) -> dict:
    """A row's two outputs held to each other: their max-abs distance and
    whether bit for bit; AssertionError past the kind's limit (K2: bit for
    bit)."""
    import chip_smoke as cs
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    diff = float((got - want).abs().max())
    lim = (0.0 if kind.startswith("k2") else
           cs.TOL_PE_F32 if kind.endswith("f32") else cs.TOL_PE_BF16)
    if not (same or diff <= lim):
        raise AssertionError(f"{kind}: this checkout and the other build "
                             f"differ by {diff:.3e}")
    return {"max_diff": diff, "bit_for_bit": same}


def time_variants(names, log, reps: int = REPS) -> None:
    """Each variant against this checkout's build on every row, in
    turns."""
    from ..kernels import _build
    from ..kernels import r2l_fused as F
    dev = _harness.require_cuda("frame_wide_variants")
    log(_harness.device_record())
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.build_variants(
            {n: (VARIANTS[n][0], LIB) for n in names}, Path(tmp))
        _build.load(LIB)

        def one(kind, cfg, model, pts, calib, bounds):
            run = _row(F, kind, model, cfg, pts, calib)
            for name in names:
                base_ms, variant_ms, _ = _harness.in_turns(
                    run, run, lambda lib=libs[name][0]: _harness.loading(lib),
                    reps)
                log({"name": f"{name}_{kind}", "base_ms": base_ms,
                     "variant_ms": variant_ms, **bounds,
                     "build": libs[name][1][:12]})
        _each_row(dev, one)


def compare_parent(tree: str, log, reps: int = REPS) -> None:
    """Every row in this checkout and in the parent's: rgb held to each
    other (``_same``), then timed in turns."""
    from ..kernels import r2l_fused as F
    dev = _harness.require_cuda("frame_wide_variants")
    log(_harness.device_record())
    PF = importlib.import_module(parent_package(tree).__name__
                                 + ".kernels.r2l_fused")

    def one(kind, cfg, model, pts, calib, bounds):
        new = _row(F, kind, model, cfg, pts, calib)
        old = _row(PF, kind, model, cfg, pts, calib)
        rec = _same(kind, new(), old())
        base_ms, parent_ms, _ = _harness.in_turns(
            new, old, contextlib.nullcontext, reps)
        log({"name": f"parent_{kind}", "base_ms": base_ms,
             "parent_ms": parent_ms, **rec, **bounds,
             "registers": _harness.registers(LIB)})
    _each_row(dev, one)


def main(argv=None) -> None:
    _harness.variants_main("frame_wide_variants", __doc__, VARIANTS,
                           time_variants, argv, compare_parent)


if __name__ == "__main__":
    main()
