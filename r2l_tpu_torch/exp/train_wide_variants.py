"""The training kernels' wide forms on the pass skeleton
``kernels/csrc/wide_hopper.cuh``, measured on the card: K5's
(``kernels/csrc/r2l_wide_bwd.cu``: the dh walk on the skeleton, the dW pass
on ``wgmma``) and the forward's (``kernels/csrc/r2l_wide_train.cu``:
K3 bf16 and f32, K4, K8, every layer on the skeleton): what sets their
pace, and this checkout's build against a parent's.

Each K5 row is one 4-block call of ``chip_smoke.py``'s phase 22: the
W512/D88 student (seeded weights) at a step's 81,920 rays, the top group
(blocks 39..42) of its body, on one of the five stash kinds: ``bf16`` and
``f32`` (K3's wide stash under bf16 and f32 weights), ``int8`` (K4's
q-value stash, bf16 weights), ``int8_bf16`` (K8's bf16 stash, bf16
weights) and ``int8_bf16_f32w`` (K8's stash under f32 weights); dh
seeded. Each forward row (``FWD_KINDS``: ``k3_bf16``, ``k3_f32``, ``k4``,
``k8``) is one whole forward of the same student on the same rays (the
int8 kinds calibrated as phase 22 does), packed and staged by the module
that runs it.

A variant is a copy of ``kernels/csrc`` with a few source edits
(``VARIANTS``), built with the repository's nvcc flags and swapped in for
K5's wide library (K5 rows) or the forward's (forward rows), timed against
the build in turns base / variant / variant / base
(``_harness.in_turns``), timing only:

* ``noepi``: the skeleton's passes without their epilogue (no mask, no
  dh, no bias, no side tensor, no staging tile, no TMA store; the
  accumulators summed into a test that never stores, so the products
  stay);
* ``nomma``: without the products as well (the loads and the barriers
  alone).

K5's dW pass, the forward's encoding and tail run as built in both, so
base minus variant is the passes' share.

``--parent TREE`` times instead this checkout's wide forms against a
parent checkout's (unpacked with ``git archive``), the parent's imported
from the tree as a package of its own, its images and libraries its own:
each K5 row's dh, dW and db held to the parent's (f32 within K5's f32
limit, the other kinds within K5's bf16 limits), each forward row's rgb
and stash (K3 f32 within ``TOL_TRAIN_F32`` on rgb and every stash row, K3
bf16 within ``TOL_TRAIN_BF16`` relative to a row's largest, K4 and K8 bit
for bit), each record saying whether they were bit for bit, then timed in
turns this checkout / parent / parent / this checkout.

    python -m r2l_tpu_torch.exp.train_wide_variants [--variants noepi,...] \\
        [--out PATH]
    python -m r2l_tpu_torch.exp.train_wide_variants --parent PARENT \\
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

LIB = "r2l_wide_bwd"
FWD_LIB = "r2l_wide_train"
VARIANTS = {
    "noepi": ([(HEADER, EPILOGUE, SINK)], False),
    "nomma": ([(HEADER, EPILOGUE, "  fence_regs(d);"),
               (HEADER, MMA_SS, ""), (HEADER, MMA_TF32, "")], False),
}
KINDS = ("bf16", "f32", "int8", "int8_bf16", "int8_bf16_f32w")
FWD_KINDS = ("k3_bf16", "k3_f32", "k4", "k8")
GROUP = 4    # blocks a call, as the training step walks them
REPS = 3


def _student(dev):
    """Phase 22's W512/D88 student (bf16 config), a step's points and its
    int8 calibration points."""
    import chip_smoke as cs
    from ..models import R2LConfig, init_r2l
    from ..sampler import PointSampler
    from ..train import fused_int8_calib_points
    cfg = R2LConfig(netdepth=cs.WIDE_TRAIN_DEPTH, netwidth=cs.WIDE,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(cs.SEED), dev)
    sampler = PointSampler(H=cs.H, W=cs.W, focal=cs.FOCAL,
                           n_sample=cs.N_SAMPLE, near=2.0, far=6.0)
    calib = fused_int8_calib_points(cs.H, cs.W, cs.FOCAL, cs.N_SAMPLE, 2.0,
                                    6.0, cs.lego_poses(cs.K), dev)
    return cfg, model, cs.train_points(cfg, sampler, dev), calib


def _inputs(kind: str, cfg, model, pts, calib):
    """(body_w, stash, scale) of a stash kind, the stash from the wide
    forward as phase 22 makes it."""
    import chip_smoke as cs
    from ..kernels import r2l_fused as F
    from ..kernels import r2l_train as T
    dp, L = cs.N_SAMPLE * 3, cs.EMBED_L
    f32w = kind in ("f32", "int8_bf16_f32w")
    wd = torch.float32 if f32w else torch.bfloat16
    body_w = F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd,
                                       pad=False).body_w
    if kind in ("bf16", "f32"):
        fp = T.prepare_train_params(model, cfg, dp, L, wd)
        return body_w, T.train_fwd(fp, cfg, pts, dp, L)[1], None
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, dp, L, calib,
                                  fold_requant=False, stage=False, pad=False)
    q = kind == "int8"
    fpq = F.stage_int8_train(fp8, cfg, dp, L, q)
    stash = T.train_fwd_int8(fpq, cfg, pts, dp, L, stash_q=q)[1]
    return body_w, stash, (1.0 / fp8.body_inv if q else None)


def _row(tr, cfg, body_w, stash, scale, dh):
    """``run()``: the top 4-block call through the module ``tr``
    (``kernels.r2l_train`` of a checkout) on that module's own image."""
    nb = cfg.num_blocks
    img = tr.stage_bwd_weights(body_w)

    def run():
        return tr.bwd_group(body_w, stash, dh, cfg, nb - GROUP, GROUP,
                            body_scale=scale, staged=img)
    return run


def _each_kind(dev, fn) -> None:
    """fn(kind, cfg, body_w, stash, scale, dh, ops) for every stash kind,
    one kind's inputs on the card at a time."""
    import chip_smoke as cs
    cfg, model, pts, calib = _student(dev)
    n, W = pts.shape[0], cfg.netwidth
    dh = torch.randn((n, W), generator=torch.Generator(dev).manual_seed(
        cs.SEED + 2), device=dev)   # phase 22's
    ops = 4.0 * n * W * W * 2 * GROUP
    for kind in KINDS:
        body_w, stash, scale = _inputs(kind, cfg, model, pts, calib)
        fn(kind, cfg, body_w, stash, scale, dh, ops)
        del body_w, stash, scale
        torch.cuda.empty_cache()


def _fwd_row(tr, kind: str, cfg, model, pts, calib):
    """``run()``: one whole wide forward of ``kind`` through the module
    ``tr`` (``kernels.r2l_train`` of a checkout), packed and staged by that
    checkout's own functions (a parent without ``prepare_train_params``
    packs K3 as its step did, ``prepare_fused_params_pe``)."""
    import chip_smoke as cs
    F = importlib.import_module(tr.__name__.rsplit(".", 1)[0] + ".r2l_fused")
    dp, L = cs.N_SAMPLE * 3, cs.EMBED_L
    if kind.startswith("k3"):
        wd = torch.float32 if kind == "k3_f32" else torch.bfloat16
        fp = (tr.prepare_train_params(model, cfg, dp, L, wd)
              if hasattr(tr, "prepare_train_params") else
              F.prepare_fused_params_pe(model, cfg, dp, L, weight_dtype=wd,
                                        pad=False))
        return lambda: tr.train_fwd(fp, cfg, pts, dp, L)
    q = kind == "k4"
    fp8 = F.calibrate_r2l_int8_pe(model, cfg, dp, L, calib,
                                  fold_requant=False, stage=False, pad=False)
    fpq = F.stage_int8_train(fp8, cfg, dp, L, q)
    return lambda: tr.train_fwd_int8(fpq, cfg, pts, dp, L, stash_q=q)


def _fwd_ops(kind: str, cfg, n: int) -> tuple[float, str]:
    """A forward's operations, times three for f32 (3xTF32), and the peak
    that bounds them."""
    from ._harness import chain_ops
    ops = chain_ops(cfg, n, cfg.input_dim)
    return {"k3_bf16": (ops, "bf16"), "k3_f32": (3 * ops, "tf32")}.get(
        kind, (ops, "int8"))


def _each_fwd(dev, fn) -> None:
    """fn(kind, cfg, model, pts, calib, bound_ms) for every forward kind."""
    cfg, model, pts, calib = _student(dev)
    for kind in FWD_KINDS:
        ops, peak = _fwd_ops(kind, cfg, pts.shape[0])
        fn(kind, cfg, model, pts, calib, _harness.bound_ms(ops, peak))
        torch.cuda.empty_cache()


def _fwd_same(kind: str, got, want) -> dict:
    """A forward row's two outputs (rgb, stash) held to each other: their
    distance (K3 f32 max-abs, rgb and the worst stash row; K3 bf16 relative
    to a row's largest) and whether bit for bit; AssertionError past the
    kind's limit (K4, K8: bit for bit)."""
    import chip_smoke as cs
    same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(got, want))
    diff = float((got[0] - want[0]).abs().max())
    for a, b in zip(got[1], want[1]):   # a row at a time: the stash is large
        d = (a.float() - b.float()).abs().max()
        if kind == "k3_bf16":
            d = d / b.float().abs().max().clamp(min=1)
        diff = max(diff, float(d))
    lim = {"k3_f32": cs.TOL_TRAIN_F32, "k3_bf16": cs.TOL_TRAIN_BF16}.get(
        kind, 0.0)
    if not (same or diff <= lim):
        raise AssertionError(f"{kind}: this checkout and the other build "
                             f"differ by {diff:.3e}")
    return {"max_diff": diff, "bit_for_bit": same}


def _peak(kind: str, ops: float) -> float:
    f32 = kind in ("f32", "int8_bf16_f32w")
    return _harness.bound_ms(3 * ops if f32 else ops,
                             "tf32" if f32 else "bf16")


def time_variants(names, log, reps: int = REPS) -> None:
    """Each variant against this checkout's build on every stash kind, in
    turns."""
    from ..kernels import _build
    from ..kernels import r2l_train as T
    dev = _harness.require_cuda("train_wide_variants")
    log(_harness.device_record())
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {n: (VARIANTS[n][0], LIB) for n in names}
        jobs.update({f"{n}_fwd": (VARIANTS[n][0], FWD_LIB) for n in names})
        libs = _harness.build_variants(jobs, Path(tmp))
        _build.load(LIB)
        _build.load(FWD_LIB)

        def fwd(kind, cfg, model, pts, calib, bound):
            run = _fwd_row(T, kind, cfg, model, pts, calib)
            for name in names:
                base_ms, variant_ms, _ = _harness.in_turns(
                    run, run,
                    lambda lib=libs[f"{name}_fwd"][0]: _harness.loading(lib),
                    reps)
                log({"name": f"{name}_{kind}", "base_ms": base_ms,
                     "variant_ms": variant_ms, "bound_ms": bound,
                     "build": libs[f"{name}_fwd"][1][:12]})
        _each_fwd(dev, fwd)

        def one(kind, cfg, body_w, stash, scale, dh, ops):
            run = _row(T, cfg, body_w, stash, scale, dh)
            for name in names:
                base_ms, variant_ms, _ = _harness.in_turns(
                    run, run, lambda lib=libs[name][0]: _harness.loading(lib),
                    reps)
                log({"name": f"{name}_{kind}", "base_ms": base_ms,
                     "variant_ms": variant_ms, "bound_ms": _peak(kind, ops),
                     "build": libs[name][1][:12]})
        _each_kind(dev, one)


def compare_parent(tree: str, log, reps: int = REPS) -> None:
    """Every stash kind in this checkout and in the parent's: dh, dW and db
    held to each other (f32 weights within ``TOL_GRAD_F32``, the others
    within K5's bf16 limits; whether bit for bit recorded), then timed in
    turns."""
    import chip_smoke as cs
    from ..kernels import r2l_train as T
    dev = _harness.require_cuda("train_wide_variants")
    log(_harness.device_record())
    PT = importlib.import_module(parent_package(tree).__name__
                                 + ".kernels.r2l_train")

    def fwd(kind, cfg, model, pts, calib, bound):
        new = _fwd_row(T, kind, cfg, model, pts, calib)
        old = _fwd_row(PT, kind, cfg, model, pts, calib)
        rec = _fwd_same(kind, new(), old())
        torch.cuda.empty_cache()
        base_ms, parent_ms, _ = _harness.in_turns(
            new, old, contextlib.nullcontext, reps)
        log({"name": f"parent_{kind}", "base_ms": base_ms,
             "parent_ms": parent_ms, **rec, "bound_ms": bound,
             "registers": _harness.registers(FWD_LIB)})
    _each_fwd(dev, fwd)

    def one(kind, cfg, body_w, stash, scale, dh, ops):
        new = _row(T, cfg, body_w, stash, scale, dh)
        old = _row(PT, cfg, body_w, stash, scale, dh)
        got, want = new(), old()
        f32 = body_w.dtype == torch.float32
        errs = [cs.grad_err(g, w) for g, w in zip(got, want)]
        same = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        rel, bad = max(e[0] for e in errs), max(e[1] for e in errs)
        if rel > (cs.TOL_GRAD_F32 if f32 else cs.TOL_GRAD_BF16) or (
                not f32 and bad > cs.MAX_BAD_BF16):
            raise AssertionError(f"K5 wide {kind}: this checkout and the "
                                 f"parent differ by {rel:.3e} "
                                 f"(share off {bad:.2e})")
        del got, want
        base_ms, parent_ms, _ = _harness.in_turns(
            new, old, contextlib.nullcontext, reps)
        log({"name": f"parent_{kind}", "base_ms": base_ms,
             "parent_ms": parent_ms, "norm_rel_diff": rel,
             "bit_for_bit": dict(zip(("dh", "dW", "db"), same)),
             "bound_ms": _peak(kind, ops), "registers":
                 _harness.registers(LIB)})
    _each_kind(dev, one)


def main(argv=None) -> None:
    _harness.variants_main("train_wide_variants", __doc__, VARIANTS,
                           time_variants, argv, compare_parent)


if __name__ == "__main__":
    main()
