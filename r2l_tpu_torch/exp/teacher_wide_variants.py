"""The teacher's wide form (``kernels/csrc/nerf_wide.cu`` on the pass
skeleton ``kernels/csrc/wide_hopper.cuh``, f32, bf16 and int8), measured
on the card: what sets its pace, and this checkout's build against a
parent's.

Each row is one chunk of ``chip_smoke.py``'s phase 23: the first
32,768-ray chunk of a datagen pose, its coarse pass (S=64) and its fine
pass (S=192), one wide call each, on a W512/D8 or W1024/D8 teacher (skip
4, viewdirs, L=10/4, seeded weights with the density floor), f32, bf16
and int8 (calibrated on datagen's set as phase 23 does, the requantize
folded, ``int8``, and unfolded, ``int8_unfolded``).

A variant is a copy of ``kernels/csrc`` with a few source edits
(``VARIANTS``), built with the repository's nvcc flags and swapped in for
the wide form's library, timed against the build in turns base / variant /
variant / base (``_harness.in_turns``):

* ``c1``: one-block clusters, each block loading all of B's stages itself
  (the build's two-block clusters share them: each loads half a stage into
  both), held to the build's outputs bit for bit;
* ``s4``: bf16 on four ring slots in place of three, its epilogue's
  staging tile halved to make room (two rounds of stores a tile); ``s3``:
  f32 on three slots and one round (the build's are four and two); the
  rows of the other type run the build's kernel (the spread of the turns);
  each held to the build's outputs bit for bit;
* ``noepi``: the layer passes without their epilogue (no bias, no staging
  tile, no TMA store; the accumulators summed into a test that never
  stores, so the products stay), timing only;
* ``nomma``: without the products as well (the loads and the barriers
  alone; the compiler drops what only fed the products), timing only.

``--parent TREE`` times instead this checkout's wide form against a
parent checkout's (unpacked with ``git archive``), the parent's imported
from the tree as a package of its own so that it stages its own image and
builds its own library: each row's outputs held to each other within K6's
limits (``chip_smoke.TOL_TEACHER``, the two sum orders differ; int8 bit for
bit: its sums are exact), then timed in turns this checkout / parent /
parent / this checkout.

    python -m r2l_tpu_torch.exp.teacher_wide_variants [--variants noepi,...] \\
        [--out PATH]
    python -m r2l_tpu_torch.exp.teacher_wide_variants --parent PARENT \\
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import sys
import tempfile
from pathlib import Path

import torch

from . import _harness

HEADER = "wide_hopper.cuh"
EPILOGUE = ("  epilogue<T, Epi, NN>(d, out, side_out, e, p, smem, base, stg, w, wg,"
            " wtid);")
MMA_SS = """      if constexpr (std::is_same<T, int8_t>::value)
        Wgmma<NN>::s8(d, desc_k128(sa + 32 * j), desc_k128(sb + 32 * j),
                      kt > 0 || j > 0);
      else
        Wgmma<NN>::bf16(d, desc_k128(sa + 32 * j), desc_k128(sb + 32 * j),
                        kt > 0 || j > 0);"""
MMA_TF32 = """    Wgmma<N>::tf32(d, h[j], desc_k128(bl + 32 * j), acc || j > j0);
    Wgmma<N>::tf32(d, l[j], desc_k128(bh + 32 * j), 1);
    Wgmma<N>::tf32(d, h[j], desc_k128(bh + 32 * j), 1);"""
SINK = """  float s = 0.f;  // the accumulators, used: the products stay
  for (int i = 0; i < NN / 2; ++i) s += d[i];
  if (s == 1.2345e-38f) stg[wtid] = 1;"""
CLUSTER = "constexpr int kC = 2;"
BF16_RING = "kStages = 3, kRounds = 1;"
F32_RING = "kStages = 4, kRounds = 2;"
# name -> (the edits of kernels/csrc (file, text, replacement), whether
# its outputs are held to the build's)
VARIANTS = {
    "c1": ([(HEADER, CLUSTER, CLUSTER.replace("2", "1"))], True),
    "s4": ([(HEADER, BF16_RING, F32_RING)], True),
    "s3": ([(HEADER, F32_RING, BF16_RING)], True),
    "noepi": ([(HEADER, EPILOGUE, SINK)], False),
    "nomma": ([(HEADER, EPILOGUE, "  fence_regs(d);"),
               (HEADER, MMA_SS, ""), (HEADER, MMA_TF32, "")], False),
}
ROWS = (("W512/D8", 512), ("W1024/D8", 1024))
KINDS = ("f32", "bf16", "int8", "int8_unfolded")
REPS = 3


def _chunk(dev):
    """phase 23's chunk (rays_o, rays_d, coarse z, fine z), its volumetric
    config and datagen's int8 calibration set."""
    import chip_smoke as cs
    from ..datagen import int8_calibration_set
    vcfg = cs.teacher_vcfg()
    calib = tuple(torch.from_numpy(a).to(dev) for a in int8_calibration_set(
        cs.datagen_cfg("int8", 1), vcfg))
    return cs.frame_chunks(vcfg, dev)[0][0], vcfg, calib


def _peak(kind: str) -> str:
    """The data-sheet peak that bounds a kind's products."""
    return {"f32": "tf32", "bf16": "bf16"}.get(kind, "int8")


def _row(nr, label: str, W: int, kind: str, chunk, vcfg, calib, dev):
    """(run, ops): ``run()`` renders the chunk's two passes through the
    module ``nr`` (``kernels.nerf_render`` of a checkout) on the row's
    teacher, packed by that module (int8 calibrated on ``calib``); ``ops``
    the chunk's operations."""
    import chip_smoke as cs
    int8 = kind.startswith("int8")
    cfg, mc, _ = cs.wide_teacher_models("int8" if int8 else kind, W, 8, (4,),
                                        dev)
    fp = nr.prepare_fused_nerf(mc, cfg, vcfg.multires, vcfg.multires_views,
                               calib=calib if int8 else None,
                               weight_dtype=cfg.compute_dtype,
                               fold_requant=kind == "int8")
    kw = dict(L_pts=vcfg.multires, L_views=vcfg.multires_views,
              white_bkgd=True)
    o, d, zc, zf = chunk

    def run():
        return [nr.fused_nerf_render(fp, cfg, o, d, z, **kw)
                for z in (zc, zf)]
    n, S = o.shape[0], zc.shape[1] + zf.shape[1]
    return run, 2.0 * n * S * cs.point_macs(cfg)


def time_variants(names, log, reps: int = REPS) -> None:
    """Each variant against this checkout's build on every row, in
    turns."""
    from ..kernels import _build
    from ..kernels import nerf_render as NR
    dev = _harness.require_cuda("teacher_wide_variants")
    log(_harness.device_record())
    chunk, vcfg, calib = _chunk(dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _harness.build_variants(
            {n: (VARIANTS[n][0], "nerf_wide") for n in names}, Path(tmp))
        _build.load("nerf_wide")
        for label, W in ROWS:
            for kind in KINDS:
                run, ops = _row(NR, label, W, kind, chunk, vcfg, calib, dev)
                want = run()
                for name in names:
                    base_ms, variant_ms, got = _harness.in_turns(
                        run, run,
                        lambda lib=libs[name][0]: _harness.loading(lib),
                        reps)
                    same = None
                    if VARIANTS[name][1]:
                        same = all(torch.equal(a, b) for g, w in
                                   zip(got, want) for a, b in zip(g, w))
                        if not same:
                            raise AssertionError(f"{name} {label} {kind}: "
                                                 "not the build's outputs")
                    log({"name": f"{name}_{label}_{kind}",
                         "base_ms": base_ms, "variant_ms": variant_ms,
                         "bit_for_bit": same,
                         "bound_ms": _harness.bound_ms(
                             3 * ops if kind == "f32" else ops, _peak(kind)),
                         "build": libs[name][1][:12]})
                del run, want
                torch.cuda.empty_cache()


def parent_package(tree: str, name: str = "parent_r2l_tpu_torch"):
    """The checkout ``tree``'s ``r2l_tpu_torch`` imported as the package
    ``name`` (its modules import one another relatively, so they stay the
    tree's own; its kernels build from the tree's sources into the tree's
    build directory)."""
    if name in sys.modules:
        return sys.modules[name]
    root = Path(tree).resolve() / "r2l_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, root / "__init__.py", submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def compare_parent(tree: str, log, reps: int = REPS) -> None:
    """Every row in this checkout and in the parent's: the outputs held to
    each other within ``chip_smoke.TOL_TEACHER`` of the kind (max-abs and
    RMS, depth its own; int8 bit for bit), then timed in turns."""
    import chip_smoke as cs
    from ..kernels import nerf_render as NR
    dev = _harness.require_cuda("teacher_wide_variants")
    log(_harness.device_record())
    PNR = importlib.import_module(
        parent_package(tree).__name__ + ".kernels.nerf_render")
    chunk, vcfg, calib = _chunk(dev)
    for label, W in ROWS:
        for kind in KINDS:
            new, ops = _row(NR, label, W, kind, chunk, vcfg, calib, dev)
            old, _ = _row(PNR, label, W, kind, chunk, vcfg, calib, dev)
            int8 = kind.startswith("int8")
            (tol, tol_rms), (tol_d, tol_d_rms) = cs.TOL_TEACHER[
                "int8" if int8 else kind]
            if int8:   # exact sums: the builds agree bit for bit
                tol = tol_rms = tol_d = tol_d_rms = 0.0
            worst = {}
            for got, want in zip(new(), old()):
                for what, g, w in zip(("rgb", "acc", "depth", "weights"),
                                      got, want):
                    mx, rms = cs.deltas(g, w)
                    lim = ((tol_d, tol_d_rms) if what == "depth"
                           else (tol, tol_rms))
                    if mx > lim[0] or rms > lim[1]:
                        raise AssertionError(
                            f"{label} {kind} {what}: this checkout and the "
                            f"parent differ by {mx:.3e} (RMS {rms:.3e})")
                    worst[what] = max(worst.get(what, 0.0), mx)
            base_ms, parent_ms, _ = _harness.in_turns(
                new, old, contextlib.nullcontext, reps)
            log({"name": f"parent_{label}_{kind}", "base_ms": base_ms,
                 "parent_ms": parent_ms, "max_abs_diff": worst,
                 "bound_ms": _harness.bound_ms(
                     3 * ops if kind == "f32" else ops, _peak(kind)),
                 "registers": _harness.registers("nerf_wide")})
            del new, old
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    _harness.variants_main("teacher_wide_variants", __doc__, VARIANTS,
                           time_variants, argv, compare_parent)


if __name__ == "__main__":
    main()
