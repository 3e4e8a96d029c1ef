#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's student frame path on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), refuse without CUDA.
2. Build: compile both CUDA kernels from ``r2l_tpu_torch/kernels/csrc`` into
   ``build/`` and print the build time and the compiler's register report.
3. Kernel vs plain version on the card, at the main path's shape (one
   400x400 lego frame of the canonical W256/D88 student, random weights from
   a seeded generator): K1 with f32 and with bf16 weights, K2 (int8), each
   against its plain PyTorch version, then K2 on the frozen int8 canary
   (``tests/fixtures/int8_epilogue_canary*.npz``). Times each kernel and its
   plain version with CUDA events.
4. Main path: ``make_r2l_frame_fn`` and ``make_r2l_bench_fn`` at 400x400 for
   the kinds ``jnp`` (plain module, bf16), ``pe`` and ``int8``; K frames per
   kind, ms/frame from CUDA events, PSNR of each kernel kind's frames against
   the ``jnp`` frames, and the kernels' launch counts in that run.

Prints a JSON line of details (build time, main-path times), a JSON line of
per-kernel results (``{"kernels": [...]}``), the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

H = W = 400
FOCAL = 555.5555155968841  # lego: .5*800/tan(.5*camera_angle_x) at half res
N_SAMPLE, EMBED_L = 16, 10
K = 16                     # frames per kind on the main path
SEED = 0

# Kernel vs its plain version on the same inputs, on the card:
# K1 f32: both compute in f32 and differ only in summation order across
#   88 layers.
TOL_PE_F32 = 1e-4
# K1 bf16: a one-ulp difference in a dot can flip a bf16 rounding of an
#   activation, which then propagates (the bound of
#   tests/test_pallas_pe.py:50).
TOL_PE_BF16 = 3e-2
# K2: int8 x int8 -> int32 is exact and the epilogue rounds step by step as
#   the plain version does, so most outputs agree bit for bit; a flipped
#   requantize moves a few outputs (tests/test_pallas_int8_pe.py:45-46).
TOL_INT8_MAX, TOL_INT8_RMS = 2.5e-2, 2.5e-3
# K2 on the canary against the JAX reference's frozen output: the reference
#   contracts acc*m+b and the ladder's 1-2s*s into FMAs where the port
#   rounds each step (ROADMAP C), one f32 ulp on the CPU; on the card
#   CUDA's sinf/cosf/expf differ from XLA's by ulps as well.
TOL_CANARY = 1e-6
# Frames of a kernel kind against the plain jnp frames (PSNR, dB).
MIN_PSNR = {"pe": 40.0, "int8": 35.0}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 3) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def deltas(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad output: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    d = (got.double() - want.double())
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def check(name: str, max_abs: float, rms: float, tol_max: float,
          tol_rms: float | None = None) -> None:
    ok = max_abs <= tol_max and (tol_rms is None or rms <= tol_rms)
    print(f"[check] {name}: max_abs {max_abs:.3e} (tol {tol_max:.1e}) "
          f"rms {rms:.3e}"
          + (f" (tol {tol_rms:.1e})" if tol_rms is not None else "")
          + (" ok" if ok else " FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")


def lego_poses(k: int) -> np.ndarray:
    from r2l_tpu_torch.rays import pose_spherical
    return np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                     for t in np.linspace(-180, 180, k, endpoint=False)])


def phase_kernels(model, cfg, sampler, poses, dev) -> dict:
    """Each kernel against its plain version at one frame's rays."""
    from r2l_tpu_torch.evaluate import _calibration_points
    from r2l_tpu_torch.kernels import r2l_fused as F
    dim_pts = cfg.input_dim // (2 * EMBED_L + 1)
    pts = sampler.sample_test(torch.as_tensor(poses[3], device=dev))
    calib = _calibration_points(sampler, poses, dev)
    cases = (
        ("pe_f32", "K1 f32", (TOL_PE_F32, None), F.fused_r2l_apply_pe,
         F.fused_r2l_apply_pe_ref, F.prepare_fused_params_pe(
             model, cfg, dim_pts, EMBED_L, weight_dtype=torch.float32)),
        ("pe", "K1 bf16", (TOL_PE_BF16, None), F.fused_r2l_apply_pe,
         F.fused_r2l_apply_pe_ref, F.prepare_fused_params_pe(
             model, cfg, dim_pts, EMBED_L, weight_dtype=torch.bfloat16)),
        ("int8", "K2", (TOL_INT8_MAX, TOL_INT8_RMS),
         F.fused_r2l_apply_int8_pe, F.fused_r2l_apply_int8_pe_ref,
         F.calibrate_r2l_int8_pe(model, cfg, dim_pts, EMBED_L, calib)),
    )
    out = {}
    for key, label, tols, kernel, plain, fp in cases:
        got = kernel(fp, cfg, pts, dim_pts, EMBED_L)
        want = plain(fp, cfg, pts, dim_pts, EMBED_L)
        mx, rms = deltas(got, want)
        check(f"{label} vs plain", mx, rms, *tols)
        print(f"[check] {label} vs plain: {int((got != want).sum())} of "
              f"{got.numel()} outputs differ", flush=True)
        out[key] = {
            "max_abs_err": mx,
            "ms": time_ms(lambda: kernel(fp, cfg, pts, dim_pts, EMBED_L)),
            "plain_ms": time_ms(lambda: plain(fp, cfg, pts, dim_pts,
                                              EMBED_L))}
        print(f"[time] {label}: kernel {out[key]['ms']:.3f} ms, plain "
              f"{out[key]['plain_ms']:.3f} ms at {pts.shape[0]} rays",
              flush=True)
    return out


def phase_canary(dev) -> float:
    """K2 on the frozen int8 epilogue canary (the JAX reference's output of
    ``tools/gen_int8_epilogue_canary.py::build_case``)."""
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.models import R2L, R2LConfig, params_from_jax
    fx = REPO / "tests" / "fixtures"
    case = np.load(fx / "int8_epilogue_canary_case.npz")
    want = torch.from_numpy(np.load(fx / "int8_epilogue_canary.npz")["rgb"])
    cfg = R2LConfig(input_dim=6 * (2 * 4 + 1), netdepth=8, netwidth=64)
    model = R2L(cfg)
    model.load_state_dict(params_from_jax(
        {k: {"w": case[f"{k}_w"], "b": case[f"{k}_b"]}
         for k in ("head", "body", "tail")}, cfg))
    model.to(dev)
    calib = torch.from_numpy(case["calib"]).to(dev)
    pts = torch.from_numpy(case["pts"]).to(dev)
    fp = F.calibrate_r2l_int8_pe(model, cfg, 6, 4, calib)
    got = F.fused_r2l_apply_int8_pe(fp, cfg, pts, 6, 4)
    plain = F.fused_r2l_apply_int8_pe_ref(fp, cfg, pts, 6, 4)
    check("K2 canary vs plain on the card", *deltas(got, plain), TOL_CANARY)
    mx, rms = deltas(got.cpu(), want)
    check("K2 canary vs the JAX fixture", mx, rms, TOL_CANARY)
    return mx


def phase_main_path(model, cfg, sampler, poses, dev) -> dict:
    """The port's entry points for the three kinds, as a user calls them."""
    from r2l_tpu_torch.evaluate import make_r2l_bench_fn, make_r2l_frame_fn
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.metrics import psnr
    kinds = (("jnp", False, ""), ("pe", True, ""), ("int8", True, "int8"))
    F.fused_r2l_apply_pe.launches = 0
    F.fused_r2l_apply_int8_pe.launches = 0
    frames, res = {}, {}
    for kind, use_pallas, quantize in kinds:
        kw = dict(embed_L=EMBED_L, use_pallas=use_pallas, quantize=quantize,
                  calib_poses=poses)
        frame_fn = make_r2l_frame_fn(model, cfg, sampler, **kw)
        bench_fn = make_r2l_bench_fn(model, cfg, sampler, **kw)
        if frame_fn.kind != kind or bench_fn.kind != kind:
            raise AssertionError(f"asked for {kind}, got {frame_fn.kind}")
        frames[kind] = torch.stack([frame_fn(p) for p in poses])
        f = frames[kind]
        if f.shape != (K, H, W, 3) or not torch.isfinite(f).all() \
                or f.min() < 0 or f.max() > 1:
            raise AssertionError(f"{kind}: bad frames {tuple(f.shape)}")
        checksum = float(bench_fn(poses))
        if abs(checksum - float(f.double().sum())) > 1e-4 * abs(checksum):
            raise AssertionError(f"{kind}: bench checksum {checksum} != "
                                 f"frame sum {float(f.double().sum())}")
        ms = time_ms(lambda: bench_fn(poses), reps=2) / K
        res[kind] = {"ms_per_frame": ms, "fps": 1000.0 / ms}
        if kind != "jnp":
            res[kind]["psnr_vs_jnp"] = float(psnr(f, frames["jnp"]))
        print(f"[main] {kind}: {ms:.3f} ms/frame, {1000.0 / ms:.2f} FPS"
              + (f", PSNR vs jnp {res[kind]['psnr_vs_jnp']:.2f} dB"
                 if kind != "jnp" else ""), flush=True)
    torch.cuda.synchronize()
    res["launches"] = {"pe": F.fused_r2l_apply_pe.launches,
                       "int8": F.fused_r2l_apply_int8_pe.launches}
    print(f"[main] kernel launches in the main path: {res['launches']}",
          flush=True)
    for kind in ("pe", "int8"):
        if res["launches"][kind] <= 0:
            raise AssertionError(f"the main path never launched {kind}")
        if res[kind]["psnr_vs_jnp"] < MIN_PSNR[kind]:
            raise AssertionError(f"{kind} frames {res[kind]['psnr_vs_jnp']} "
                                 f"dB from jnp, below {MIN_PSNR[kind]}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "r2l_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no r2l_tpu_torch package beside {__file__}; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from r2l_tpu_torch.kernels import _build
    from r2l_tpu_torch.models import R2LConfig, init_r2l
    from r2l_tpu_torch.sampler import PointSampler

    # Full f32 for every plain f32 matmul (PyTorch's default, stated).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    t0 = time.time()
    seconds = _build.build()
    build_s = time.time() - t0
    print(f"[build] {build_s:.1f} s ({seconds})", flush=True)
    for kname in _build.KERNELS:
        for line in _build.compiler_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}", flush=True)

    cfg = R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(SEED), dev)
    sampler = PointSampler(H=H, W=W, focal=FOCAL, n_sample=N_SAMPLE,
                           near=2.0, far=6.0)
    poses = lego_poses(K)

    kern = phase_kernels(model, cfg, sampler, poses, dev)
    canary = phase_canary(dev)
    main_res = phase_main_path(model, cfg, sampler, poses, dev)

    print(json.dumps({"details": {
        "device": smi, "frame": f"{H}x{W}",
        "model": "R2L W256 D88, 16 samples, L=10", "build_s": build_s,
        "pe_f32": kern["pe_f32"], "canary_max_abs_err": canary,
        "main_path": {k: v for k, v in main_res.items()
                      if k != "launches"}}}))
    src = "r2l_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": "fused_r2l_apply_pe", "route": "cuda",
         "source": src + "r2l_pe_fused.cu",
         "replaces": "r2l_tpu/kernels/r2l_pallas.py:164",
         "launches": main_res["launches"]["pe"], **kern["pe"]},
        {"name": "fused_r2l_apply_int8_pe", "route": "cuda",
         "source": src + "r2l_int8_pe_fused.cu",
         "replaces": "r2l_tpu/kernels/r2l_pallas.py:571",
         "launches": main_res["launches"]["int8"], **kern["int8"]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
