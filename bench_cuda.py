#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: lego-class 400x400
full-frame R2L render throughput on one NVIDIA GPU.

The port's counterpart of ``bench.py``, with its canonical student (R2L
W256/D88, 16 samples a ray, L=10; random weights from seed 0), lego's
400x400 frame at focal 555.555, K=16 poses at elevation -30 degrees and
radius 4, and its first path: static-scale int8 (kind ``int8``, the K2
kernel), calibrated on those poses. Run from the root of a checkout:

    python3 bench_cuda.py

Timing: ``make_r2l_bench_fn`` renders the K frames one after another with no
host synchronisation; one warm-up call, then the least of 4 calls, each
between two CUDA events. Prints ONE JSON line with ``bench.py``'s keys.
There is no fall-through to another path: if K2 fails to build, launch or
be chosen, the run fails. Without a card it exits non-zero and prints
nothing on stdout.

``vs_baseline`` divides the frames/s by ``BASELINE_FPS``, the north star of
``BASELINE.json`` (100 FPS on one chip): a target, not a measurement.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_FPS = 100.0  # BASELINE.json's north star: a target

H = W = 400
FOCAL = 555.5555155968841  # lego: .5*800/tan(.5*camera_angle_x) at half res
K = 16                     # frames per timed call
EMBED_L = 10
REPS = 4
PATH = "cuda-int8-pe-fused"
MODEL = "R2L W256 D88 (43 resmlp blocks), 16 samples/ray, L=10"


def lego_poses(k: int) -> np.ndarray:
    from r2l_tpu_torch.rays import pose_spherical
    return np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                     for t in np.linspace(-180, 180, k, endpoint=False)])


def bench(device: torch.device | str = torch.device("cuda"), h: int = H,
          w: int = W, focal: float = FOCAL, k: int = K, reps: int = REPS,
          netdepth: int = 88, netwidth: int = 256) -> dict:
    """Time the int8 frame path on ``device``: {ms_per_frame, checksum,
    launches (K2's, in the timed calls), kind}. On the card the calls are
    timed by CUDA events; elsewhere (the tests' small CPU runs) by the
    host's clock around a readback."""
    from r2l_tpu_torch.evaluate import make_r2l_bench_fn
    from r2l_tpu_torch.kernels import r2l_fused as F
    from r2l_tpu_torch.models import R2LConfig, init_r2l
    from r2l_tpu_torch.sampler import PointSampler
    device = torch.device(device)
    cfg = R2LConfig(netdepth=netdepth, netwidth=netwidth,
                    compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, torch.Generator().manual_seed(0), device)
    sampler = PointSampler(H=h, W=w, focal=focal, n_sample=16, near=2.0,
                           far=6.0)
    poses = lego_poses(k)
    fn = make_r2l_bench_fn(model, cfg, sampler, embed_L=EMBED_L,
                           use_pallas=True, quantize="int8",
                           calib_poses=poses)
    if fn.kind != "int8":
        raise RuntimeError(f"the int8 path was not chosen: kind {fn.kind}")
    poses_t = torch.as_tensor(poses, dtype=torch.float32, device=device)
    checksum = float(fn(poses_t))                      # warm-up
    F.fused_r2l_apply_int8_pe.launches = 0
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(poses_t)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = float(fn(poses_t))
            times.append(1000.0 * (time.perf_counter() - t0))
        if float(out) != checksum:
            raise RuntimeError(f"checksum moved between calls: {float(out)}"
                               f" != {checksum}")
    launches = F.fused_r2l_apply_int8_pe.launches
    if device.type == "cuda" and launches != reps * k:
        raise RuntimeError(f"K2 launched {launches} times in {reps} calls of "
                           f"{k} frames")
    return {"ms_per_frame": min(times) / k, "checksum": checksum,
            "launches": launches, "kind": fn.kind}


def record(ms_per_frame: float, device_line: str, h: int = H, w: int = W,
           k: int = K) -> dict:
    """``bench.py``'s JSON record for a measured ms/frame."""
    fps = 1000.0 / ms_per_frame
    return {
        "metric": f"lego_{h}x{w}_render_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "extra": {
            "rays_per_sec_per_chip": round(fps * h * w, 1),
            "ms_per_frame": round(ms_per_frame, 3),
            "device": device_line,
            "path": PATH,
            "model": MODEL,
            "protocol": f"{k} frames per call, no host sync between frames; "
                        f"CUDA events, min of {REPS} calls after a warm-up",
        },
    }


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_cuda: torch.cuda.is_available() is false; this "
              "benchmark needs an NVIDIA GPU", file=sys.stderr)
        return 1
    r = bench(torch.device("cuda", 0))
    print(json.dumps(record(r["ms_per_frame"], nvidia_smi())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
