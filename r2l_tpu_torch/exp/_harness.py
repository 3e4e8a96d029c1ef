"""The probes' shared protocols (the ports of ``exp/probe_mxu.py``'s
``time_variant`` and ``log``, and of the frame loops of
``exp/probe_pipe.py``'s ``bench`` and ``exp/probe_epi.py``'s ``main``).

A body variant is timed as K_REPS frames back to back, each on an input
varied per frame (``rep_scales``, as JAX scales the input by ``linspace(1,
1.0001, 8)``), their scalar checksums summed; one call warms up (and builds
the kernel), then the min of 3 calls timed with CUDA events, divided by
K_REPS. A frame variant (``time_frames``) renders K lego frames per call,
each ``sample_test`` of a pose then the variant and the frame's sum, one
call to warm up, then the min of N calls. Rates and bounds are held against
the H100's data-sheet peaks (dense, at 700 W), not the TPU's. Records are
JSON lines on stdout and, with an ``out`` path, appended there.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..rays import pose_spherical
from ..sampler import PointSampler

K_REPS = 8
LEGO_HW, LEGO_FOCAL = 400, 555.5555155968841   # the frame drivers' camera
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit (f32:
# 67 T/s is the FMA units'; tf32, the tensor cores' TF32 rate, bounds K6
# f32's 3xTF32 products).
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}


def require_cuda(prog: str) -> torch.device:
    """The card, or exit non-zero: a probe measures only on a GPU."""
    if not torch.cuda.is_available():
        print(f"{prog}: torch.cuda.is_available() is false; the probes "
              "measure only on an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 plain matmuls
    return torch.device("cuda", 0)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def device_record() -> dict:
    return {"name": "device", "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi()}


class Log:
    """Print each record as a JSON line and append it to ``out`` if
    given."""

    def __init__(self, out: str | None = None):
        self.out = out

    def __call__(self, rec: dict) -> dict:
        rec["ts"] = time.time()
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out:
            with open(self.out, "a") as f:
                f.write(line + "\n")
        return rec


def bound_ms(ops: float, kind: str) -> float:
    """The least ms ``ops`` operations take at the data-sheet peak of
    ``kind`` (every probe here is bound by operations, not bytes)."""
    return ops / PEAK_OPS[kind] * 1e3


def chain_ops(cfg, n_rays: int, in_dim: int) -> float:
    """Multiply-adds x 2 of the R2L chain (head, body, tail) for n_rays."""
    W, nbl = cfg.netwidth, cfg.num_blocks * cfg.n_learnable
    return 2.0 * n_rays * (in_dim * W + nbl * W * W + W * cfg.output_dim)


def rep_scales(device) -> torch.Tensor:
    """The per-frame input scales: JAX's ``linspace(1.0, 1.0001, K_REPS)``
    in f32."""
    return torch.linspace(1.0, 1.0001, K_REPS, dtype=torch.float32,
                          device=device)


def time_variant(name: str, rep: Callable[[int], torch.Tensor], log: Log,
                 ops_per_frame: float | None = None, peak: str = "bf16",
                 extra: dict | None = None) -> dict:
    """Time ``rep(i)`` (frame i's scalar checksum) over K_REPS frames:
    ms per frame (min of 3 calls after a warm-up, CUDA events), the
    checksum, and with ``ops_per_frame`` the rate and its share of the
    ``peak`` kind's data-sheet rate."""
    def run() -> torch.Tensor:
        return torch.stack([rep(i) for i in range(K_REPS)]).sum()

    t0 = time.time()
    checksum = float(run())
    warmup_s = time.time() - t0
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = min(times) / K_REPS
    rec = {"name": name, "ms_per_frame": ms, "warmup_s": warmup_s,
           "checksum": checksum}
    if ops_per_frame:
        rec["tflops"] = ops_per_frame / ms / 1e9
        rec[f"mfu_{peak}"] = ops_per_frame / (ms * 1e-3) / PEAK_OPS[peak]
        rec["bound_ms"] = bound_ms(ops_per_frame, peak)
    rec.update(extra or {})
    return log(rec)


def time_frames(key: str, name: str, net: Callable[[torch.Tensor],
                                                    torch.Tensor],
                sampler, poses: torch.Tensor, log: Log, reps: int,
                ops_per_frame: float, peak: str = "int8",
                extra: dict | None = None) -> dict:
    """Time ``net`` (sample points -> rgb) over the K frames of ``poses``
    [K, 3, 4] (each ``sampler.sample_test`` of its pose, then ``net``, then
    the frame's sum; the checksum is their sum): one call to warm up, then
    ``reps`` calls with CUDA events; ms per frame from the fastest, and
    every call's. The record names the variant under ``key``."""
    def render_k() -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=poses.device)
        for c2w in poses:
            total += net(sampler.sample_test(c2w)).sum()
        return total

    k = poses.shape[0]
    t0 = time.time()
    checksum = float(render_k())
    warmup_s = time.time() - t0
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        render_k()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = min(times) / k
    rec = {key: name, "ms_per_frame": ms, "fps": 1000.0 / ms,
           "warmup_s": warmup_s, "checksum": checksum,
           "all_ms": [t / k for t in sorted(times)],
           "bound_ms": bound_ms(ops_per_frame, peak),
           f"mfu_{peak}": ops_per_frame / (ms * 1e-3) / PEAK_OPS[peak]}
    rec.update(extra or {})
    return log(rec)


def lego_frames(k: int, device):
    """The frame drivers' scene (``exp/probe_pipe.py``, ``exp/probe_epi.py``):
    the lego 400x400 ``PointSampler`` (16 samples, near 2, far 6) and k
    poses ``pose_spherical(theta, -30, 4)`` evenly over the circle, as a
    [k, 3, 4] f32 tensor on ``device``."""
    sampler = PointSampler(H=LEGO_HW, W=LEGO_HW, focal=LEGO_FOCAL,
                           n_sample=16, near=2.0, far=6.0)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4]
                      for t in np.linspace(-180, 180, k, endpoint=False)])
    return sampler, torch.as_tensor(poses, dtype=torch.float32,
                                    device=device)
