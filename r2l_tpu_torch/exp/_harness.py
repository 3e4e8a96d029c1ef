"""The probes' shared protocol (the port of ``exp/probe_mxu.py``'s
``time_variant`` and ``log``).

A variant is timed as K_REPS frames back to back, each on an input varied
per frame (``rep_scales``, as JAX scales the input by ``linspace(1,
1.0001, 8)``), their scalar checksums summed; one call warms up (and builds
the kernel), then the min of 3 calls timed with CUDA events, divided by
K_REPS. Rates are held against the H100's data-sheet peaks (dense, at
700 W), not the TPU's. Records are JSON lines on stdout and, with an
``out`` path, appended there.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable

import torch

K_REPS = 8
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit (f32:
# the tensor cores' TF32 rate is not used; 67 T/s is the FMA units').
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


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
    rec.update(extra or {})
    return log(rec)
