"""The port's bench entry (bench_cuda.py): its function at a small size on
the CPU (the int8 path, bench.py's record keys), its refusal without a card,
and no fall-through when the int8 kernel fails."""
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_cuda
from r2l_tpu_torch.kernels import r2l_fused as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(device="cpu", h=8, w=8, focal=10.0, k=2, reps=2, netdepth=8,
             netwidth=64)


def test_bench_runs_the_int8_path_small_on_cpu():
    r = bench_cuda.bench(**SMALL)
    assert r["kind"] == "int8" and r["ms_per_frame"] > 0
    assert torch.isfinite(torch.tensor(r["checksum"]))
    rec = bench_cuda.record(2.5, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert list(rec) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert rec["value"] == 400.0 and rec["vs_baseline"] == 4.0
    assert list(rec["extra"]) == ["rays_per_sec_per_chip", "ms_per_frame",
                                  "device", "path", "model", "protocol"]
    assert rec["extra"]["path"] == "cuda-int8-pe-fused"
    json.dumps(rec)


def test_a_failing_int8_kernel_fails_the_bench(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("K2 failed")
    monkeypatch.setattr("r2l_tpu_torch.evaluate.fused_r2l_apply_int8_pe",
                        broken)
    with pytest.raises(RuntimeError, match="K2 failed"):
        bench_cuda.bench(**SMALL)
    assert F.fused_r2l_apply_int8_pe is not broken


def test_bench_cuda_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "bench_cuda.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs an NVIDIA GPU" in out.stderr
