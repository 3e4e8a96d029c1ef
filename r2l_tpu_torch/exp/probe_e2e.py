"""The int8 400x400 frame end to end, as a user renders it.

Port of ``exp/probe_e2e.py:39-71``: the canonical W256/D88 student (random
weights from a seeded generator) through the production path,
``evaluate.make_r2l_bench_fn(..., quantize="int8")`` (``sample_test`` then
K2, calibrated on its default cameras), over 16 lego poses: one warm-up
call, then the fastest of 3 calls timed with CUDA events, as ms per frame
and frames/s. The JAX driver's four ray tiles (``int8r_t640`` ...
``int8r_t512``) are TPU scheduling; K2 picks its own, so they are one row,
``int8r``. (Its docstring names a bf16 row that its code never runs.)

    python -m r2l_tpu_torch.exp.probe_e2e [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from ..evaluate import make_r2l_bench_fn
from ..models.r2l import R2LConfig, init_r2l
from . import _harness

H = W = _harness.LEGO_HW
FOCAL = _harness.LEGO_FOCAL
K = 16          # frames per call
REPS = 3
L = 10
SEED = 0        # the student's weights


def setup(device, generator: torch.Generator, k: int = K,
          cfg: R2LConfig | None = None, hw: int = H, focal: float = FOCAL):
    """(cfg, the int8 bench function, sampler, poses [k, 3, 4]): the
    canonical student (or ``cfg``) from ``generator``."""
    cfg = cfg or R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, generator, device)
    sampler, poses = _harness.lego_frames(k, device, hw, focal)
    bench = make_r2l_bench_fn(model, cfg, sampler, embed_L=L,
                              use_pallas=True, quantize="int8")
    assert bench.kind == "int8", bench.kind
    return cfg, bench, sampler, poses


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_e2e",
                          __doc__)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, bench, sampler, poses = setup(
        dev, torch.Generator().manual_seed(SEED))
    ops = _harness.chain_ops(cfg, sampler.H * sampler.W, cfg.input_dim)
    recs.append(_harness.timed("int8r", lambda: bench(poses), REPS,
                               poses.shape[0], log, ops=ops))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
