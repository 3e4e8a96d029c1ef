"""The int8 frame decomposed: the sampler alone, K2 alone, and both.

Port of ``exp/probe_decomp.py:54-90``. The canonical W256/D88 student
(random weights from a seeded generator) packed as
``evaluate._prepare_r2l(..., quantize="int8")`` packs it (calibrated on its
default cameras, the requantize folded), and 16 lego poses at 400x400:

* ``sampler_only``: ``sample_test`` of each pose and the sum of its points;
* ``kernel_only``: K2 on pose 0's points scaled by ``linspace(1, 1.0001,
  K)``, one call per scale, the sum of each output;
* ``full``: ``sample_test`` of each pose, then K2, then the frame's sum.

Each variant runs its K frames back to back, one warm-up call and the
fastest of 3 calls timed with CUDA events; its checksum is the sum of the
frames' sums. K2 runs in the form its packing was made for (``fold_requant``
and ``nobf16_inner``, the deployed frame's). The JAX driver calls the kernel
with its defaults (``fold_requant=False, nobf16_inner=False``) on that
folded packing, so it scales the inner layers twice, a slip of the
reference; the port times the frame the probe set out to decompose. The
JAX driver's ray tile (512, in the record names) is TPU scheduling and is
not ported.

    python -m r2l_tpu_torch.exp.probe_decomp [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from ..evaluate import _prepare_r2l
from ..kernels.r2l_fused import fused_r2l_apply_int8_pe
from ..models.r2l import R2LConfig, init_r2l
from ..sampler import PointSampler, even_z_vals
from . import _harness

H = W = _harness.LEGO_HW
FOCAL = _harness.LEGO_FOCAL
K = 16          # frames per call
REPS = 3
L = 10
SEED = 0        # the student's weights
FOLD_REQUANT = NOBF16_INNER = True   # the packing's form
VARIANTS = ("sampler_only", "kernel_only", "full")


def setup(device, generator: torch.Generator, k: int = K,
          cfg: R2LConfig | None = None, hw: int = H, focal: float = FOCAL):
    """(cfg, the int8 packing, dim_pts, sampler, poses [k, 3, 4]): the
    canonical student (or ``cfg``) from ``generator``, packed by
    ``_prepare_r2l`` with no calibration poses, as the JAX driver calls
    it."""
    cfg = cfg or R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, generator, device)
    sampler, poses = _harness.lego_frames(k, device, hw, focal)
    fp, kind, dim_pts = _prepare_r2l(model, cfg, sampler, L, False, True,
                                     "int8")
    assert kind == "int8", kind
    return cfg, fp, dim_pts, sampler, poses


def k2(fp, cfg: R2LConfig, pts: torch.Tensor, dim_pts: int) -> torch.Tensor:
    """K2 in the packing's form: pts [N, dim_pts] -> rgb [N, 3]."""
    return fused_r2l_apply_int8_pe(fp, cfg, pts, dim_pts, L,
                                   fold_requant=FOLD_REQUANT,
                                   nobf16_inner=NOBF16_INNER)


def sampler_only(sampler: PointSampler, poses: torch.Tensor) -> torch.Tensor:
    return torch.stack([sampler.sample_test(c).sum() for c in poses]).sum()


def kernel_only(fp, cfg: R2LConfig, dim_pts: int, pts0: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    return torch.stack([k2(fp, cfg, pts0 * s, dim_pts).sum()
                        for s in scales]).sum()


def full(fp, cfg: R2LConfig, dim_pts: int, sampler: PointSampler,
         poses: torch.Tensor) -> torch.Tensor:
    return torch.stack([k2(fp, cfg, sampler.sample_test(c), dim_pts).sum()
                        for c in poses]).sum()


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_decomp",
                          __doc__)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, fp, dim_pts, sampler, poses = setup(
        dev, torch.Generator().manual_seed(SEED))
    k = poses.shape[0]
    pts0 = sampler.sample_test(poses[0])
    # jnp.linspace(1, 1.0001, k) bit for bit (torch.linspace rounds
    # otherwise)
    scales = even_z_vals(1.0, 1.0001, k, dev)
    ops = _harness.chain_ops(cfg, sampler.H * sampler.W, cfg.input_dim)
    bodies = {
        "sampler_only": (lambda: sampler_only(sampler, poses), None),
        "kernel_only": (lambda: kernel_only(fp, cfg, dim_pts, pts0, scales),
                        ops),
        "full": (lambda: full(fp, cfg, dim_pts, sampler, poses), ops)}
    for name in VARIANTS:
        fn, n_ops = bodies[name]
        recs.append(_harness.timed(name, fn, REPS, k, log, ops=n_ops))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
