"""Does one K2 call over all K frames beat K calls, one a frame?

Port of ``exp/probe_batch.py:57-95``. The canonical W256/D88 student
(random weights from a seeded generator), int8 as the production frame
packs it, and 16 lego poses at 400x400:

* ``laxmap``: ``make_r2l_bench_fn(..., quantize="int8")``, one frame after
  another (``sample_test`` -> K2 -> the frame's sum);
* ``batched``: ``sample_test`` of every pose concatenated into one input of
  K x 160,000 = 2,560,000 rays (2.56 M x 48 f32, 491.5 MB), one K2 call,
  the sum of its output.

One warm-up call, then the fastest of 4 timed with CUDA events. The two
differ only in how the rays are batched, so every ray's rgb must agree:
the driver compares the batched output with each frame's (``compare``) and
records the largest difference and whether they are bit for bit, beside
the two checksums (which differ by the f32 order of their sums). The JAX
driver's tiles (``laxmap_t800``, ``batched_t800`` ... ``batched_t2000``) are
TPU scheduling and are one row each here. The JAX driver calls the kernel
with its defaults on the folded packing (``probe_decomp``'s slip); the port
runs the packing's form, so both variants compute the same frame.

    python -m r2l_tpu_torch.exp.probe_batch [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from ..evaluate import _prepare_r2l, make_r2l_bench_fn
from ..models.r2l import R2LConfig, init_r2l
from ..sampler import PointSampler
from . import _harness
from .probe_decomp import k2

H = W = _harness.LEGO_HW
FOCAL = _harness.LEGO_FOCAL
K = 16          # frames per call
REPS = 4
L = 10
SEED = 0        # the student's weights


def setup(device, generator: torch.Generator, k: int = K,
          cfg: R2LConfig | None = None, hw: int = H, focal: float = FOCAL):
    """(cfg, the bench function, the int8 packing, dim_pts, sampler, poses
    [k, 3, 4]): the canonical student (or ``cfg``) from ``generator``; the
    packing is ``_prepare_r2l``'s, the bench function's own."""
    cfg = cfg or R2LConfig(compute_dtype=torch.bfloat16)
    model = init_r2l(cfg, generator, device)
    sampler, poses = _harness.lego_frames(k, device, hw, focal)
    bench = make_r2l_bench_fn(model, cfg, sampler, embed_L=L,
                              use_pallas=True, quantize="int8")
    fp, kind, dim_pts = _prepare_r2l(model, cfg, sampler, L, False, True,
                                     "int8")
    assert kind == bench.kind == "int8", kind
    return cfg, bench, fp, dim_pts, sampler, poses


def batched_points(sampler: PointSampler, poses: torch.Tensor
                   ) -> torch.Tensor:
    """[K * H * W, dim_pts]: every pose's ``sample_test``, in pose order."""
    return torch.cat([sampler.sample_test(c) for c in poses])


def batched(fp, cfg: R2LConfig, dim_pts: int, sampler: PointSampler,
            poses: torch.Tensor) -> torch.Tensor:
    return k2(fp, cfg, batched_points(sampler, poses), dim_pts).sum()


def compare(fp, cfg: R2LConfig, dim_pts: int, sampler: PointSampler,
            poses: torch.Tensor) -> dict:
    """The batched call's rgb against each frame's own call: max-abs, RMS
    and whether every value is equal."""
    got = k2(fp, cfg, batched_points(sampler, poses), dim_pts)
    n = sampler.H * sampler.W
    worst, sq, same = 0.0, 0.0, True
    for i, c in enumerate(poses):
        want = k2(fp, cfg, sampler.sample_test(c), dim_pts)
        d = (got[i * n:(i + 1) * n] - want).double()
        worst = max(worst, float(d.abs().max()))
        sq += float((d * d).sum())
        same = same and bool(torch.equal(got[i * n:(i + 1) * n], want))
    return {"max_abs_err_vs_frames": worst,
            "rms_err_vs_frames": (sq / got.numel()) ** 0.5,
            "bit_for_bit": same}


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_batch",
                          __doc__)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, bench, fp, dim_pts, sampler, poses = setup(
        dev, torch.Generator().manual_seed(SEED))
    k = poses.shape[0]
    ops = _harness.chain_ops(cfg, sampler.H * sampler.W, cfg.input_dim)
    a = _harness.timed("laxmap", lambda: bench(poses), REPS, k, log,
                       ops=ops)
    n_in = k * sampler.H * sampler.W * dim_pts * 4
    b = _harness.timed("batched",
                       lambda: batched(fp, cfg, dim_pts, sampler, poses),
                       REPS, k, log, ops=ops,
                       extra={"input_mb": n_in / 1e6,
                              **compare(fp, cfg, dim_pts, sampler, poses)})
    recs += [a, b]
    recs.append(log({"name": "checksums", "laxmap": a["checksum"],
                     "batched": b["checksum"],
                     "rel_diff": abs(a["checksum"] - b["checksum"])
                     / abs(a["checksum"])}))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
