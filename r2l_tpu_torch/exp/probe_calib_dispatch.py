"""How often the int8 step recalibrates, and the backward's group size, in
16-step calls.

Port of ``exp/probe_calib_dispatch.py:69-121``: the canonical student at
81,920 rays a step with hard mining (``_train``), the int8 forward K4 with
its q-value stash and K5, through ``make_distill_step(...,
scan_steps=16)``: each call takes 16 steps over a [16, 65,536, 9] stack of
fresh batches. Variants:

* ``instep_g4``: recalibrated at every step (``fused_calib_every=1``, the
  default), K5 in groups of 4;
* ``dispatch_g4``: once per 16-step call (``fused_calib_every=16``);
* ``every4_g4``: at the call's entry and then every 4 steps;
* ``dispatch_g2``, ``dispatch_g8``: once per call, K5 in groups of 2 or 8.

One warm-up call, then 6 calls back to back timed with CUDA events
(records ``r3_calib_<variant>``: ms per step, the losses). The JAX driver's
ray-tile rows (``dispatch_t256_g4``, ``dispatch_t1024_g4``) and the ``_t512``
in its names are TPU tiles: not ported (ROADMAP's "Do not port").

    python -m r2l_tpu_torch.exp.probe_calib_dispatch [--dispatches N]
        [--reps R] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from . import _harness, _train

K = 16          # steps per call (the CLI's scan on the TPU)
N = 6           # timed calls
VARIANTS = (("instep_g4", 1, 4), ("dispatch_g4", K, 4),
            ("every4_g4", 4, 4), ("dispatch_g2", K, 2),
            ("dispatch_g8", K, 8))


def step_kw(calib: torch.Tensor, every: int, gb: int, k: int = K) -> dict:
    """make_distill_step's keywords of a variant."""
    return {"fused_vjp": True, "fused_group_blocks": gb,
            "fused_quantize": "int8", "fused_calib_pts": calib,
            "scan_steps": k, "fused_calib_every": every}


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_calib_dispatch", __doc__,
        dispatches=N, reps=_train.REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, model = _train.student(torch.Generator().manual_seed(_train.SEED),
                                dev)
    dcfg = _train.distill_config()
    smp = _train.sampler()
    batches = _train.uniform((K, dcfg.batch_size - dcfg.n_hard_out, 9),
                             torch.Generator().manual_seed(_train.DATA_SEED),
                             dev)
    calib = _train.calib_points(dev)
    for name, every, gb in VARIANTS:
        state, step = _train.variant_step(model, cfg, dcfg, smp, dev,
                                          **step_kw(calib, every, gb, K))
        t, state = _train.time_steps(step, state, batches, args.dispatches,
                                     dev, args.reps)
        recs.append(log(_train.step_record(
            f"r3_calib_{name}", t, dcfg, cfg,
            {"K": K, "fused_calib_every": every, "group_blocks": gb})))
        del state, step
        torch.cuda.empty_cache()
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
