"""The int8-forward training step against the plain step.

Port of ``exp/probe_train_int8.py:54-100``: the canonical student at 81,920
rays a step with hard mining (``_train``), one step of each kind through
``make_distill_step``, each recalibrating its int8 scales from the live
weights at every step on the 32x32 calibration points:

* ``fused_int8_fwd_bf16stash``: the int8 forward K8 with a bf16 stash
  (``fused_stash_q=False``), the backward K5 in groups of 4;
* ``fused_int8_fwd_qstash``: the int8 forward K4 stashing its int8
  q-values, K5 on them;
* ``xla_ctrl``: plain autograd.

One warm-up step, then 50 steps on the same fresh batch back to back, timed
with CUDA events (records ``r3_distill_step_<variant>``: ms/step, rays/s,
the losses). Where a variant fails the driver raises (the JAX driver logs
an error row and goes on).

    python -m r2l_tpu_torch.exp.probe_train_int8 [--steps N] [--reps R]
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from . import _harness, _train

def variants(calib: torch.Tensor) -> tuple:
    """(name, make_distill_step keywords) of each variant."""
    int8 = {"fused_vjp": True, "fused_group_blocks": 4,
            "fused_quantize": "int8", "fused_calib_pts": calib}
    return (("fused_int8_fwd_bf16stash", {**int8, "fused_stash_q": False}),
            ("fused_int8_fwd_qstash", {**int8, "fused_stash_q": True}),
            ("xla_ctrl", {}))


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_train_int8",
                          __doc__, steps=_train.N_STEPS, reps=_train.REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, model = _train.student(torch.Generator().manual_seed(_train.SEED),
                                dev)
    dcfg = _train.distill_config()
    smp = _train.sampler()
    fresh = _train.uniform((dcfg.batch_size - dcfg.n_hard_out, 9),
                           torch.Generator().manual_seed(_train.DATA_SEED),
                           dev)
    for name, kw in variants(_train.calib_points(dev)):
        state, step = _train.variant_step(model, cfg, dcfg, smp, dev, **kw)
        t, state = _train.time_steps(step, state, fresh, args.steps, dev,
                                     args.reps)
        recs.append(log(_train.step_record(f"r3_distill_step_{name}", t,
                                           dcfg, cfg)))
        del state, step
        torch.cuda.empty_cache()
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
