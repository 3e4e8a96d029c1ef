"""Stratified against permutation hard-pool sampling, in whole steps.

Port of ``exp/probe_strat.py:37-80``: the canonical student at 81,920 rays
a step with hard mining (``_train``), for each ``hard_sample`` mode
(``stratified``: one slot drawn from each of 16,384 strata of the
1,638,400-ray pool, then shuffled; ``permutation``: the first 16,384 of a
permutation of the pool), two step kinds through ``make_distill_step``:

* ``fused_int8``: the int8 forward K4 with its q-value stash, recalibrated
  every step, and K5 in groups of 4;
* ``xla_bf16``: plain autograd.

Each starts from the same weights, takes one warm-up step, then 50 steps on
the same fresh batch back to back, timed with CUDA events (records
``r3_strat_<kind>_<mode>``: ms/step, rays/s, the losses).

    python -m r2l_tpu_torch.exp.probe_strat [--steps N] [--reps R]
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from . import _harness, _train

MODES = ("stratified", "permutation")


def variants(calib: torch.Tensor) -> tuple:
    """(name, make_distill_step keywords) of each step kind."""
    return (("fused_int8", {"fused_vjp": True, "fused_group_blocks": 4,
                            "fused_quantize": "int8",
                            "fused_calib_pts": calib,
                            "fused_stash_q": True}),
            ("xla_bf16", {}))


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_strat",
                          __doc__, steps=_train.N_STEPS, reps=_train.REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, model = _train.student(torch.Generator().manual_seed(_train.SEED),
                                dev)
    smp = _train.sampler()
    calib = _train.calib_points(dev)
    for mode in MODES:
        dcfg = _train.distill_config(hard_sample=mode)
        fresh = _train.uniform(
            (dcfg.batch_size - dcfg.n_hard_out, 9),
            torch.Generator().manual_seed(_train.DATA_SEED), dev)
        for name, kw in variants(calib):
            state, step = _train.variant_step(model, cfg, dcfg, smp, dev,
                                              **kw)
            t, state = _train.time_steps(step, state, fresh, args.steps,
                                         dev, args.reps)
            recs.append(log(_train.step_record(
                f"r3_strat_{name}_{mode}", t, dcfg, cfg,
                {"hard_sample": mode})))
            del state, step
            torch.cuda.empty_cache()
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
