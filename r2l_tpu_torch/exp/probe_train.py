"""The distillation step at the reference's training configuration, plain
and fused.

Port of ``exp/probe_train.py:41-80``: the canonical W256/D88 student in
bf16 at 81,920 rays a step with hard mining (``_train``), one step of each
kind through ``make_distill_step``:

* ``xla``: plain autograd through the ``R2L`` module;
* ``fused_gb4``, ``fused_gb6``, ``fused_gb8``: the fused forward K3 and the
  backward K5 walking the body in groups of 4, 6 or 8 blocks
  (``fused_group_blocks``).

Each variant starts from the same weights, takes one warm-up step, then 50
steps on the same fresh batch back to back, timed with CUDA events; the
record holds ms/step, rays/s, the warm-up step's loss and the last one.
Variant names given as arguments run those alone, as the JAX driver's
command line does. Where a variant fails the driver raises (the JAX driver
logs an error row and goes on).

    python -m r2l_tpu_torch.exp.probe_train [VARIANT ...] [--steps N]
        [--reps R] [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from . import _harness, _train

VARIANTS = (("xla", {}),
            ("fused_gb4", {"fused_vjp": True, "fused_group_blocks": 4}),
            ("fused_gb6", {"fused_vjp": True, "fused_group_blocks": 6}),
            ("fused_gb8", {"fused_vjp": True, "fused_group_blocks": 8}))


def run(names, steps: int, log: _harness.Log, device,
        reps: int = 1) -> list[dict]:
    """Time the variants ``names`` on the card."""
    cfg, model = _train.student(torch.Generator().manual_seed(_train.SEED),
                                device)
    dcfg = _train.distill_config()
    smp = _train.sampler()
    fresh = _train.uniform((dcfg.batch_size - dcfg.n_hard_out, 9),
                           torch.Generator().manual_seed(_train.DATA_SEED),
                           device)
    recs = []
    for name, kw in VARIANTS:
        if name not in names:
            continue
        state, step = _train.variant_step(model, cfg, dcfg, smp, device,
                                          **kw)
        t, state = _train.time_steps(step, state, fresh, steps, device,
                                     reps)
        recs.append(log(_train.step_record(f"distill_step_{name}", t, dcfg,
                                           cfg)))
        del state, step
        torch.cuda.empty_cache()
    return recs


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_train",
                          __doc__, variants=tuple(n for n, _ in VARIANTS),
                          steps=_train.N_STEPS, reps=_train.REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    recs += run(args.variant, args.steps, log, dev, args.reps)
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
