"""The fused int8 training step decomposed: recalibration, the forward with
and without its stash, value-and-grad in int8 and bf16, the whole step.

Port of ``exp/probe_train_decomp.py:61-152``, at 81,920 rays with the
canonical student (``_train``); each piece is called 50 times back to back
after one warm-up call, timed with CUDA events (records
``r3_decomp_<piece>``, ms per call):

* ``recalib``: the step's recalibration alone, as the int8 kinds run it
  every step: ``calibrate_r2l_int8_pe`` (unfolded) on the 32x32 points and
  K4's weight image (``stage_int8_train``);
* ``fwd_int8_qstash``: K4 (``train_fwd_int8``, int8 q-value stash) on
  81,920 rows of points uniform in [-1, 1);
* ``fwd_int8_nostash``: K2 (the frame's int8 kernel, no stash) on the same
  points in the same form (unfolded), which isolates the stash's cost;
* ``value_and_grad``: the loss (``distill_loss_fn``) through
  ``make_fused_train_apply`` in int8 (recalibration, K4, K5) and its
  backward, on a batch of 81,920 uniform records;
* ``value_and_grad_bf16``: the same through the bf16 kind (K3, K5);
* ``full_step``: ``make_distill_step`` of the int8 kind, which adds the
  hard pool, the sampler and Adam (a warm-up step, then 50 steps).

    python -m r2l_tpu_torch.exp.probe_train_decomp [--steps N] [--reps R]
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import time

import torch

from ..kernels.r2l_fused import calibrate_r2l_int8_pe, fused_r2l_apply_int8_pe
from ..kernels.r2l_train import make_fused_train_apply, train_fwd_int8
from ..train import distill_loss_fn
from . import _harness, _train

DIM = 48        # 16 samples x 3
PIECES = ("recalib", "fwd_int8_qstash", "fwd_int8_nostash", "value_and_grad",
          "value_and_grad_bf16")
PTS_SEED, BATCH_SEED = 4, 5     # the points and the records


def pieces(model, cfg, dcfg, smp, calib, pts, batch, z_u) -> dict:
    """piece -> a call of it (the warm-up calibrates the int8 packings
    once: ``fwd_*`` reuse them)."""
    L = dcfg.embed_L
    _, calibrate = make_fused_train_apply(
        cfg, DIM, L, group_blocks=4, quantize="int8", calib_pts=calib,
        stash_q=True, external_calib=True)
    fp_k4 = calibrate(model)
    fp_k2 = calibrate_r2l_int8_pe(model, cfg, DIM, L, calib,
                                  fold_requant=False)
    fused = {"int8": make_fused_train_apply(
        cfg, DIM, L, group_blocks=4, quantize="int8", calib_pts=calib,
        stash_q=True), "bf16": make_fused_train_apply(cfg, DIM, L,
                                                      group_blocks=4)}

    def value_and_grad(kind):
        model.zero_grad(set_to_none=True)
        loss, _ = distill_loss_fn(model, cfg, dcfg, smp, batch, z_u,
                                  fused[kind])
        loss.backward()
        return loss.detach()

    return {
        "recalib": lambda: calibrate(model).body_m.sum(),
        "fwd_int8_qstash": lambda: train_fwd_int8(
            fp_k4, cfg, pts, DIM, L, stash_q=True)[0].sum(),
        "fwd_int8_nostash": lambda: fused_r2l_apply_int8_pe(
            fp_k2, cfg, pts, DIM, L, fold_requant=False,
            nobf16_inner=False).sum(),
        "value_and_grad": lambda: value_and_grad("int8"),
        "value_and_grad_bf16": lambda: value_and_grad("bf16")}


def time_piece(fn, n: int, reps: int = 1) -> tuple[float, float]:
    """One warm-up call, then ``reps`` times n calls back to back between
    two CUDA events: (ms per call of the fastest, the warm-up's
    seconds)."""
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    t, _ = _harness.time_calls(lambda: [fn() for _ in range(n)][-1], reps,
                               n, warm=False)
    return t["ms"], warmup_s


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_train_decomp", __doc__,
        steps=_train.N_STEPS, reps=_train.REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    cfg, model = _train.student(torch.Generator().manual_seed(_train.SEED),
                                dev)
    dcfg = _train.distill_config()
    smp = _train.sampler()
    B = dcfg.batch_size
    pts = _train.uniform((B, DIM), torch.Generator().manual_seed(PTS_SEED),
                         dev, -1.0, 1.0)
    gen = torch.Generator().manual_seed(BATCH_SEED)
    batch = _train.uniform((B, 9), gen, dev)
    z_u = _train.uniform((B, _train.N_SAMPLE), gen, dev)
    calib = _train.calib_points(dev)
    fns = pieces(model, cfg, dcfg, smp, calib, pts, batch, z_u)
    ops = _harness.chain_ops(cfg, B, cfg.input_dim)
    peaks = {"fwd_int8_qstash": (ops, "int8"),
             "fwd_int8_nostash": (ops, "int8"),
             "value_and_grad": (3 * ops, "bf16"),
             "value_and_grad_bf16": (3 * ops, "bf16")}
    for name in PIECES:
        n_ops, peak = peaks.get(name, (None, "bf16"))
        ms, warmup_s = time_piece(fns[name], args.steps, args.reps)
        recs.append(log(_harness.rate(
            {"name": f"r3_decomp_{name}", "ms": ms, "warmup_s": warmup_s},
            n_ops, peak, ms)))
    state, step = _train.variant_step(
        model, cfg, dcfg, smp, dev, fused_vjp=True, fused_group_blocks=4,
        fused_quantize="int8", fused_calib_pts=calib, fused_stash_q=True)
    fresh = _train.uniform((B - dcfg.n_hard_out, 9),
                           torch.Generator().manual_seed(_train.DATA_SEED),
                           dev)
    t, state = _train.time_steps(step, state, fresh, args.steps, dev,
                                 args.reps)
    recs.append(log(_harness.rate(
        {"name": "r3_decomp_full_step", "ms": t["ms_per_step"],
         "warmup_s": t["warmup_s"], "loss_first": t["loss_first"],
         "loss": t["loss"]}, 3 * ops, "bf16", t["ms_per_step"])))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
