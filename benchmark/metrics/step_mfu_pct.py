"""step_mfu_pct (model step): 3x the forward's FLOPs of a step's batch
times the steps a second before the traced slice, as a share of the peak
of the traffic's precision (bf16)."""
from harness import runner
from harness.drivers import distill
from harness.peaks import PEAK_OPS


def read(ctx):
    r = runner.rate_before_slice(ctx)
    if r is None or r[1] <= 0:
        return None
    return 100.0 * distill.step_ops(ctx.job) * r[0] / r[1] / PEAK_OPS[
        ctx.traffic["precision"]]
