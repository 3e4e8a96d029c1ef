"""frame_mfu_pct (model step): the model's FLOPs of a frame times the frames
a second before the traced slice, as a share of the peak of the path's
precision (the traffic's ``precision``: int8, or tf32 for float32)."""
from harness import runner
from harness.drivers import view
from harness.peaks import PEAK_OPS


def read(ctx):
    r = runner.rate_before_slice(ctx)
    if r is None or r[1] <= 0:
        return None
    rate = r[0] / r[1]
    return 100.0 * view.frame_ops(ctx.job) * rate / PEAK_OPS[
        ctx.traffic["precision"]]
