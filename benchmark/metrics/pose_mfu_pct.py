"""pose_mfu_pct (model step): the teacher's FLOPs of a pose (coarse and
fine passes) times the poses a second before the traced slice, as a share
of the TF32 peak (float32 work)."""
from harness import runner
from harness.drivers import datagen
from harness.peaks import PEAK_OPS


def read(ctx):
    r = runner.rate_before_slice(ctx)
    if r is None or r[1] <= 0:
        return None
    rate = r[0] / r[1]
    return 100.0 * datagen.pose_ops(ctx.job) * rate / PEAK_OPS[
        ctx.traffic["precision"]]
