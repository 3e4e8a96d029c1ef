"""k2_roofline (kernels): the least time of the slice's K2 launches
(operations at the path's peak or bytes at 3.35 TB/s, counted in
benchmark/counts) over their device time in the trace, in %."""
from harness import runner


def read(ctx):
    return runner.kernel_roofline(ctx, "k2")
