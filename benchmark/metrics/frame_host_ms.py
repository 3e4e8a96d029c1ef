"""frame_host_ms (frame entry): the host's mean time in a call of the frame
function, which returns once the frame is enqueued, before the traced
slice."""
from harness import runner


def read(ctx):
    return runner.span_ms(ctx, "frame")
