"""step_host_ms (training entry): the host's mean time in a call of the
distillation step, before the traced slice."""
from harness import runner


def read(ctx):
    return runner.span_ms(ctx, "step")
