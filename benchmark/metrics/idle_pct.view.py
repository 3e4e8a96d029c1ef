"""idle_pct (device): one less the union of the device's operations over
the traced slice's wall time, in %."""
from harness import runner


def read(ctx):
    return runner.idle_pct(ctx)
