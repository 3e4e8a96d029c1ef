"""loader_wait_ms (data): the host's mean wait for the next batch of fresh
rays from the loader, before the traced slice."""
from harness import runner


def read(ctx):
    return runner.span_ms(ctx, "loader")
