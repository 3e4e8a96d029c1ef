"""idle_in_program_pct (device), view cells: the share of the traced
slice's device-idle time during which the host was inside one of the
program's ranges (a frame call) on the frame loop's thread, in %."""
from harness import program


def read(ctx):
    return program.idle_in_program_pct(ctx, "frame")
