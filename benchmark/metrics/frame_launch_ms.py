"""frame_launch_ms (kernels): the program's mean time a frame in its spans
``kernel.launch`` (the launch wrapper's host work: checks, the library's
load, the C launcher's call), over the traced slice's frames."""
from harness import program


def read(ctx):
    return program.per_unit_ms(ctx, "frame", ("kernel.launch",))
