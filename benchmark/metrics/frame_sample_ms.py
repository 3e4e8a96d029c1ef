"""frame_sample_ms (frame entry): the program's mean time a frame in its
span ``frame.sample`` (``sample_test``: the frame's rays and points), over
the traced slice's frames."""
from harness import program


def read(ctx):
    return program.per_unit_ms(ctx, "frame", ("frame.sample",))
