"""frame_syncs (frame entry): the program's counter ``sync`` of its span
``frame`` (operations torch flags as synchronising, and the caching
allocator's device allocations, frees and all-stream syncs) over the
traced slice's frames."""
from harness import program


def read(ctx):
    return program.per_unit_count(ctx, "frame", "sync")
