"""idle_in_program_pct (device), datagen cells: the share of the traced
slice's device-idle time during which the host was inside one of the
program's ranges on the pose loop's thread (a batch, a flush, the writer's
join), less the benchmark's own draws inside a batch (``datagen.draws``),
in %. The caller's camera draws and progress are outside every range."""
from harness import program


def read(ctx):
    return program.idle_in_program_pct(ctx, "datagen.batch",
                                       leave_out=("datagen.draws",))
