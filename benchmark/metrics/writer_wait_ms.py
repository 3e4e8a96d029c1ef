"""writer_wait_ms (datagen writer): the program's mean time a flush in its
span ``datagen.flush`` (the put of the records on the writer's queue,
which blocks while the queue is full), over the traced slice's flushes."""
from harness import program


def read(ctx):
    return program.mean_ms(ctx, "datagen.flush")
