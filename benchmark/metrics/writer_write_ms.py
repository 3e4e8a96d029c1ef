"""writer_write_ms (datagen writer): the program's mean time a flush in its
span ``datagen.write`` on the writer's thread (the flush's shuffle and its
shards written to disk), over the flushes begun in the traced slice."""
from harness import program


def read(ctx):
    return program.mean_ms(ctx, "datagen.write")
