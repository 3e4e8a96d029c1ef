"""batch_rays_ms (datagen entry): the program's mean time a pose batch in
its spans ``datagen.rays`` (the poses' host rays and their concatenation)
and ``datagen.upload`` (their copy to the device), over the traced slice's
batches."""
from harness import program


def read(ctx):
    return program.per_unit_ms(ctx, "datagen.batch",
                               ("datagen.rays", "datagen.upload"))
