"""batch_records_ms (datagen entry): the program's mean time a pose batch
in its span ``datagen.records`` (the records' assembly from the rays and
the read-back colours), over the traced slice's batches."""
from harness import program


def read(ctx):
    return program.per_unit_ms(ctx, "datagen.batch", ("datagen.records",))
