"""setup_s: seconds from the process's start to the window's start (import,
the build or the load of the kernels, the weights, the cell's own
warm-up)."""


def read(ctx):
    return ctx.setup_s
