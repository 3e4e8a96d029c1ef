"""step_ms: the window's time (its start to the last step's work done on
the card) over its steps, whole steps only, in ms."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.seconds / w.units if w.units else None
