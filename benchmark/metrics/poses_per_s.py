"""poses_per_s: poses whose records are on disk, over the window's time (its
start to the moment the call returned, its writer joined)."""


def read(ctx):
    w = ctx.window
    if not w.units or w.seconds <= 0:
        return None
    return w.units / w.seconds
