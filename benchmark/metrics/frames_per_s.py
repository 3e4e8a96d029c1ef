"""frames_per_s: every frame on the host in the window, over the window's
time (its start to the last frame's arrival)."""


def read(ctx):
    w = ctx.window
    return w.units / w.seconds if w.units and w.seconds > 0 else None
