"""frame_ms_p95: the 95th percentile of every frame's latency in the
window, from the pose's send to the frame on the host, in ms."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
