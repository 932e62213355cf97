"""Median host ms of the port's profiler range `viewer.send` over the traced
frames: `ViewerServer.send_image`, the frame's bytes, the payload and the
blocking `sendall` on the socket."""

import numpy as np


def read(ctx):
    ms = [(e - s) / 1e3 for n, s, e in ctx.cpu if n == "viewer.send"]
    return float(np.median(ms)) if ms else None
