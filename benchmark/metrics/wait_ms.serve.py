"""Host ms a traced frame of the port's profiler range `viewer.wait`: the
viewer's paused loop sleeping while no request is pending
(`viewer.handle_viewer_request`), summed over the traced slice and divided by
its frames."""


def read(ctx):
    ms = [(e - s) / 1e3 for n, s, e in ctx.cpu if n == "viewer.wait"]
    return sum(ms) / ctx.steps if ms else None
