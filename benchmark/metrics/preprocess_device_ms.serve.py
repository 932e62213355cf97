"""Device ms per traced step of the port's profiler range `rasterize.preprocess`: the preprocess of a served frame (projection, EWA covariance, tile rects).
The kernel time inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("rasterize.preprocess")
