"""Device ms per traced step of the port's profiler range `rasterize.binning`: the binning of a served frame (expansion A, the int64 sort, tile ranges, P).
The kernel time inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("rasterize.binning")
