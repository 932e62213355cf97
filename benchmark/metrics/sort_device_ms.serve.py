"""Device ms per traced frame of the port's profiler range `binning.sort`
(ops/binning.py bin_gaussians, inside `rasterize.binning`): the depth argsort,
the expansion (kernel A) between the sorts, and the int64 key sort. The kernel
time inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("binning.sort")
