"""Device ms per traced frame of the port's profiler range `renderer.shading`:
the per-Gaussian shading of a served frame (renderer.compute_colors: the SH
basis, Cook-Torrance, the sky colour). The kernel time inside the range's
device spans."""


def read(ctx):
    return ctx.range_device_ms("renderer.shading")
