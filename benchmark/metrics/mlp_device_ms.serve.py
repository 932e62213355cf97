"""Device ms per traced frame of the port's profiler range `nets.mlp`: the
illumination MLP (models/nets.py MLPNet.forward) of a served frame.
The kernel time inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("nets.mlp")
