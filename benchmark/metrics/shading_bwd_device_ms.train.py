"""Device ms per traced training step of the port's profiler range
`renderer.shading_backward` (ops/shading.py: the per-Gaussian shading's
gradient over the pool, kernel S' on the card), which runs inside the step's
backward on autograd's thread. The kernel time inside the range's device
spans; nothing where the program has no such range."""


def read(ctx):
    return ctx.range_device_ms("renderer.shading_backward")
