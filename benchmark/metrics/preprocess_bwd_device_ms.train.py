"""Device ms per traced training step of the port's profiler range
`rasterize.preprocess_backward` (ops/preprocess.py: the gradient of the
projection, the EWA covariance and the conic over the pool, kernel R' on the
card), which runs inside the step's backward on autograd's thread. The kernel
time inside the range's device spans; nothing where the program has no such
range."""


def read(ctx):
    return ctx.range_device_ms("rasterize.preprocess_backward")
