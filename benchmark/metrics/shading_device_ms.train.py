"""Device ms per traced training step of the port's profiler range
`renderer.shading` (inside `train_step.leaf_inputs`): the forward's share of
the per-Gaussian shading over the pool. Its gradient runs on autograd's thread,
outside the range, and is part of `backward_device_ms.train`. The kernel time
inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("renderer.shading")
