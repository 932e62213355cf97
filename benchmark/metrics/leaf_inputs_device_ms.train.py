"""Device ms per traced step of the port's profiler range `train_step.leaf_inputs`: the MLP, the envlight noise and the per-Gaussian shading of the step (train_step.make_leaf_inputs).
The kernel time inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("train_step.leaf_inputs")
