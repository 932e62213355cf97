"""Device ms per traced step of the port's profiler range `train_step.adam`: Adam's update (train_step.apply_update).
The kernel time inside the range's device spans."""


def read(ctx):
    return ctx.range_device_ms("train_step.adam")
