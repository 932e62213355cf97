"""Host ms a traced step of the port's profiler range `trainer.overflow_read`:
the trainer loop's read of the previous step's overflow count, which waits for
that step on the device, summed over the traced slice and divided by its steps.
The slice opens after its first iteration's read and closes after the read of
the iteration past its last step, so it holds one read a step."""


def read(ctx):
    ms = [(e - s) / 1e3 for n, s, e in ctx.cpu if n == "trainer.overflow_read"]
    return sum(ms) / ctx.steps if ms else None
