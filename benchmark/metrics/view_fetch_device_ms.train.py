"""Device ms per traced training step of the port's profiler range
`trainer.view_fetch` (data/view_store.py: the step's padded canvas built
from the stored photo, kernel V on the card), which the trainer loop runs
before each step. The slice holds one fetch a step (it opens inside the first
step, after that step's fetch, and closes after the fetch of the step past
its last). Nothing where the program has no such range."""


def read(ctx):
    return ctx.range_device_ms("trainer.view_fetch")
