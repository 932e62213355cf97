"""Device ms per traced training step of the backward: the device's busy time
strictly between the end of each step's `train_step.losses` device span and
the start of its `train_step.adam` device span. The backward runs on
autograd's thread, so its own ranges hold no device span; the card runs one
stream, so what runs between the losses and Adam is the backward (and the
zero gradients of unused leaves)."""


def read(ctx):
    losses, adam = sorted(ctx.spans.get("train_step.losses", [])), sorted(
        ctx.spans.get("train_step.adam", []))
    if not losses or not adam:
        return None
    busy = 0.0
    for _, lo in losses:
        hi = min((s for s, _ in adam if s >= lo), default=None)
        if hi is None:
            continue
        end = lo
        for _, s, e in ctx.kernels:
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
    return busy / 1e3 / ctx.steps
