"""Kernel B (`csrc/tile_composite.cu` composite_fwd_kernel, C = 3 when
serving): the bound of each captured launch (`roofline.composite_fwd_bound_s`
on its own pairs) over its device time, summed over the
captured launches (the traced slice's last steps).
Raises unless the profile caught every launch the port's counter counted."""

from benchmark import roofline


def read(ctx):
    times = ctx.checked_kernel_times_ms("composite_forward")
    caps = ctx.captures["composite_forward"]
    if not caps:
        return None
    pairs = ctx.composite_pairs("composite_forward")
    bound = sum(roofline.composite_fwd_bound_s(p, feat.shape[1], ts.shape[0], feat.shape[1] - 6)
                for p, (feat, ts, te) in zip(pairs, caps))
    return 100.0 * bound / (sum(times[-len(caps):]) / 1e3)
