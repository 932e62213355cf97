"""The gather's transpose on the binning's layout: kernel P (permute_kernel,
which builds the layout in the forward) and kernel D (segment_sum_kernel, in
the backward), `csrc/segment_sum.cu`. The bounds of P and D
(`roofline.permute_bound_s`, `segment_sum_bound_s`) over their device times,
summed over the launches of the traced slice's last step. Raises unless the profile caught
every launch the port's counters counted."""

from benchmark import roofline


def read(ctx):
    t_p = ctx.checked_kernel_times_ms("permute_entries")
    t_d = ctx.checked_kernel_times_ms("segment_sum_rows")
    perm, seg = ctx.captures["permute_entries"], ctx.captures["segment_sum_rows"]
    if not perm or not seg:
        return None
    bound = sum(roofline.permute_bound_s(min(int(total), slots), slots) for slots, total in perm)
    bound += sum(roofline.segment_sum_bound_s(int(entries), F, n) for F, n, entries in seg)
    return 100.0 * bound / ((sum(t_p[-len(perm):]) + sum(t_d[-len(seg):])) / 1e3)
