"""Kernel V (view_unpack_kernel, the port's `csrc/view_unpack.cu`): the bytes
its launches in the traced slice need (`view_bounds.unpack_bound_s`: each
fetched photo's stored bytes read, its canvas written at 20 bytes a pixel,
from the view store's counters) over their profiled device time. Raises
unless the profile caught as many launches as the kernel's counter and the
store's fetch counter counted; nothing where the program has no kernel V."""

from benchmark import view_bounds


def read(ctx):
    want = ctx.launches.get("view_unpack")
    if not want:
        return None
    times = ctx.kernel_times_ms("view_unpack_kernel")
    if len(times) != want or want != ctx.launches.get("view_store.fetches"):
        raise RuntimeError(f"the profile caught {len(times)} launches of view_unpack_kernel, "
                           f"the counters {want} and {ctx.launches.get('view_store.fetches')}")
    bound = view_bounds.unpack_bound_s(ctx.launches["view_store.fetch_photo_pixels"],
                                       ctx.info["store_bytes_per_pixel"],
                                       ctx.launches["view_store.fetch_canvas_pixels"])
    return 100.0 * bound / (sum(times) / 1e3)
