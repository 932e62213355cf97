"""Share of the canvas pixels that a step renders and no photo pixel lies
under: 1 - photo pixels / canvas pixels, from the view store's counters over
every fetch of the measured window (a traced slice's few steps would read one
photo size or another: 25% or 33% at this collection's sizes). What rendering
each photo at its own size would save. Nothing where the program has no view
store."""


def read(ctx):
    canvas = ctx.info.get("window_fetch_canvas_pixels")
    if not canvas:
        return None
    return 100.0 * (1.0 - ctx.info["window_fetch_photo_pixels"] / canvas)
