"""Share of the traced served frames' wall time in which no operation ran on
the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)
