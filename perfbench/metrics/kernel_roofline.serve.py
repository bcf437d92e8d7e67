"""The hand-written kernels' least time on their inputs over their device
time, summed over every call of K1-K4's entry points in the traced
requests."""

LAYERS = ["k.fps", "k.query", "k.interp", "k.winner"]


def read(ctx):
    return ctx.roofline_pct(LAYERS)
