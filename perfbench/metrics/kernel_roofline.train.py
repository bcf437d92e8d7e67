"""The hand-written kernels' least time over their device time in the
traced steps, K3's backward with them."""

LAYERS = ["k.fps", "k.query", "k.interp", "k.interp_bwd", "k.winner"]


def read(ctx):
    return ctx.roofline_pct(LAYERS)
