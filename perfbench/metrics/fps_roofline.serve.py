"""K1 (farthest-point sampling) alone: its least time over its device
time in the traced requests."""


def read(ctx):
    return ctx.roofline_pct(["k.fps"])
