"""Three times the literal graph's forward FLOPs of every traced frame
(forward and backward) over the traced window, as a share of the bf16
peak (989 TFLOP/s)."""


def read(ctx):
    return ctx.mfu_pct(3.0)
