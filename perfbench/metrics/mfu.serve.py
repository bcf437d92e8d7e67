"""The literal graph's forward FLOPs of a request over the mean latency of
the window's untraced requests, as a share of the bf16 peak (989
TFLOP/s): the profiler's host cost stays out of the time."""


def read(ctx):
    return ctx.mfu_pct(1.0)
