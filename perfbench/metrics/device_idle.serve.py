"""Share of a request's time with no device record running: the traced
requests' busy seconds a request over the mean latency of the window's
untraced requests (the profiler's host cost stays out of the time)."""


def read(ctx):
    return ctx.idle_pct()
