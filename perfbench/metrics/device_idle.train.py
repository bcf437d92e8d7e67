"""Share of the traced steps' window in which no device record ran."""


def read(ctx):
    return ctx.idle_pct()
