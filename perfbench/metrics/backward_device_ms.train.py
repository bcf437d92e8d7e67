"""Device ms a step's backward launches: the records launched inside the
autograd engine's ranges, K3's backward kernel among them."""


def read(ctx):
    ms = ctx.trace.device_under("autograd::engine::evaluate_function")
    return ms * 1e3 / len(ctx.units) if ms > 0 else None
