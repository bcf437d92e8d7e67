"""Device ms a step's train-mode forward launches: the records launched
inside the program's ``pvn3d.forward`` ranges (``train/step.py``)."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.forward")
    return s * 1e3 / len(ctx.units) if s > 0 else None
