"""Device ms a step's train-mode BatchNorms launch in the forward: the
records launched inside the program's ``pvn3d.bn`` ranges
(``models/layers.py::BatchNorm``).  The BN backward runs on autograd's
thread, outside them, and stays in ``backward_device_ms.train``."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.bn")
    return s * 1e3 / len(ctx.units) if s > 0 else None
