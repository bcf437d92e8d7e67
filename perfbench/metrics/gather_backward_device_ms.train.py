"""Device ms a training step's backward spends summing the gradients of
gathered rows into their sources: the records launched inside the
program's ``pvn3d.gather_backward`` ranges
(``models/randla.py::GatherRows.backward``, on autograd's thread; also
inside ``backward_device_ms.train``).  A program without them reads
nothing."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.gather_backward")
    return s * 1e3 / len(ctx.units) if s > 0 else None
