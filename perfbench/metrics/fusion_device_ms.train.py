"""Device ms a training step's forward launches in FFB6D's bidirectional
fusion: the records launched inside the program's ``pvn3d.fusion``
ranges (``models/ffb6d.py::FFB6D.fuse``, both directions of each of the
seven stages).  Their backward runs on autograd's thread, outside them.
A program without them reads nothing."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.fusion")
    return s * 1e3 / len(ctx.units) if s > 0 else None
