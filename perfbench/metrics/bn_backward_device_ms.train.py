"""Device ms a step's train-mode BatchNorms launch in the backward: the
records launched inside the program's ``pvn3d.batchnorm_backward`` ranges
(``ops/kernels/bn.py::BatchNormTrain.backward``, on autograd's thread).
A program without them (before the BatchNorm function) reads nothing."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.batchnorm_backward")
    return s * 1e3 / len(ctx.units) if s > 0 else None
