"""Device ms a training step's neighbour index launches: the records
launched inside the program's ``pvn3d.neighbour_index`` ranges (FFB6D's
22 k-NN searches a frame and the strided maps, built on the card by
``train/step.py`` from the batch's points and cloud map).  A program
without them reads nothing."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.neighbour_index")
    return s * 1e3 / len(ctx.units) if s > 0 else None
