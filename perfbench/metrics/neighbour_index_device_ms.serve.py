"""Device ms a request's neighbour index launches: the records launched
inside the program's ``pvn3d.neighbour_index`` ranges (the 22 k-NN
searches and the strided maps).  A program without them reads nothing."""


def read(ctx):
    s = ctx.trace.device_under("pvn3d.neighbour_index")
    return s * 1e3 / len(ctx.units) if s > 0 else None
