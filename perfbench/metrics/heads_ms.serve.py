"""Host ms a request spends in the fusion and the three heads
(``models/pvn3d.py``): the spans around ``rgbd_feat``, ``SEG_layer``,
``KpOF_layer`` and ``CtrOf_layer``."""


def read(ctx):
    return ctx.per_unit_ms(["heads"])
