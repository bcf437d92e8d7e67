"""Host ms a request spends in the point branch (``models/pointnet2.py``):
the span around ``model.pointnet2``'s forward."""


def read(ctx):
    return ctx.per_unit_ms(["point_branch"])
