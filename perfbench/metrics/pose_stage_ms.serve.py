"""Host ms a request spends from votes to poses (``inference/pose.py``,
``inference/meanshift.py``): the span around the closure that
``pipeline.make_pose_fn`` returns."""


def read(ctx):
    return ctx.per_unit_ms(["pose_stage"])
