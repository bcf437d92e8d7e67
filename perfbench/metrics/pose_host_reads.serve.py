"""Device-to-host copies a request makes in the pose stage (each host read
of a value, such as MeanShift's stopping rule, is one)."""


def read(ctx):
    if not ctx.trace.layer("pose_stage"):
        return None
    return ctx.device_count(["pose_stage"], "DtoH") / len(ctx.units)
