"""Host ms a request spends building its frame (``data/device_frame.py``,
``ops/preprocess.py``): the span around ``build_inference_batch_device``."""


def read(ctx):
    return ctx.per_unit_ms(["frame_build"])
