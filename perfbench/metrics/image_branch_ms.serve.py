"""Host ms a request spends in the image branch (``models/resnet.py``,
``models/pspnet.py``): the span around ``model.cnn.model``'s forward."""


def read(ctx):
    return ctx.per_unit_ms(["image_branch"])
