"""Host ms a step spends in the train-mode forward (``models/*``): the
span around the model's forward."""


def read(ctx):
    return ctx.per_unit_ms(["forward"])
