"""Device operations launched a train step (kernels; copies and sets left
out), from the traced stretch."""


def read(ctx):
    steps = ctx.stretch["records"]["steps"]
    return ctx.stretch["launches"] / steps if steps else None
