"""The share of the traced stretch's wall in which no operation ran on
the device."""


def read(ctx):
    s = ctx.stretch
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
