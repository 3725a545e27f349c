"""Set-up seconds on the host's clock: from the start of the process to
the start of the window (imports, the kernels' build or load, data and
weights, the check's first steps, the warm units)."""


def read(ctx):
    return ctx.setup_s
