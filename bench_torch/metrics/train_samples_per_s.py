"""Training rows over the whole window's wall, evaluations and the
epochs' read-backs included (host clock)."""


def read(ctx):
    return ctx.window["rows"] / ctx.window["wall_s"]
