"""Training tokens (rows x sequence length) over the whole window's wall
(host clock)."""


def read(ctx):
    return ctx.window["tokens"] / ctx.window["wall_s"]
