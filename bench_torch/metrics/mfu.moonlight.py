"""The Moonlight step as a share of the chip's f32 peak (164.9 TFLOP/s,
``harness/costs.py``): the FLOPs the window's train steps need
(``moonlight_work.step_flops``: 6 FLOPs a weight a row of every product at
the traced stretch's routed pairs, and attention's visible pairs at the
split head dims), over the window's wall (the untraced window, host
clock). None where the program does not count its routed pairs."""

from harness import manifest


def read(ctx):
    work = manifest.reader("moonlight_work")
    pairs = work.routed_pairs(ctx.config)
    if pairs is None:
        return None
    c, w = ctx.costs, ctx.window
    flops = w["steps"] * work.step_flops(c, ctx.config, ctx.traffic, pairs)
    return 100.0 * flops / w["wall_s"] / c.PEAK_FLOPS
