"""The transformer's whole step as a share of the chip's f32 peak (164.9
TFLOP/s, ``harness/costs.py``): the FLOPs the window's train steps need
(``transformer_step_flops``), over the window's wall (the untraced
window, host clock)."""


def read(ctx):
    c, w = ctx.costs, ctx.window
    flops = w["steps"] * c.transformer_step_flops(
        ctx.config, ctx.traffic["batch"], ctx.traffic["seq_len"])
    return 100.0 * flops / w["wall_s"] / c.PEAK_FLOPS
