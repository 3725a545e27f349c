"""The MLP's whole step as a share of the chip's f32 peak (164.9 TFLOP/s,
``harness/costs.py``): the products the window's train steps and
evaluations need, over the window's wall (the untraced window, host
clock)."""


def read(ctx):
    c, w, batch = ctx.costs, ctx.window, ctx.traffic["batch"]
    flops = w["steps"] * c.products_flops(c.mlp_products(ctx.config, batch))
    if ctx.traffic.get("eval"):
        n_test = ctx.traffic["data"]["n_test"]
        flops += w["evals"] * c.products_flops(
            c.mlp_products(ctx.config, n_test, train=False))
    return 100.0 * flops / w["wall_s"] / c.PEAK_FLOPS
