"""K1, the matmul, in the transformer's train steps: the least time of a
step's K1 products at the chip's peaks (``costs.products_bound_s``), times
the traced steps, over K1's device time in the traced stretch.

A step's K1 products: each block's six Dense products (q, k, v, the output
projection, the MLP's two) forward, dX and dW over all the step's tokens,
36 in 6b, and the head's three on the pooled rows. The share reads only
where all of them ran on K1, the blocks' on its tensor-core tile: K1's
traced count is the steps times 39 and the program's count of tensor-core
launches (``cuda_matmul.tc_launches``) grew by the steps times 36. A
program without that counter reads nothing."""

KERNELS = {"matmul_kernel": ("tinynn_autograd_tpu_torch.ops.kernels",
                             "cuda_matmul"),
           "matmul_kernel_tc": ("harness.counters", "matmul_tc")}


def block_products(config, tokens):
    """One block's K1 products, as (m, k, n)."""
    d, hidden = config["dim"], config["dim"] * config["mlp_ratio"]
    forward = [(tokens, d, d)] * 4 + [(tokens, d, hidden), (tokens, hidden, d)]
    dx = [(m, n, k) for m, k, n in forward]
    dw = [(k, m, n) for m, k, n in forward]
    return forward + dx + dw


def head_products(config, batch):
    d, out = config["dim"], config["num_out"]
    return [(batch, d, out), (d, batch, out), (batch, out, d)]


def read(ctx):
    s, c, cfg, t = ctx.stretch, ctx.costs, ctx.config, ctx.traffic
    steps = s["records"]["steps"]
    blocks = cfg["depth"] * block_products(cfg, t["batch"] * t["seq_len"])
    products = blocks + head_products(cfg, t["batch"])
    n, seconds = s["kernels"]["matmul_kernel"]
    if steps == 0 or seconds <= 0 or not all(s["checked"][k]
                                             for k in KERNELS) \
            or n != steps * len(products) \
            or s["counted"]["matmul_kernel_tc"] != steps * len(blocks):
        return None
    return 100.0 * steps * c.products_bound_s(products) / seconds
