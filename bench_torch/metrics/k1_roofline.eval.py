"""K1, the matmul, in the evaluations: the least time of the eval's
products (each Dense's forward on the test rows) at the chip's peaks over
K1's device time in the traced stretch, where K1 runs only in the
evaluations (K2 trains)."""

KERNELS = {"matmul_kernel": ("tinynn_autograd_tpu_torch.ops.kernels",
                             "cuda_matmul")}


def read(ctx):
    s, c = ctx.stretch, ctx.costs
    n, seconds = s["kernels"]["matmul_kernel"]
    evals = s["records"]["evals"]
    products = c.mlp_products(ctx.config, ctx.traffic["data"]["n_test"],
                              train=False)
    if not s["checked"]["matmul_kernel"] or evals == 0 or \
            n != evals * len(products) or seconds <= 0:
        return None
    return 100.0 * evals * c.products_bound_s(products) / seconds
