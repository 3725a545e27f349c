"""K2, the whole-epoch kernel: the least time of its epochs' work at the
chip's peaks (``costs.k2_epoch_cost``) over its device time in the traced
stretch."""

KERNELS = {"fused_epoch_kernel": ("tinynn_autograd_tpu_torch.ops.fused_epoch",
                                  "cuda_fused_epoch")}


def read(ctx):
    s = ctx.stretch
    n, seconds = s["kernels"]["fused_epoch_kernel"]
    if not s["checked"]["fused_epoch_kernel"] or n == 0 or seconds <= 0:
        return None
    c, batch = ctx.costs, ctx.traffic["batch"]
    steps = ctx.traffic["data"]["n_train"] // batch
    return 100.0 * n * c.bound_s(*c.k2_epoch_cost(ctx.config, steps, batch)) \
        / seconds
