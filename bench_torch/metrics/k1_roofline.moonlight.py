"""K1, the matmul, in the Moonlight train steps: the least time of a
step's K1 products at the chip's peaks (``moonlight_work.products`` at the
traced stretch's routed pairs, ``costs.products_bound_s``), times the
traced steps, over K1's device time in the stretch. It reads only where
K1's traced count is the steps times the products counted (408 a step at
the cell's cut: 12 each layer's four projections, 9 the dense layer's
SwiGLU, 3 each expert layer's router, 9 each held expert and each shared
expert, 3 the head)."""

from harness import manifest

KERNELS = {"matmul_kernel": ("tinynn_autograd_tpu_torch.ops.kernels",
                             "cuda_matmul")}


def read(ctx):
    s, cfg, t = ctx.stretch, ctx.config, ctx.traffic
    work = manifest.reader("moonlight_work")
    pairs = work.routed_pairs(cfg)
    steps = s["records"]["steps"]
    n, seconds = s["kernels"]["matmul_kernel"]
    if pairs is None or steps == 0 or seconds <= 0 \
            or not s["checked"]["matmul_kernel"]:
        return None
    products = work.products(cfg, t["batch"] * t["seq_len"], pairs)
    if n != steps * len(products):
        return None
    return 100.0 * steps * ctx.costs.products_bound_s(products) / seconds
