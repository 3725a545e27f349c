"""The attention kernels (forward, dq, dk/dv): the least time of the
attention work a train step needs (4 d FLOPs a visible pair forward, 8 d
backward, no recomputation; ``costs.attention_costs``) at the chip's
peaks, over the three kernels' device time in the traced stretch."""

KERNELS = {
    name + "_kernel": ("tinynn_autograd_tpu_torch.ops.attention",
                       "cuda_" + name)
    for name in ("attention_forward", "attention_backward_dq",
                 "attention_backward_dkv")}


def read(ctx):
    s, c, cfg, t = ctx.stretch, ctx.costs, ctx.config, ctx.traffic
    launches = s["records"]["steps"] * cfg["depth"]
    if launches == 0 or any(not s["checked"][k] or s["kernels"][k][0]
                            != launches for k in KERNELS):
        return None
    seconds = sum(s["kernels"][k][1] for k in KERNELS)
    fwd, bwd = c.attention_costs(t["batch"], cfg["heads"], t["seq_len"],
                                 cfg["dim"] // cfg["heads"], cfg["causal"])
    return 100.0 * launches * (c.bound_s(*fwd) + c.bound_s(*bwd)) / seconds
