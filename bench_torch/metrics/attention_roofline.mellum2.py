"""The attention kernels (forward, dq, dk/dv) in the Mellum 2 train steps:
the least time of each layer's attention work at the chip's peaks (its
visible pairs, a band of ``sliding_window`` keys on sliding layers and the
causal triangle on full ones, times 32 query heads, 4 d FLOPs a pair
forward and 8 d backward; ``mellum2_work.attention_layers``), over the
three kernels' device time in the traced stretch. It reads only where
each kernel ran once a layer a step."""

from harness import manifest

KERNELS = manifest.reader("attention_roofline").KERNELS


def read(ctx):
    s, c, cfg, t = ctx.stretch, ctx.costs, ctx.config, ctx.traffic
    launches = s["records"]["steps"] * cfg["layers"]
    if launches == 0 or any(not s["checked"][k] or s["kernels"][k][0]
                            != launches for k in KERNELS):
        return None
    seconds = sum(s["kernels"][k][1] for k in KERNELS)
    bound = sum(c.bound_s(*fwd) + c.bound_s(*bwd) for fwd, bwd in
                manifest.reader("mellum2_work").attention_layers(
                    cfg, t["batch"], t["seq_len"]))
    return 100.0 * s["records"]["steps"] * bound / seconds
