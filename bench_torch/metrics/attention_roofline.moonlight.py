"""The attention kernels (forward, dq, dk/dv) in the Moonlight train steps,
at multi-head latent attention's split head dims (192-wide queries and
keys, 128-wide values): the least time of each layer's attention work at
the chip's peaks (the causal pairs times 16 heads, 2 (d_qk + d_v) FLOPs a
pair forward and 4 (d_qk + d_v) backward; ``moonlight_work.
attention_layers``), over the three kernels' device time in the traced
stretch. It reads only where each kernel ran once a layer a step and every
launch of each wrapper so far was at the split dims (its
``split_launches`` equal to its ``launches``: a program without that
counter gives none)."""

from harness import manifest, program

KERNELS = manifest.reader("attention_roofline").KERNELS


def _all_split():
    return all(getattr(program.counter(*w), "split_launches", -1)
               == program.counter(*w).launches for w in KERNELS.values())


def read(ctx):
    s, c, cfg, t = ctx.stretch, ctx.costs, ctx.config, ctx.traffic
    launches = s["records"]["steps"] * cfg["layers"]
    if launches == 0 or not _all_split() or any(
            not s["checked"][k] or s["kernels"][k][0] != launches
            for k in KERNELS):
        return None
    seconds = sum(s["kernels"][k][1] for k in KERNELS)
    bound = sum(c.bound_s(*fwd) + c.bound_s(*bwd) for fwd, bwd in
                manifest.reader("moonlight_work").attention_layers(
                    cfg, t["batch"], t["seq_len"]))
    return 100.0 * s["records"]["steps"] * bound / seconds
