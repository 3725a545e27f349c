"""The 95th percentile of the window's train steps, each between the CUDA
events recorded at its boundaries (an epoch's first from the event after
its shuffle), with no synchronisation added."""

import statistics


def read(ctx):
    times = ctx.window["step_ms"]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
