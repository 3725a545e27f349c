"""The 95th percentile of the window's evaluations, each the span of the
host's call from ``Model.evaluate_batch`` to the accuracy returned on the
host. The call starts on an idle device and ends with a read-back, so its
span is read between CUDA events recorded around it, to the device
clock's resolution."""

import statistics


def read(ctx):
    times = ctx.window["eval_ms"]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
