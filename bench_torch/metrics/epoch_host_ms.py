"""The host's time an epoch before K2 is queued: the mean of the
program's ``tinynn.epoch`` span (``Model.train_epochs``: the tier choice,
the on-device shuffle's dispatch, K2's scalars, plan and launch)."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").mean_ms("tinynn.epoch")
