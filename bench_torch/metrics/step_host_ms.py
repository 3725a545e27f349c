"""The tape's step on the host: the mean of the program's ``tinynn.step``
span (``Model.train_step``: staging, then the forward, loss, backward and
update dispatched)."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").mean_ms("tinynn.step")
