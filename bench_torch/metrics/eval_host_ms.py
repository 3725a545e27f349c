"""The eval's host work outside its wait: the mean of the program's
``tinynn.eval`` span (``Model.evaluate_batch``) less the mean of its
``tinynn.eval.readback`` (the wait for the device and the copy)."""

from harness import manifest


def read(ctx):
    totals = manifest.reader("program_totals")
    whole, wait = totals.mean_ms("tinynn.eval"), \
        totals.mean_ms("tinynn.eval.readback")
    return None if whole is None or wait is None else whole - wait
