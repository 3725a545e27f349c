"""The expert layers' forward on the host: the mean of the program's
``tinynn.moe`` span (``TokenChoiceMoE.forward``: the norm, the routing,
the dispatch with its one read-back of the experts' counts, which waits
for the device, the experts' launches and the combine)."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").mean_ms("tinynn.moe")
