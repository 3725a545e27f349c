"""How unevenly the sigmoid router loads the held experts: the busiest
held expert's tokens over the mean held expert's, per expert layer call,
from the program's counters over the traced stretch
(``moe.max_expert_tokens`` summed, over ``moe.routed_pairs`` summed and
shared among the held experts). 1 is an even load."""

from harness import manifest


def read(ctx):
    table = manifest.reader("program_totals").table()
    busiest, pairs = table.get("moe.max_expert_tokens"), \
        table.get("moe.routed_pairs")
    if not busiest or not pairs:
        return None
    return busiest / (pairs / ctx.config["experts_held"])
