"""Not a metric: what the readers of the program's own spans and counters
share. The program's table (``totals`` of
``tinynn_autograd_tpu_torch.utils.profiler``) holds what its spans and
counters recorded while the traced stretch ran under the profiler, over
every try of the stretch: a mean per occurrence, or per step, reads the
same however many tries it took. A program without that module, or a
table without the name, gives None."""

from harness import program


def table():
    try:
        totals = program.counter("tinynn_autograd_tpu_torch.utils.profiler",
                                 "totals")
    except ImportError:
        return {}
    return totals()


def mean_ms(name):
    """Span ``name``'s total ns over its count, in ms."""
    row = table().get(name)
    return row["ns"] / row["count"] * 1e-6 if row and row["count"] else None


def k2_phase_us(pick):
    """K2's in-kernel time a step, in us, over the phases whose names
    ``pick`` takes (``fused_epoch.phase_names``): block 0's clock,
    barrier waits included, summed over the stretch's launches, over the
    steps they ran."""
    t = table()
    phases, steps = t.get("k2.phase_ns"), t.get("k2.steps")
    if not phases or not steps:
        return None
    return sum(ns for name, ns in phases.items() if pick(name)) / steps * 1e-3
