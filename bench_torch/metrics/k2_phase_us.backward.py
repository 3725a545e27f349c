"""K2's backward phases (``backward l``), in us a step, from the kernel's
phase clock."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").k2_phase_us(
        lambda phase: phase.startswith("backward"))
