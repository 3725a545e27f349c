"""K2's ``optimizer`` phase, with its ``clip norm`` phase where the
optimizer clips, in us a step, from the kernel's phase clock."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").k2_phase_us(
        lambda phase: phase in ("optimizer", "clip norm"))
