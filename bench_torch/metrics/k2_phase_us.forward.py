"""K2's forward phases (``forward l``) and its ``loss`` phase, in us a
step, from the kernel's phase clock."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").k2_phase_us(
        lambda phase: phase.startswith("forward") or phase == "loss")
