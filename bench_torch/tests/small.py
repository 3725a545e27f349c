"""Small stand-ins for the cells' configurations and traffic, for runs on
the CPU: each family's own cut (``families/<family>.py``'s ``small``)."""

from harness import manifest, program

BENCH = manifest.load()


def sizes(cell_name):
    """(config, traffic) of ``cell_name`` cut to a CPU test's size."""
    cell = manifest.cell(BENCH, cell_name)
    config = manifest.config(BENCH, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    return program.family(config).small(config, traffic)
