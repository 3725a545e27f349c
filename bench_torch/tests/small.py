"""Small stand-ins for the cells' configurations and traffic, for runs on
the CPU: the MLP at its own widths on fewer rows, the transformer at a
toy width."""

from harness import manifest

BENCH = manifest.load()


def sizes(cell_name):
    """(config, traffic) of ``cell_name`` cut to a CPU test's size."""
    cell = manifest.cell(BENCH, cell_name)
    config = manifest.config(BENCH, cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]))
    if config["family"] == "mlp":
        traffic["data"] = dict(traffic["data"], n_train=1024, n_test=512)
        traffic["warmup_units"] = 1
    else:
        config = dict(config, vocab=32, dim=32, heads=4)
        traffic.update(batch=4, seq_len=16 if traffic["seq_len"] > 256
                       else 8, warmup_units=1,
                       data={"kind": "random_tokens", "n_seq": 32})
    return config, traffic
