"""``mfu.transformer`` in the cell whose throughput is
``train_tokens_per_s.t256``: the same reading (``mfu.transformer.py``)."""

from harness import manifest

read = manifest.reader("mfu.transformer").read
