"""``k1_roofline.transformer`` in the cell whose throughput is
``train_tokens_per_s.t256``: the same reading and kernels
(``k1_roofline.transformer.py``)."""

from harness import manifest

_SAME = manifest.reader("k1_roofline.transformer")
KERNELS = _SAME.KERNELS
read = _SAME.read
