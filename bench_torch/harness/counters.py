"""Launch counters that the program keeps as plain integers beside a
kernel wrapper's ``.launches``, each as an object with ``.launches`` that
``trace.profile_stretch`` holds a kernel name's traced count to. A
metric's ``KERNELS`` names one as ``("harness.counters", <name>)``. Each
reads the program through ``program.counter``, and reads 0 where the
program has no such counter.

TODO: let ``trace.profile_stretch`` take such counters by name through
``program``, or count a kernel name from the trace alone; this module then
goes.
"""

from harness import program


class _Counter:
    """``<module>.<wrapper>.<attr>`` of the program as ``.launches``."""

    def __init__(self, module, wrapper, attr):
        self._wrapper = (module, wrapper)
        self._attr = attr

    @property
    def launches(self):
        return getattr(program.counter(*self._wrapper), self._attr, 0)


# K1's launches on its tensor-core tile
matmul_tc = _Counter("tinynn_autograd_tpu_torch.ops.kernels", "cuda_matmul",
                     "tc_launches")
