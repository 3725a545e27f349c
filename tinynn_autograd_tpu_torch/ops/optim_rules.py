"""The optimizer rules' table for the kernels that apply them in place:
``csrc/optim_rules.cuh``, included by the whole-epoch kernel (K2), the
weight-streaming backward (K3b) and the optimizer probe (P2).

- ``OPTIMIZERS``: the rules' codes of the kernels' C interface, in order
  (``Opt`` in the header).
- ``optimizer_constants``: an optimizer's code and its rule's constants as
  the header reads them.
"""

import numpy as np

OPTIMIZERS = ("SGD", "Adam", "Momentum", "Lion", "RMSProp", "Adagrad",
              "Adadelta")


def optimizer_constants(optimizer):
    """(code, (c0, c1, c2, c3)): the optimizer's code and its rule's
    constants as the kernels read them (``apply_rule`` in the header), as
    the f32 values the plain rule multiplies by."""
    o = optimizer
    consts = {
        "SGD": lambda: (),
        "Momentum": lambda: (o._momentum,),
        "Adam": lambda: (1.0 - o._b1, 1.0 - o._b2, o._eps),
        "Lion": lambda: (o._b1, 1.0 - o._b1, o._b2, 1.0 - o._b2),
        "RMSProp": lambda: (1.0 - o._decay, o._momentum, o._eps),
        "Adagrad": lambda: (o._eps,),
        "Adadelta": lambda: (1.0 - o._decay, o._eps),
    }[type(o).__name__]()
    return (OPTIMIZERS.index(type(o).__name__),
            tuple(float(np.float32(c)) for c in consts + (0.0,) * 4)[:4])
