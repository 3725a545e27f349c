"""Global seeding: numpy's RNG plus one explicit ``torch.Generator``.

``random_seed`` seeds numpy (host-side shuffling) and replaces the module's
CPU ``torch.Generator``, from which the initializers draw. Draws happen on
that CPU generator and are moved to the device afterwards, so one seed gives
the same initial weights on the CPU and on the GPU.
"""

import contextlib

import numpy as np
import torch

_MAX_SEED = 2 ** 32

_state = {"generator": None}


def random_seed(seed):
    """Seed numpy and the global generator. Valid range [0, 2**32)."""
    if not (0 <= seed < _MAX_SEED):
        raise ValueError("Seed must be between 0 and 2**32 - 1, got %s" % seed)
    np.random.seed(seed)
    _state["generator"] = torch.Generator().manual_seed(seed)


def generator():
    """The current CPU generator (the scope's, else the global one).

    Auto-seeds from numpy's RNG if ``random_seed`` was never called, so
    unseeded runs are still random but a prior ``np.random.seed`` makes
    them reproducible."""
    if _state["generator"] is None:
        _state["generator"] = torch.Generator().manual_seed(
            int(np.random.randint(0, 2 ** 31)))
    return _state["generator"]


@contextlib.contextmanager
def scope(seed):
    """Temporarily replace the global generator with a DEDICATED one.

    Draws inside the scope come from a generator seeded with ``seed`` (or
    the given ``torch.Generator``) and do NOT advance the global stream, so
    parameter initialization can be pinned independently of global draw
    order::

        with seeder.scope(7):
            net = build_mnist_mlp()

    ``Dense(seed=...)`` wraps its own parameter draws in this scope.
    """
    prev = _state["generator"]
    _state["generator"] = (torch.Generator().manual_seed(int(seed))
                           if isinstance(seed, (int, np.integer)) else seed)
    try:
        yield
    finally:
        _state["generator"] = prev
