"""Parameter trees between the two packages.

A parameter tree is a list with one dict per layer, mapping parameter names
to arrays (``Net.params_tree()`` in both packages; activation layers give an
empty dict). The JAX package's tree holds ``jax.Array``s or numpy arrays;
this package's holds torch tensors.
"""

import numpy as np

from tinynn_autograd_tpu_torch.core.tensor import to_torch


def params_from_jax(tree, device):
    """The JAX package's ``params_tree()`` (or its numpy copy) as this
    package's tree, on ``device``. Every array is copied."""
    return [{k: to_torch(np.asarray(v)).to(device) for k, v in layer.items()}
            for layer in tree]


def params_to_numpy(tree):
    """A tree of torch tensors as host numpy arrays (the checkpoint format
    both packages read)."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in tree]
