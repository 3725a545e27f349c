"""Batch iteration: ``BatchIterator`` shuffles with a host-side numpy
permutation and yields ``Batch(inputs, targets)`` namedtuples, as the JAX
package's utils/data_iterator.py does. ``drop_last`` drops the ragged final
batch."""

from collections import namedtuple

import numpy as np

Batch = namedtuple("Batch", ["inputs", "targets"])


class BaseIterator:

    def __call__(self, inputs, targets):
        raise NotImplementedError


class BatchIterator(BaseIterator):

    def __init__(self, batch_size=32, shuffle=True, drop_last=False):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __call__(self, inputs, targets):
        n = len(inputs)
        perm = np.random.permutation(n) if self.shuffle else None
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            end = start + self.batch_size
            if perm is not None:
                idx = perm[start:end]
                yield Batch(inputs=inputs[idx], targets=targets[idx])
            else:
                yield Batch(inputs=inputs[start:end],
                            targets=targets[start:end])
