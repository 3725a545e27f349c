"""MNIST loading with an offline synthetic fallback, in numpy only.

``load_mnist`` reads mnielsen's ``mnist.pkl.gz`` from ``data_dir`` when it is
there, and otherwise returns a deterministic SYNTHETIC pseudo-MNIST: 10 fixed
class prototypes in 784-d with per-sample masking noise, the same shapes and
dtypes as the real task and learnable to >97.5% test accuracy. There is no
download path. ``synthetic_mnist`` gives byte-identical arrays to the JAX
package's for the same seed.
"""

import gzip
import hashlib
import os
import pickle

import numpy as np


def file_sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _validate_mnist(train, valid, test, path, strict_sizes=True):
    """Structural integrity check of the mnielsen pickle: the right splits,
    shapes, and [0, 1] pixel range, so a corrupt or wrong file fails loudly
    instead of producing a bogus 'real' number. ``strict_sizes=False``
    skips the exact 50k/10k/10k split-size check."""
    specs = [("train", train, 50000), ("valid", valid, 10000),
             ("test", test, 10000)]
    for name, (xs, ys), n in specs:
        xs, ys = np.asarray(xs), np.asarray(ys)
        want_n = n if strict_sizes else xs.shape[0]
        if xs.shape != (want_n, 784):
            raise ValueError(
                "%s: %s split has images %s, expected (%d, 784)"
                % (path, name, xs.shape, want_n))
        if ys.shape != (xs.shape[0],):
            raise ValueError(
                "%s: %s split has labels %s, expected (%d,)"
                % (path, name, ys.shape, xs.shape[0]))
        if not (0.0 <= float(xs.min()) and float(xs.max()) <= 1.0):
            raise ValueError(
                "%s: %s split pixel range [%g, %g] outside [0, 1]"
                % (path, name, xs.min(), xs.max()))
        if int(ys.min()) < 0 or int(ys.max()) > 9:
            raise ValueError(
                "%s: %s split labels outside 0..9" % (path, name))


def synthetic_mnist(n_train=50000, n_test=10000, num_classes=10, dim=784,
                    seed=31):
    """Deterministic learnable classification task shaped like MNIST."""
    rng = np.random.RandomState(seed)
    # overlapping sparse prototypes: a shared background pattern plus a
    # per-class sparse signature, so classes are NOT linearly trivial
    shared = (rng.rand(dim) > 0.8).astype(np.float32)
    signature = (rng.rand(num_classes, dim) > 0.9).astype(np.float32)
    prototypes = np.clip(shared[None, :] * 0.5 + signature * 0.38, 0, 1)

    def make(n, split_seed):
        r = np.random.RandomState(split_seed)
        labels = r.randint(0, num_classes, n)
        base = prototypes[labels]
        # heavy pixel dropout + additive noise near the signal scale:
        # solvable to ~99% but requires real optimization to get there
        keep = r.rand(n, dim) > 0.5
        noise = 0.85 * r.rand(n, dim).astype(np.float32)
        x = (base * keep + noise).clip(0.0, 1.0).astype(np.float32)
        return x, labels.astype(np.int64)

    return make(n_train, seed + 1), make(n_test, seed + 2)


def load_mnist(data_dir="./data", allow_synthetic=True, sha256=None,
               strict_sizes=True):
    """Returns ((train_x, train_y), (test_x, test_y)); x float32 [n, 784] in
    [0, 1], y int64 class indices. Real MNIST when ``mnist.pkl.gz`` is in
    ``data_dir``, synthetic otherwise (unless ``allow_synthetic=False``).

    A real file is always structurally validated and, when ``sha256`` is
    given, checksum-verified: a mismatch raises instead of silently training
    on the wrong bytes."""
    path = os.path.join(data_dir, "mnist.pkl.gz")
    if not os.path.exists(path):
        if not allow_synthetic:
            raise FileNotFoundError(path)
        print("No MNIST file at %s; using synthetic pseudo-MNIST." % path)
        return synthetic_mnist()
    if sha256:
        actual = file_sha256(path)
        if actual != sha256.lower():
            raise ValueError(
                "%s: sha256 %s does not match the pinned %s, refusing to "
                "load" % (path, actual, sha256))
    with gzip.open(path, "rb") as f:
        train, valid, test = pickle.load(f, encoding="latin1")
    _validate_mnist(train, valid, test, path, strict_sizes=strict_sizes)
    # fold validation into train like the reference's 50k/10k usage
    train_x = np.concatenate([train[0], valid[0]]).astype(np.float32)
    train_y = np.concatenate([train[1], valid[1]]).astype(np.int64)
    return (train_x, train_y), (test[0].astype(np.float32),
                                test[1].astype(np.int64))


def one_hot(labels, num_classes=10):
    return np.eye(num_classes, dtype=np.float32)[labels]
