"""The dropout pass (P1): inverted dropout's forward from a counter hash.

PyTorch counterpart of the JAX package's dropout under its megakernel in
interpret mode (``_hash_bits_u32`` and ``dropout_``'s ``("pltpu_seed", s,
True)`` branch, ops/primitives.py): each element's 32 random bits are the
murmur3 finalizer of ``flat_index + seed * 2654435761`` mod 2**32, over the
row-major flat index of the tensor dropout sees; the element is kept where
its bits are below ``int((1 - rate) * (2**32 - 1))`` and scaled by
``1 / (1 - rate)``. The same hash runs inside K2 (``csrc/hash.cuh``), so
the step loop, K2 and the JAX megakernel draw the same masks.

- ``dropout_reference``: the plain PyTorch version (int64 arithmetic masked
  to 32 bits). For CPU tensors and the tests.
- ``cuda_dropout``: the kernel's wrapper (``csrc/dropout.cu``). It launches
  or raises, never falls back; ``cuda_dropout.launches`` counts launches.
- ``dropout_forward``: the one the ``dropout_`` primitive calls: the kernel
  for a CUDA tensor, the plain version for a CPU tensor.
"""

import numpy as np
import torch

from tinynn_autograd_tpu_torch.ops import kernels
from tinynn_autograd_tpu_torch.ops.attention import (
    _GOLDEN, _M32, _finalize, _mul32,
)

SOURCE = kernels.CSRC_DIR / "dropout.cu"
MAX_ELEMENTS = 2 ** 32  # the flat index is a uint32
SEED_STRIDE = 1000003  # the seeds of one step's layers (nn/net.py)


def layer_seed(t, idx):
    """The uint32 seed of the seeded layer at position ``idx`` in the step
    whose counter is ``t``: ``t * 1000003 + idx`` mod 2**32 (csrc/hash.cuh's
    ``layer_seed``)."""
    return (int(t) * SEED_STRIDE + int(idx)) & _M32


def keep_scale(rate):
    """(threshold, scale): the keep test's uint32 threshold and the f32
    scale of the survivors, as the JAX package computes them."""
    if not 0.0 <= rate < 1.0:
        raise ValueError("dropout rate must be in [0, 1), got %r" % (rate,))
    keep = 1.0 - rate
    return int(keep * (2 ** 32 - 1)), float(np.float32(1.0 / keep))


def hash_bits(n, seed, device=None):
    """The uint32 bits of flat indices 0..n-1 as an int64 tensor [n]."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    return _finalize((x + _mul32(int(seed) & _M32, _GOLDEN)) & _M32)


def dropout_reference(x, rate, seed):
    """(out, mask): ``out = where(mask, x * scale, 0)`` with the hash's keep
    mask (bool, ``x``'s shape) over ``x``'s row-major flat index."""
    threshold, scale = keep_scale(rate)
    mask = (hash_bits(x.numel(), seed, x.device) < threshold).reshape(x.shape)
    return torch.where(mask, x * scale, 0.0), mask


def _bind(lib, ctypes):
    ptr = ctypes.c_void_p
    lib.tinynn_dropout.argtypes = [ptr] * 3 + [
        ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ptr]
    lib.tinynn_dropout.restype = ctypes.c_int


def cuda_dropout(x, rate, seed):
    """``dropout_reference``'s function through the hand-written kernel, one
    launch: ``(out, mask)`` with a uint8 mask (1 where kept). ``x`` is a
    contiguous float32 CUDA tensor of at most 2**32 elements. Raises on
    anything the kernel does not take and when the launch fails; never
    computes the pass another way."""
    if x.device.type != "cuda":
        raise ValueError("cuda_dropout needs a CUDA tensor, got %s" % x.device)
    if x.dtype != torch.float32:
        raise TypeError("cuda_dropout takes float32, got %s" % x.dtype)
    if not x.is_contiguous():
        raise ValueError("cuda_dropout needs a contiguous tensor")
    if not 0 < x.numel() <= MAX_ELEMENTS:
        raise ValueError("%d elements: the kernel takes 1 to 2**32"
                         % x.numel())
    threshold, scale = keep_scale(rate)
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    lib = kernels.load_library("dropout", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tinynn_dropout(x.data_ptr(), out.data_ptr(),
                                 mask.data_ptr(), x.numel(),
                                 int(seed) & _M32, threshold, scale, stream)
    if err != 0:
        raise RuntimeError("dropout kernel launch failed: CUDA error %d" % err)
    cuda_dropout.launches += 1
    return out, mask


cuda_dropout.launches = 0


def dropout_forward(x, rate, seed):
    """(out, bool mask) of ``x`` (made contiguous): the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    x = x.contiguous()
    if x.device.type == "cpu":
        return dropout_reference(x, rate, seed)
    out, mask = cuda_dropout(x, rate, seed)
    return out, mask.view(torch.bool)
