"""The ring all-reduce (P3): n ranks that share one device each sum the n
buffers in the JAX package's ring order.

PyTorch counterpart of the ring kernel of ``tests/test_dp_megakernel.py``
(``allreduce``), whose device code is also the data-parallel megakernel's
gradient exchange (K6, ``grad_ring_all_reduce`` in the JAX package's
ops/fused_epoch.py). Rank r's sum is ``((x_r + x_{r-1}) + x_{r-2}) + ...``
(indices mod n), rounded after every add: each rank gets the same total in
its own order, so ranks can differ in the last bit.

- ``ring_all_reduce_reference``: the plain PyTorch version, the same adds
  in the same order, so the kernel and it agree bit for bit.
- ``cuda_ring_all_reduce``: the wrapper of the hand-written kernel
  (``csrc/ring_allreduce.cu`` with ``csrc/ring.cuh``, one cooperative
  launch in which each rank is a group of blocks: one all-rank arrival,
  then one pass that reads every rank's input in the ring's order). It
  launches or raises, never falls back; ``cuda_ring_all_reduce.launches``
  counts its launches. Its arrival counts live on the device across calls
  (one set per device and stream), so a call is one launch.
- ``ring_all_reduce``: the kernel for CUDA tensors, the plain version for
  CPU tensors.
"""

import torch

from tinynn_autograd_tpu_torch.ops import kernels

SOURCE = kernels.CSRC_DIR / "ring_allreduce.cu"
MAX_RANKS = 16  # MAX_RANKS in csrc/ring_allreduce.cu
SYNC_WORDS = 2  # kSyncWords in csrc/ring.cuh: a rank's counts


def ring_order(n, rank):
    """The ranks whose values rank ``rank`` adds, in order."""
    return [(rank - k) % n for k in range(n)]


def ring_all_reduce_reference(xs):
    """Each rank's sum round the ring: a list of new tensors, one per rank
    of ``xs``, ``xs[r] + xs[r-1] + ...`` in that order."""
    n = len(xs)
    out = []
    for r in range(n):
        order = ring_order(n, r)
        acc = xs[order[0]].clone()
        for j in order[1:]:
            acc = acc + xs[j]
        out.append(acc)
    return out


def _bind(lib, ctypes):
    ptr = ctypes.c_void_p
    lib.tinynn_ring_all_reduce.argtypes = [
        ctypes.c_int, ctypes.POINTER(ptr), ctypes.POINTER(ptr),
        ctypes.c_longlong, ptr, ctypes.POINTER(ctypes.c_uint), ctypes.c_int,
        ctypes.c_longlong, ptr]
    lib.tinynn_ring_all_reduce.restype = ctypes.c_int


def _check_ranks(xs):
    if not 1 <= len(xs) <= MAX_RANKS:
        raise ValueError("%d ranks: the kernel takes 1 to %d"
                         % (len(xs), MAX_RANKS))
    first = xs[0]
    for r, x in enumerate(xs):
        if x.device.type != "cuda":
            raise ValueError("cuda_ring_all_reduce needs CUDA tensors, got "
                             "%s" % x.device)
        if x.device != first.device:
            raise ValueError("rank %d is on %s, rank 0 on %s: the ranks "
                             "share one device" % (r, x.device, first.device))
        if x.dtype != torch.float32:
            raise TypeError("rank %d is %s; the kernel takes float32"
                            % (r, x.dtype))
        if x.shape != first.shape:
            raise ValueError("rank %d has shape %s, rank 0 %s"
                             % (r, tuple(x.shape), tuple(first.shape)))
        if not x.is_contiguous():
            raise ValueError("rank %d is not contiguous" % r)
    if first.numel() == 0:
        raise ValueError("nothing to sum: the buffers are empty")


# (device, stream) -> (counts, each rank's published count): the kernel's
# arrival counts, zeroed once and kept across calls; a call adds 1 to the
# count of each of its ranks
_counts = {}


def _counts_for(device, stream):
    key = (device, stream)
    if key not in _counts:
        _counts[key] = (torch.zeros(MAX_RANKS * SYNC_WORDS, dtype=torch.int32,
                                    device=device), [0] * MAX_RANKS)
    return _counts[key]


def cuda_ring_all_reduce(xs, skew=None):
    """``ring_all_reduce_reference``'s function through the hand-written
    kernel, one launch: ``xs`` are the ranks' contiguous float32 buffers,
    of one shape, on one CUDA device. ``skew`` = (rank, microseconds) holds
    that rank back before its arrival, a check that the result does not
    depend on the ranks running in step. Raises on anything the kernel does
    not take and when the launch fails; never sums another way."""
    _check_ranks(xs)
    if skew is not None and not 0 <= skew[0] < len(xs):
        raise ValueError("skew rank %d of %d ranks" % (skew[0], len(xs)))
    import ctypes

    n, device, length = len(xs), xs[0].device, xs[0].numel()
    # rows of whole float4s, so that every rank's output is 16-byte aligned
    # and the pass stores four floats at a time
    out = torch.empty((n, -(-length // 4) * 4), dtype=torch.float32,
                      device=device)
    skew_rank, skew_us = (-1, 0) if skew is None else skew
    ptr_array = ctypes.c_void_p * n
    lib = kernels.load_library("ring_allreduce", _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        counts = _counts_for(device, stream)
        err = lib.tinynn_ring_all_reduce(
            n, ptr_array(*[x.data_ptr() for x in xs]),
            ptr_array(*[o.data_ptr() for o in out]), length,
            counts[0].data_ptr(), (ctypes.c_uint * n)(*counts[1][:n]),
            int(skew_rank),
            int(1000 * skew_us), stream)
    if err == 801:  # cudaErrorNotSupported
        raise RuntimeError("the device cannot launch cooperative kernels")
    if err != 0:
        raise RuntimeError("ring all-reduce kernel launch failed: CUDA error "
                           "%d" % err)
    for r in range(n):
        counts[1][r] = (counts[1][r] + 1) & 0xFFFFFFFF
    cuda_ring_all_reduce.launches += 1
    return [row[:length].view(xs[0].shape) for row in out.unbind(0)]


cuda_ring_all_reduce.launches = 0


def ring_all_reduce(xs):
    """Each rank's sum round the ring (a list, one tensor per rank): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if xs and all(x.device.type == "cpu" for x in xs):
        return ring_all_reduce_reference(xs)
    return cuda_ring_all_reduce(xs)
