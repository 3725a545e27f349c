"""The optimizer-only megakernel probe (P2): K2's structure with nothing but
the optimizer's update in it.

PyTorch counterpart of the JAX package's ``bench_mega_probe.py`` probe, which
measures the irreducible in-kernel optimizer cost of a K2 step: ``n_steps``
steps in one launch, each applying only the per-leaf rule to the flagship's
leaves with a fake gradient ``g = 1e-3 p`` (one elementwise pass, the same
for every optimizer, so the differences between optimizers isolate the slot
math and traffic). Step ``i`` uses the scalars of step ``t = t0 + i``.

- ``mega_probe_reference``: the plain PyTorch version, the optimizer's own
  ``rule``. For CPU tensors and the tests.
- ``cuda_mega_probe``: the kernel's wrapper (``csrc/mega_probe.cu``). It
  launches or raises, never falls back; ``cuda_mega_probe.launches`` counts
  its launches.
"""

import torch

from tinynn_autograd_tpu_torch.ops import kernels

SOURCE = kernels.CSRC_DIR / "mega_probe.cu"
MAX_LEAVES = 32  # MAX_LEAVES in csrc/mega_probe.cu
# the flagship MNIST MLP's leaves (784-200-100-70-30-10 Dense w + b)
LEAF_SHAPES = [(784, 200), (1, 200), (200, 100), (1, 100),
               (100, 70), (1, 70), (70, 30), (1, 30), (30, 10), (1, 10)]


def mega_probe_reference(optimizer, params, slots, t0, n_steps):
    """The probe in plain PyTorch: ``params`` (a list of leaves) and
    ``slots`` ({name: list of leaves}) updated in place over ``n_steps``
    steps of ``p += rule(1e-3 * p)`` at step t's scalars, t = t0 + i (the
    rule alone: no weight decay, as in the JAX probe)."""
    for i in range(n_steps):
        scalars = optimizer.scalars_at(t0 + i)
        for j, p in enumerate(params):
            p.add_(optimizer.rule(
                p * 1e-3, scalars,
                {name: slots[name][j] for name in optimizer.slot_names}))


def _bind(lib, ctypes):
    ptr = ctypes.c_void_p
    lib.tinynn_mega_probe.argtypes = (
        [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.POINTER(ptr)] * 3 + [ptr, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 5 + [ptr])
    lib.tinynn_mega_probe.restype = ctypes.c_int


def cuda_mega_probe(optimizer, params, slots, t0, n_steps):
    """``mega_probe_reference``'s function through the hand-written kernel:
    one cooperative launch of ``n_steps`` steps. Every leaf is a contiguous
    float32 CUDA tensor on one device. Raises on anything the kernel does
    not take and when the launch fails; never computes the probe another
    way."""
    names = optimizer.slot_names
    if not 1 <= len(params) <= MAX_LEAVES:
        raise ValueError("%d leaves; the kernel takes 1 to %d"
                         % (len(params), MAX_LEAVES))
    if set(slots) != set(names) or any(len(slots[n]) != len(params)
                                       for n in names):
        raise ValueError("slots %s, the optimizer has %s for %d leaves"
                         % (sorted(slots), list(names), len(params)))
    device = params[0].device
    if device.type != "cuda":
        raise ValueError("cuda_mega_probe needs CUDA tensors, got %s" % device)
    for j, p in enumerate(params):
        for t in [p] + [slots[n][j] for n in names]:
            if (t.device != device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.shape != p.shape):
                raise ValueError("leaf %d: every leaf and slot must be a "
                                 "contiguous float32 tensor of one shape on "
                                 "%s" % (j, device))
    if not 0 < n_steps < 2 ** 31:
        raise ValueError("%d steps are out of range" % n_steps)
    import ctypes

    code, consts = optimizer.kernel_rule()
    # the scalars of steps t0 ... t0 + n_steps - 1
    scalars = torch.from_numpy(optimizer.step_scalars(t0 - 1, n_steps)).to(
        device)
    n = len(params)

    def pointers(tensors):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors])

    slot_ptrs = [pointers(slots[name]) for name in names]
    slot_ptrs += [(ctypes.c_void_p * n)()] * (2 - len(names))
    lib = kernels.load_library("mega_probe", _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tinynn_mega_probe(
            n, (ctypes.c_longlong * n)(*[p.numel() for p in params]),
            pointers(params), *slot_ptrs, scalars.data_ptr(), n_steps, code,
            *consts, 0.0, stream)
    if err != 0:
        raise RuntimeError("mega probe kernel launch failed: CUDA error %d"
                           % err)
    cuda_mega_probe.launches += 1


cuda_mega_probe.launches = 0
