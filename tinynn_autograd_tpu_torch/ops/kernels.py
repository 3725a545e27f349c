"""Hot-path compute kernels: a hand-written CUDA matmul on the GPU, its plain
PyTorch version on the CPU.

The FLOP sink of the framework is matmul: the forward of ``dot_`` and both of
its VJPs. On a CUDA device every float product of a 2-D operand by a 2-D
weight goes to the tiled kernel in ``csrc/matmul.cu`` (the counterpart of
the JAX package's Pallas ``_mm_kernel``); on the CPU it goes to
``matmul_reference``, the same arithmetic in plain PyTorch. An
``[..., m, k] @ [k, n]`` product (a Dense on a sequence) is the 2-D
product ``[(... m), k] @ [k, n]``, reshaped back. Products of two N-D
operands stay ``torch.matmul``.

Each product's launch follows a host-side plan, ``plan_matmul(m, n, k,
aligned=...)``: one of the kernel's tile configurations and a K-split (the
blocks of a thread block cluster that share an output tile), chosen so
that the product puts about a wave of blocks on the card's SMs. Four
configurations multiply on the CUDA cores; the fifth, for f32 operands
that ``tc_aligned`` admits, on the tensor cores in 3xTF32. The plan
weighs them by a cost model of what it sees: the sizes and whether the
operands' layout fits the tensor-core tile. It is plain Python, so the
CPU tests check it.

Dispatch policy
---------------
``matmul(a, b)``:
  - a 2-D float ``b`` and a float ``a`` of 2 or more dims on a CUDA device:
    ``cuda_matmul`` (the kernel). It launches or raises; nothing falls back
    to ``torch.matmul`` or to the CPU when the build, the launch or the
    device is missing.
  - the same on the CPU: ``matmul_reference``.
  - anything else: ``torch.matmul``, accumulating sub-32-bit floats in f32.

Every kernel of the package (``csrc/<name>.cu``) is compiled with ``nvcc`` at
first use into ``_build/`` beside this package, keyed by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, and loaded with ``ctypes``
(``build_library``/``load_library``). Nothing here imports ``ctypes`` or
calls ``nvcc`` when the module is imported.
"""

import functools
import hashlib
import os
import shutil
import subprocess
from collections import namedtuple
from pathlib import Path

import torch

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PACKAGE_DIR / "csrc"
MATMUL_SOURCE = CSRC_DIR / "matmul.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Matmul input precision: "f32" (default, exact reference parity) or "bf16"
# (cast float operands to bfloat16, accumulate in f32, return f32). Settable
# via env TINYNN_TPU_MATMUL_PRECISION or set_matmul_precision().
_MATMUL_PRECISION = os.environ.get("TINYNN_TPU_MATMUL_PRECISION", "f32")

# dtype codes of the kernel's C interface
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_loaded = {}  # kernel name -> its ctypes handle, once loaded


def set_matmul_precision(mode):
    """mode: "f32" | "bf16". Affects every later product."""
    global _MATMUL_PRECISION
    if mode not in ("f32", "bf16"):
        raise ValueError(mode)
    _MATMUL_PRECISION = mode


def matmul_precision():
    return _MATMUL_PRECISION


def _cast_inputs(a, b):
    if (_MATMUL_PRECISION == "bf16" and a.is_floating_point()
            and b.is_floating_point()):
        return a.to(torch.bfloat16), b.to(torch.bfloat16), torch.float32
    return a, b, None


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def matmul_reference(a, b):
    """The kernel's arithmetic in plain PyTorch: operands widened to (at
    least) f32, summed in f32, result in ``promote(a, b)``. Used for CPU
    tensors and by the tests; never as a fallback for CUDA tensors."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    acc = torch.promote_types(out_dtype, torch.float32)
    return torch.matmul(a.to(acc), b.to(acc)).to(out_dtype)


# --------------------------------------------------------------------------
# the plan of a launch
# --------------------------------------------------------------------------

MATMUL_BK = 16        # BK in csrc/matmul.cu: the depth of a stage
MATMUL_MAX_SPLIT = 8  # MAX_SPLIT: the portable cluster size
H100_SMS = 132

# The kernel's tile configurations (Small, Wide, Large, Large1 and the
# tensor-core tile in csrc/matmul.cu): (rows, columns) of a block's output
# tile, the blocks an SM holds at once, and the share of an SM's f32 FMA
# peak that 1, 2, ... co-resident blocks reach together. Measured on the
# H100 at config 8's and the eval's products (bench_matmul_plans.py): a
# block alone on an SM (8 warps) hides too little latency, but for Large1,
# whose registers are not cut to fit two blocks an SM. The tensor-core
# tile's share is above 1: 3xTF32 on the tensor cores outruns the FMA peak
# (1.1-1.3 at config 6b's block products). chip_smoke.py and
# bench_matmul_plans.py fail where the card holds other blocks an SM than
# these (matmul_occupancy).
MATMUL_TILES = ((64, 64, 3, (0.3, 0.37, 0.36)), (128, 64, 2, (0.3, 0.5)),
                (128, 128, 2, (0.3, 0.5)), (128, 128, 1, (0.55,)),
                (128, 128, 1, (1.25,)))
MATMUL_TC = 4      # the tensor-core tile's configuration
MATMUL_TC_BK = 32  # tc::BK in csrc/matmul.cu: its stages' depth
# A launch's row tiles run along grid y, at most 65535 of them: a product
# of more than 65535 of the smallest tile's 64 rows (a Dense over more than
# 4.19M folded tokens) is launched once for each run of that many rows
MATMUL_MAX_ROWS = 65535 * 64

# Clusters of more than this many blocks only for launches of at most
# MATMUL_WIDE_CLUSTER_BLOCKS blocks: on the H100 clusters of 7 and 8 ran
# slower than clusters of 6 at config 8's long-K products (96-256 blocks),
# and faster at the flagship's narrow ones (8-56 blocks; bench_matmul_
# plans.py).
MATMUL_WIDE_CLUSTER = 6
MATMUL_WIDE_CLUSTER_BLOCKS = 64

# The plan's cost model, in microseconds of one block on one SM: an SM's
# share of the H100's f32 FMA peak (67 TFLOP/s over 132 SMs, in
# multiply-adds a microsecond), the latency before a block's first FMA (its
# first loads; the tensor-core tile's deeper stages and larger epilogue
# take longer), and a split's cluster barriers and its reads of the other
# blocks' partial tiles through distributed shared memory (bytes a
# microsecond). Estimates, for ranking plans.
_FMA_PER_US = 67e12 / 2 / H100_SMS / 1e6
_FIRST_LOAD_US = 1.5
_TC_FIRST_LOAD_US = 3.0
_CLUSTER_SYNC_US = 0.5
_DSMEM_BYTES_PER_US = 100e3

MatmulPlan = namedtuple("MatmulPlan", "config bm bn split k_chunk")


def _k_slices(k, split, bk=MATMUL_BK):
    """(the slices K is cut into, each slice's length): slices of whole
    stages of ``bk``, every one non-empty, at most ``split`` of them."""
    per_slice = -(-k // split)
    chunk = -(-per_slice // bk) * bk
    return -(-k // chunk), chunk


def _tc_readable(ptr, s_rows, s_k):
    return ptr % 16 == 0 and ((s_k == 1 and s_rows % 4 == 0)
                              or (s_rows == 1 and s_k % 4 == 0))


def tc_aligned(a, b):
    """Whether the tensor-core tile can read ``a`` [m, k] @ ``b`` [k, n]:
    both f32, each with a unit stride along K or along its rows (A's m,
    B's n), the other stride a multiple of 4 elements, and a 16-byte
    aligned start, so that every row it reads is read 16 bytes at a time.
    The rule of ``tc_unit`` in csrc/matmul.cu."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return False
    (sa_m, sa_k), (sb_k, sb_n) = a.stride(), b.stride()
    return (_tc_readable(a.data_ptr(), sa_m, sa_k)
            and _tc_readable(b.data_ptr(), sb_n, sb_k))


@functools.lru_cache(maxsize=4096)
def plan_matmul(m, n, k, sms=H100_SMS, aligned=False):
    """The launch of one [m, k] @ [k, n] product: a ``MatmulPlan`` of the
    tile configuration (its index and its bm x bn output tile), the K-split
    (the blocks of a cluster that share a tile, each a slice of ``k_chunk``
    of K) and the slice length. ``aligned``: the operands fit the
    tensor-core tile (``tc_aligned``); without it the plan keeps to the
    CUDA-core tiles. Among the configurations and the splits of 1 to 8 it
    takes the least modelled time: the launch's waves of blocks over
    ``sms`` SMs, in each the most blocks an SM runs at once times a block's
    multiply-adds at the share of the SM's peak that many reach, after the
    latency of the first loads, plus the split's reduction. A split is
    tried only while the next smaller one leaves room on the SMs, so a
    product whose tiles fill the card is never split, and clusters past
    ``MATMUL_WIDE_CLUSTER`` blocks only in small launches; ties go to fewer
    splits, then to larger tiles."""
    if min(m, n, k) < 1:
        raise ValueError("plan_matmul needs positive sizes, got %d x %d x %d"
                         % (m, n, k))
    best = None
    for config, (bm, bn, per_sm, shares) in enumerate(MATMUL_TILES):
        tensor_cores = config == MATMUL_TC
        if tensor_cores and not aligned:
            continue
        bk, first_load = ((MATMUL_TC_BK, _TC_FIRST_LOAD_US) if tensor_cores
                          else (MATMUL_BK, _FIRST_LOAD_US))
        tiles = -(-m // bm) * -(-n // bn)
        for split in range(1, MATMUL_MAX_SPLIT + 1):
            if tiles * (split - 1) >= sms * per_sm or (
                    split > MATMUL_WIDE_CLUSTER
                    and tiles * split > MATMUL_WIDE_CLUSTER_BLOCKS):
                break
            slices, chunk = _k_slices(k, split, bk)
            if slices == split:
                us, left = 0.0, tiles * split
                while left > 0:
                    wave = min(left, sms * per_sm)
                    at_once = -(-wave // sms)
                    us += (at_once * bm * bn * chunk
                           / (shares[at_once - 1] * _FMA_PER_US)
                           + first_load)
                    left -= wave
                if split > 1:
                    us += _CLUSTER_SYNC_US + 4 * bm * bn / _DSMEM_BYTES_PER_US
                key = (round(us, 6), split, -bm * bn)
                if best is None or key < best[0]:
                    best = (key, MatmulPlan(config, bm, bn, split, chunk))
    return best[1]


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

def nvcc_command(nvcc, source, output):
    """The compile line: a shared library with a plain C interface, for
    Hopper's ``sm_90a`` target."""
    return [str(nvcc), *NVCC_FLAGS, "-o", str(output), str(source)]


def _find_nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels cannot be built")


def build_library(name):
    """Compile ``csrc/<name>.cu`` unless a library built from the same
    source, the same shared headers and flags is already in ``_build/``.
    Returns ``(path, compiler_log)``; the log is empty when nothing was
    compiled. Raises with nvcc's stderr when the compile fails."""
    source_path = CSRC_DIR / ("%s.cu" % name)
    source = source_path.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    tag = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / ("libtinynn_%s_%s.so" % (name, tag[:16]))
    if out.exists():
        return out, ""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = BUILD_DIR / ("%s.%d.tmp" % (out.name, os.getpid()))
    proc = subprocess.run(nvcc_command(nvcc, source_path, tmp),
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed (exit %d) building %s:\n%s"
                           % (proc.returncode, source_path, proc.stderr))
    os.replace(tmp, out)
    return out, proc.stderr


def build_matmul():
    """``build_library("matmul")``: the K1 matmul kernel."""
    return build_library("matmul")


def load_library(name, bind):
    """The ctypes handle of ``csrc/<name>.cu``, built and loaded at first
    use; ``bind(lib, ctypes)`` declares its functions' argument types."""
    lib = _loaded.get(name)
    if lib is None:
        import ctypes

        path, _ = build_library(name)
        lib = ctypes.CDLL(str(path))
        bind(lib, ctypes)
        _loaded[name] = lib
    return lib


def _bind_matmul(lib, ctypes):
    lib.tinynn_matmul.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.tinynn_matmul.restype = ctypes.c_int
    lib.tinynn_matmul_occupancy.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.tinynn_matmul_occupancy.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def matmul_occupancy(config, split):
    """(blocks an SM holds, clusters of ``split`` blocks the card holds) of
    tile configuration ``config``'s f32 kernel on the current CUDA
    device."""
    import ctypes

    lib = load_library("matmul", _bind_matmul)
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.tinynn_matmul_occupancy(config, split, ctypes.byref(per_sm),
                                      ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError("occupancy query failed: CUDA error %d" % err)
    return per_sm.value, clusters.value


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def cuda_matmul(a, b, plan=None):
    """C = A @ B on the GPU through the hand-written kernel.

    ``a`` [M, K] and ``b`` [K, N] are CUDA tensors of float32 or bfloat16 on
    one device, in any strided layout (transposed views are read in place).
    Returns a new contiguous [M, N] tensor in ``promote(a, b)``, launched as
    ``plan`` says (default ``plan_matmul`` for the device's SM count and
    the operands' layout); a product of more than ``MATMUL_MAX_ROWS`` rows
    launches once for each run of rows (``matmul_row_runs``). Raises on
    anything the kernel does not take; never computes the product another
    way. ``cuda_matmul.launches``
    counts the launches, ``cuda_matmul.tc_launches`` those on the
    tensor-core tile."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("cuda_matmul needs CUDA tensors, got %s and %s"
                         % (a.device, b.device))
    index = a.get_device()
    if b.get_device() != index:
        raise ValueError("operands on different devices: %s and %s"
                         % (a.device, b.device))
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("cuda_matmul needs [M,K] @ [K,N], got %s @ %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.dtype not in _KERNEL_DTYPES or b.dtype not in _KERNEL_DTYPES:
        raise TypeError("cuda_matmul takes float32/bfloat16, got %s and %s"
                        % (a.dtype, b.dtype))
    m, k = a.shape
    n = b.shape[1]
    if max(n, k) >= 2 ** 31:
        raise ValueError("shape %s @ %s exceeds the kernel's 32-bit sizes"
                         % (tuple(a.shape), tuple(b.shape)))
    out = torch.empty((m, n), dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = load_library("matmul", _bind_matmul)
    # the current stream's raw handle: torch.cuda.current_stream builds a
    # Stream object, 9 of this wrapper's 26 us a call on the H100's host,
    # where a 6b step makes 39 calls
    stream = torch._C._cuda_getCurrentRawStream(index)
    if m <= MATMUL_MAX_ROWS:
        _launch_matmul(lib, a, b, out, plan, index, stream)
    else:
        for r0, r1 in matmul_row_runs(m):
            _launch_matmul(lib, a[r0:r1], b, out[r0:r1], plan, index, stream)
    return out


def matmul_row_runs(m):
    """The (first, end) rows of each launch of an ``m``-row product: runs
    of ``MATMUL_MAX_ROWS``, the last one shorter. A run starts on a
    multiple of 64 rows, so a run of rows is as aligned as the whole."""
    return [(r0, min(r0 + MATMUL_MAX_ROWS, m))
            for r0 in range(0, m, MATMUL_MAX_ROWS)]


def _launch_matmul(lib, a, b, out, plan, index, stream):
    """One launch of K1 for ``out`` = ``a`` @ ``b`` (``out`` contiguous
    rows), as ``plan`` says or as ``plan_matmul`` plans it."""
    (m, k), n = a.shape, b.shape[1]
    if plan is None:
        plan = plan_matmul(m, n, k, _sm_count(index), tc_aligned(a, b))
    (sa_m, sa_k), (sb_k, sb_n) = a.stride(), b.stride()
    err = lib.tinynn_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, sa_m, sa_k,
        sb_k, sb_n, _KERNEL_DTYPES[a.dtype], _KERNEL_DTYPES[b.dtype],
        plan.config, plan.split, plan.k_chunk, stream)
    if err != 0:
        raise RuntimeError("matmul kernel launch failed: CUDA error %d" % err)
    cuda_matmul.launches += 1
    if plan.config == MATMUL_TC:
        cuda_matmul.tc_launches += 1


cuda_matmul.launches = 0
cuda_matmul.tc_launches = 0


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _acc_type(a, b):
    out = torch.promote_types(a.dtype, b.dtype)
    if out in (torch.bfloat16, torch.float16):
        return torch.float32
    return None


def matmul(a, b):
    """Device-dispatching matmul used by the ``dot_`` primitive and its VJPs.
    Semantics are numpy.matmul (f32 accumulation always). An N-D ``a`` times
    a 2-D ``b`` is one 2-D product over ``a``'s rows folded together (a view
    where its leading dims allow one)."""
    a, b, forced_out = _cast_inputs(a, b)
    if (a.ndim >= 2 and b.ndim == 2 and a.is_floating_point()
            and b.is_floating_point()):
        rows = a.reshape(-1, a.shape[-1])
        if a.is_cuda or b.is_cuda:
            out = cuda_matmul(rows, b)
        else:
            out = matmul_reference(rows, b)
        out = out.reshape(*a.shape[:-1], b.shape[1])
        return out if forced_out is None else out.to(forced_out)
    out_t = forced_out if forced_out is not None else _acc_type(a, b)
    if out_t is None:
        return torch.matmul(a, b)
    return torch.matmul(a.to(out_t), b.to(out_t))
