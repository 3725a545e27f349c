"""Hot-path compute kernels: a hand-written CUDA matmul on the GPU, its plain
PyTorch version on the CPU.

The FLOP sink of the framework is matmul: the forward of ``dot_`` and both of
its VJPs. On a CUDA device every 2-D float product goes to the tiled kernel in
``csrc/matmul.cu`` (the counterpart of the JAX package's Pallas
``_mm_kernel``); on the CPU it goes to ``matmul_reference``, the same
arithmetic in plain PyTorch. Products that are not 2-D stay ``torch.matmul``.

Dispatch policy
---------------
``matmul(a, b)``:
  - both operands 2-D floats on a CUDA device: ``cuda_matmul`` (the kernel).
    It launches or raises; nothing falls back to ``torch.matmul`` or to the
    CPU when the build, the launch or the device is missing.
  - both operands 2-D floats on the CPU: ``matmul_reference``.
  - anything else: ``torch.matmul``, accumulating sub-32-bit floats in f32.

Every kernel of the package (``csrc/<name>.cu``) is compiled with ``nvcc`` at
first use into ``_build/`` beside this package, keyed by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, and loaded with ``ctypes``
(``build_library``/``load_library``). Nothing here imports ``ctypes`` or
calls ``nvcc`` when the module is imported.
"""

import hashlib
import os
import shutil
import subprocess
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
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.tinynn_matmul.restype = ctypes.c_int


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def cuda_matmul(a, b):
    """C = A @ B on the GPU through the hand-written kernel.

    ``a`` [M, K] and ``b`` [K, N] are CUDA tensors of float32 or bfloat16 on
    one device, in any strided layout (transposed views are read in place).
    Returns a new contiguous [M, N] tensor in ``promote(a, b)``. Raises on
    anything the kernel does not take; never computes the product another
    way. ``cuda_matmul.launches`` counts the launches."""
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError("cuda_matmul needs CUDA tensors, got %s and %s"
                         % (a.device, b.device))
    if a.device != b.device:
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
    if (m + 63) // 64 > 65535 or max(m, n, k, *a.stride(), *b.stride()) >= 2 ** 31:
        raise ValueError("shape %s @ %s exceeds the kernel's 32-bit sizes"
                         % (tuple(a.shape), tuple(b.shape)))
    out = torch.empty((m, n), dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = load_library("matmul", _bind_matmul)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.tinynn_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        _KERNEL_DTYPES[a.dtype], _KERNEL_DTYPES[b.dtype], stream)
    if err != 0:
        raise RuntimeError("matmul kernel launch failed: CUDA error %d" % err)
    cuda_matmul.launches += 1
    return out


cuda_matmul.launches = 0


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
    Semantics are numpy.matmul (f32 accumulation always)."""
    a, b, forced_out = _cast_inputs(a, b)
    if (a.ndim == 2 and b.ndim == 2 and a.is_floating_point()
            and b.is_floating_point()):
        if a.is_cuda or b.is_cuda:
            out = cuda_matmul(a, b)
        else:
            out = matmul_reference(a, b)
        return out if forced_out is None else out.to(forced_out)
    out_t = forced_out if forced_out is not None else _acc_type(a, b)
    if out_t is None:
        return torch.matmul(a, b)
    return torch.matmul(a.to(out_t), b.to(out_t))
