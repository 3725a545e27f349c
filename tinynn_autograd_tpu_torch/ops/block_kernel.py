"""The fused transformer-block forward (K7): a whole pre-LN block's forward
in one kernel launch.

PyTorch counterpart of the JAX package's probe kernel ``block_fwd_pallas``
(its ``_block_fwd_kernel``): for ``x`` [B, T, D] f32 and a
``TransformerBlock``'s parameters,

    xn = LN(x; g1, be1)
    q, k, v = xn @ wq, xn @ wk, xn @ wv                      (no bias)
    ctx_h = softmax(q_h k_h^T / sqrt(hd) [causal mask]) v_h  (each head)
    x2 = x + ctx @ wo
    out = x2 + gelu_tanh(LN(x2; g2, be2) @ w1 + b1) @ w2 + b2

The TPU kernel's ``batch_block`` (the batch rows a grid step holds in VMEM)
is a TPU knob with no counterpart here: the CUDA kernel spreads 64x64
output tiles and (batch, head, query tile) tasks over the whole card.
Like the JAX probe, it is wired into no tier; ``bench_block_probe_torch.py``
is its entry point.

- ``block_fwd_reference``: the plain PyTorch version. For CPU tensors and
  the tests.
- ``cuda_block_fwd``: the kernel's wrapper (``csrc/block_fwd.cu``). It
  launches or raises, never falls back; ``cuda_block_fwd.launches`` counts
  its launches.
- ``block_fwd``: the kernel for a CUDA tensor, the plain version for a CPU
  tensor.
"""

import numpy as np
import torch

from tinynn_autograd_tpu_torch.ops import kernels

SOURCE = kernels.CSRC_DIR / "block_fwd.cu"
# block_fwd_pallas's order, which is also the kernel's C interface's
PARAM_NAMES = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2", "g1", "be1",
               "g2", "be2")
MAX_HEAD_DIM = 128  # the kernel's largest head-dim template
# the kernel's phases, in the order of its ``phase_ns`` entries
PHASES = ("ln1", "qkv", "attention", "out_proj", "ln2", "mlp_up",
          "mlp_down")
_NEG = -1e30  # the TPU kernel's mask value


def block_params(block):
    """A port ``TransformerBlock``'s parameters as ``{name: tensor}``."""
    return {k: v.data for k, v in block.params.items()}


def _shapes(d, hidden):
    return {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
            "w1": (d, hidden), "b1": (1, hidden), "w2": (hidden, d),
            "b2": (1, d), "g1": (1, d), "be1": (1, d), "g2": (1, d),
            "be2": (1, d)}


def _layer_norm(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _gelu_tanh(x):
    c = float(np.sqrt(2.0 / np.pi))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def block_fwd_reference(x, params, heads, causal=False, eps=1e-5):
    """The block forward in plain PyTorch, from ``_block_fwd_kernel``'s
    math: ``torch.matmul`` products, the softmax over the whole [T, T]
    score plane, keys after the query masked to -1e30 when ``causal``."""
    p = params
    b, t, d = x.shape
    hd = d // heads
    xn = _layer_norm(x, p["g1"], p["be1"], eps)

    def split(w):  # [B, T, D] @ [D, D] -> [B, H, T, hd]
        return torch.matmul(xn, w).reshape(b, t, heads, hd).transpose(1, 2)

    q, k, v = split(p["wq"]), split(p["wk"]), split(p["wv"])
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(hd))
    if causal:
        visible = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = torch.where(visible, s, _NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
    x2 = x + torch.matmul(ctx, p["wo"])
    yn = _layer_norm(x2, p["g2"], p["be2"], eps)
    y = _gelu_tanh(torch.matmul(yn, p["w1"]) + p["b1"])
    return x2 + torch.matmul(y, p["w2"]) + p["b2"]


def block_costs(b, t, d, heads, causal):
    """(FLOPs, bytes) of one block forward at hidden 4D, for the bound.
    FLOPs: the six products, 2 B T (4 D^2 + 2 D 4D), plus 4 B heads pairs
    hd for the scores and the context, where ``pairs`` counts the visible
    (query, key) pairs: T^2, or T (T + 1) / 2 when causal (the convention
    of K4's bound; the JAX kernel's cost estimate counts every pair).
    Bytes: x read and out written once, and each parameter read once."""
    hidden = 4 * d
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = (2.0 * b * t * (4 * d * d + 2 * d * hidden)
             + 4.0 * b * heads * pairs * (d // heads))
    n_params = 4 * d * d + 2 * d * hidden + hidden + 5 * d
    return flops, 4.0 * (2 * b * t * d + n_params)


def _bind(lib, ctypes):
    ptr = ctypes.c_void_p
    lib.tinynn_block_fwd.argtypes = (
        [ptr, ctypes.POINTER(ptr), ptr, ptr] + [ctypes.c_int] * 6
        + [ctypes.c_float] * 2 + [ptr, ptr])
    lib.tinynn_block_fwd.restype = ctypes.c_int
    lib.tinynn_block_fwd_grid.argtypes = (
        [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.tinynn_block_fwd_grid.restype = ctypes.c_int


def kernel_grid(head_dim):
    """(co-resident blocks per SM, SMs, shared bytes a block): the grid of
    a launch at ``head_dim`` on the current CUDA device."""
    import ctypes

    lib = kernels.load_library("block_fwd", _bind)
    out = [ctypes.c_int(0) for _ in range(3)]
    err = lib.tinynn_block_fwd_grid(head_dim, *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError("occupancy query failed: CUDA error %d" % err)
    return tuple(v.value for v in out)


def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError("%s is on %s, not %s" % (name, t.device, device))
    if t.dtype != torch.float32:
        raise ValueError("%s is %s; the kernel takes float32"
                         % (name, t.dtype))
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("%s must be contiguous and 16-byte aligned" % name)
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))


def cuda_block_fwd(x, params, heads, causal=False, eps=1e-5,
                   phase_ns=None):
    """``block_fwd_reference``'s function through the hand-written kernel:
    one cooperative launch. ``x`` [B, T, D] and the twelve parameters
    (``PARAM_NAMES``, in ``TransformerBlock.shapes``' layout) are contiguous
    float32 CUDA tensors on one device; D is a multiple of ``heads`` and of
    4, D / heads at most 128, the MLP's width a multiple of 4. Returns a new
    [B, T, D] tensor. ``phase_ns``, an int64 CUDA tensor [len(PHASES)],
    gets block 0's time in each phase added (ns). Raises ``ValueError`` on
    anything the kernel does not take (the device last, so that a CPU
    tensor shows its other faults first) and ``RuntimeError`` when the
    launch fails; never computes the block another way."""
    if x.ndim != 3:
        raise ValueError("x must be [B, T, D], got %s" % (tuple(x.shape),))
    b, t, d = x.shape
    if heads < 1 or d % heads:
        raise ValueError("dim %d is not a multiple of heads %d" % (d, heads))
    if d // heads > MAX_HEAD_DIM:
        raise ValueError("head dim %d exceeds the kernel's %d"
                         % (d // heads, MAX_HEAD_DIM))
    if set(params) != set(PARAM_NAMES):
        raise ValueError("params %s, expected %s"
                         % (sorted(params), sorted(PARAM_NAMES)))
    hidden = params["w1"].shape[-1]
    if d % 4 or hidden % 4:
        raise ValueError("dim %d and MLP width %d must be multiples of 4"
                         % (d, hidden))
    if b * t * max(d, hidden) >= 2 ** 31:
        raise ValueError("x %s exceeds the kernel's 32-bit sizes"
                         % (tuple(x.shape),))
    _check("x", x, x.device, (b, t, d))
    shapes = _shapes(d, hidden)
    for name in PARAM_NAMES:
        _check(name, params[name], x.device, shapes[name])
    if phase_ns is not None and (
            phase_ns.device != x.device or phase_ns.dtype != torch.int64
            or tuple(phase_ns.shape) != (len(PHASES),)):
        raise ValueError("phase_ns must be an int64 [%d] tensor on %s"
                         % (len(PHASES), x.device))
    if x.device.type != "cuda":
        raise ValueError("cuda_block_fwd needs CUDA tensors, got %s"
                         % x.device)
    import ctypes

    out = torch.empty_like(x)
    # xn, q, k, v, ctx, yn and the MLP's hidden activations; alive until
    # the launch is queued
    scratch = torch.empty(b * t * (6 * d + hidden), dtype=torch.float32,
                          device=x.device)
    weights = (ctypes.c_void_p * len(PARAM_NAMES))(
        *[params[n].data_ptr() for n in PARAM_NAMES])
    lib = kernels.load_library("block_fwd", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tinynn_block_fwd(
            x.data_ptr(), weights, out.data_ptr(), scratch.data_ptr(), b, t,
            d, hidden, heads, int(bool(causal)), eps,
            float(1.0 / np.sqrt(d // heads)),
            0 if phase_ns is None else phase_ns.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("block forward kernel launch failed: CUDA error %d"
                           % err)
    cuda_block_fwd.launches += 1
    return out


cuda_block_fwd.launches = 0


def block_fwd(x, params, heads, causal=False, eps=1e-5):
    """The block forward: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.device.type == "cuda":
        return cuda_block_fwd(x, params, heads, causal=causal, eps=eps)
    return block_fwd_reference(x, params, heads, causal=causal, eps=eps)
