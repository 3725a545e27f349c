"""Differentiable primitives: forward in PyTorch + hand-written VJP closures.

PyTorch counterpart of the JAX package's primitives (tinynn_autograd_tpu/ops/
primitives.py), for the ops the MLP trainers and the transformer classifier
use, and the expert language model's routing ops and grouped experts (no
JAX counterpart). Each primitive computes its forward value with torch
calls (the 2-D matmul goes to the hand-written CUDA kernel on a GPU, see
``ops/kernels.py``; attention to the flash kernels, see
``ops/attention.py``) and registers hand-written VJP closures on the output
Tensor. ``torch.autograd`` is NOT used; reverse mode is the framework's own
tape (see ``core/tensor.py``).

Broadcasting semantics: every binary VJP funnels through a single
``unbroadcast`` helper that reproduces numpy broadcasting reduction exactly.

Semantics kept from the JAX package where torch's built-ins differ:
- ``relu_`` takes subgradient 1 at exactly 0 (``torch.relu``'s takes 0), to
  match ``clip_``, whose boundary values are inside the pass-through mask.
- reduce max/min send the FULL incoming gradient to every tied extreme.
- ``getitem_`` accumulates gradients for repeated indices (scatter-add).
"""

import math

import numpy as np
import torch

from tinynn_autograd_tpu_torch.core.tensor import (
    Tensor, as_tensor, to_torch, torch_dtype,
)
from tinynn_autograd_tpu_torch.ops import kernels


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------

def build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values):
    """Wrap ``values`` in a Tensor recording VJP edges to requiring inputs."""
    requires_grad = ts1.requires_grad or ts2.requires_grad
    dependency = []
    if ts1.requires_grad:
        dependency.append((ts1, grad_fn_ts1))
    if ts2.requires_grad:
        dependency.append((ts2, grad_fn_ts2))
    return ts1.__class__(values, requires_grad, dependency)


def build_unary_ops_tensor(ts, grad_fn, values):
    requires_grad = ts.requires_grad
    dependency = [(ts, grad_fn)] if requires_grad else []
    return ts.__class__(values, requires_grad, dependency)


def unbroadcast(grad, shape):
    """Reduce ``grad`` back to ``shape`` under numpy broadcasting rules.

    Sum over leading dims that were prepended by broadcasting, then
    keepdims-sum every axis where ``shape`` has size 1 but ``grad`` doesn't.
    """
    ndiff = grad.ndim - len(shape)
    if ndiff > 0:
        grad = grad.sum(dim=tuple(range(ndiff)))
    axes = tuple(
        i for i, dim in enumerate(shape) if dim == 1 and grad.shape[i] != 1
    )
    if axes:
        grad = grad.sum(dim=axes, keepdim=True)
    return grad


# --------------------------------------------------------------------------
# binary ops
# --------------------------------------------------------------------------

def add_(ts1, ts2):
    """c = a + b."""
    values = ts1.data + ts2.data

    def grad_fn_ts1(grad):
        return unbroadcast(grad, ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def sub_(ts1, ts2):
    """c = a - b, composed as a + (-b)."""
    return ts1 + (-ts2)


def mul_(ts1, ts2):
    """c = a * b."""
    values = ts1.data * ts2.data

    def grad_fn_ts1(grad):
        return unbroadcast(grad * ts2.data, ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad * ts1.data, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def div_(ts1, ts2):
    """c = a / b."""
    values = ts1.data / ts2.data

    def grad_fn_ts1(grad):
        return unbroadcast(grad / ts2.data, ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(-grad * ts1.data / ts2.data ** 2, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def pow_(ts1, ts2):
    """c = a ** b; d/da = b * a**(b-1); d/db = ln(a) * a**b (NaN for a <= 0,
    matching numpy)."""
    a, b = ts1.data, ts2.data
    values = a ** b

    def grad_fn_ts1(grad):
        return unbroadcast(grad * b * a ** (b - 1), ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad * torch.log(a) * values, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def _swap_last2(x):
    # a strided view: the matmul kernel reads it in place
    return x.transpose(-1, -2)


def dot_(ts1, ts2):
    """c = a @ b with numpy.matmul semantics: 1-D operands and batched N-D
    matmul with broadcast batch dims. A float product by a 2-D ``b`` (``a``
    2-D or N-D, its rows folded into one 2-D product) and both of its VJPs
    go through ``kernels.matmul`` (the CUDA kernel on a GPU)."""
    a, b = ts1.data, ts2.data
    values = kernels.matmul(a, b)

    if a.ndim == 1 and b.ndim == 1:
        def grad_fn_ts1(grad):
            return grad * b

        def grad_fn_ts2(grad):
            return grad * a
    elif b.ndim == 1:
        # (..., m, k) @ (k,) -> (..., m)
        def grad_fn_ts1(grad):
            return unbroadcast(grad[..., None] * b, ts1.shape)

        def grad_fn_ts2(grad):
            g = grad[..., None, :] @ a  # (..., 1, k)
            return unbroadcast(g[..., 0, :], ts2.shape)
    elif a.ndim == 1:
        # (k,) @ (..., k, n) -> (..., n)
        def grad_fn_ts1(grad):
            g = b @ grad[..., None]  # (..., k, 1)
            return unbroadcast(g[..., 0], ts1.shape)

        def grad_fn_ts2(grad):
            return unbroadcast(a[:, None] * grad[..., None, :], ts2.shape)
    else:
        def grad_fn_ts1(grad):
            return unbroadcast(kernels.matmul(grad, _swap_last2(b)), ts1.shape)

        if b.ndim == 2 and a.ndim > 2:
            # (..., m, k) @ (k, n): dW is one 2-D product over every row of
            # a, [k, (... m)] @ [(... m), n], not a batch of products summed
            def grad_fn_ts2(grad):
                return kernels.matmul(
                    _swap_last2(a.reshape(-1, a.shape[-1])),
                    grad.reshape(-1, grad.shape[-1]))
        else:
            def grad_fn_ts2(grad):
                return unbroadcast(kernels.matmul(_swap_last2(a), grad),
                                   ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


# --------------------------------------------------------------------------
# unary ops
# --------------------------------------------------------------------------

def exp_(ts):
    values = torch.exp(ts.data)

    def grad_fn(grad):
        return values * grad

    return build_unary_ops_tensor(ts, grad_fn, values)


def _normalize_axes(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(a % ndim for a in axis)
    return (axis % ndim,)


def _expand_dims(grad, axes):
    for a in sorted(axes):
        grad = grad.unsqueeze(a)
    return grad


def _reduce_extreme(ts, axis, reducer):
    """Shared machinery for max_/min_ reductions: every element equal to the
    extreme receives the FULL incoming gradient (no splitting), for any
    axis."""
    x = ts.data
    axes = _normalize_axes(axis, x.ndim)
    dims = axes if axes is not None else tuple(range(x.ndim))
    if dims:
        values = reducer(x, dim=dims)
        kd = reducer(x, dim=dims, keepdim=True)
    else:  # 0-d input
        values = kd = x.clone()
    mask = (x == kd)

    def grad_fn(grad):
        if axes is not None:
            grad = _expand_dims(grad, axes)
        return grad * mask

    return build_unary_ops_tensor(ts, grad_fn, values)


def max_(ts, axis=None):
    return _reduce_extreme(ts, axis, torch.amax)


def min_(ts, axis=None):
    return _reduce_extreme(ts, axis, torch.amin)


def log_(ts):
    values = torch.log(ts.data)

    def grad_fn(grad):
        return grad / ts.data

    return build_unary_ops_tensor(ts, grad_fn, values)


def _reduce(x, op, axes, keepdims):
    if axes is None:
        if keepdims:
            return op(x, dim=tuple(range(x.ndim)), keepdim=True)
        return op(x)
    return op(x, dim=axes, keepdim=keepdims)


def sum_(ts, axis=None, keepdims=False):
    """Reduce-sum; grad broadcasts back over the reduced axes (tuple axes
    and keepdims supported)."""
    shape = ts.shape
    axes = _normalize_axes(axis, ts.data.ndim)
    values = _reduce(ts.data, torch.sum, axes, keepdims)

    def grad_fn(grad):
        if axes is not None and not keepdims:
            grad = _expand_dims(grad, axes)
        return torch.broadcast_to(grad, shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def mean_(ts, axis=None, keepdims=False):
    """Reduce-mean = sum / count, fused as a single primitive."""
    shape = ts.shape
    axes = _normalize_axes(axis, ts.data.ndim)
    values = _reduce(ts.data, torch.mean, axes, keepdims)
    if axes is None:
        count = ts.data.numel()
    else:
        count = 1
        for a in axes:
            count *= shape[a]

    def grad_fn(grad):
        if axes is not None and not keepdims:
            grad = _expand_dims(grad, axes)
        return torch.broadcast_to(grad / count, shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def transpose_(ts, axes=None):
    """Axes are normalized to non-negative before inverting the permutation,
    so numpy-legal negative axes transpose the cotangent correctly."""
    ndim = ts.data.ndim
    if axes is None:
        axes = list(reversed(range(ndim)))
    axes = [a % ndim for a in axes]
    values = ts.data.permute(axes)
    inv = [int(i) for i in np.argsort(axes)]

    def grad_fn(grad):
        return grad.permute(inv)

    return build_unary_ops_tensor(ts, grad_fn, values)


def _coerce_key(key, device):
    def one(k):
        if isinstance(k, Tensor):
            k = k.data
        if isinstance(k, (np.ndarray, list)):
            k = to_torch(k)
        if isinstance(k, torch.Tensor):
            k = k.to(device)
        return k

    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


def getitem_(ts, key):
    """Indexing/slicing; the VJP scatters the gradient back into zeros.

    Repeated indices ACCUMULATE (scatter-add), the calculus-correct adjoint:
    the key is applied to a grid of flat positions, and the gradient is
    index-added at the positions it selected, whatever mix of ints, slices,
    index arrays and masks the key holds.
    """
    key = _coerce_key(key, ts.device)
    values = ts.data[key]

    def grad_fn(grad):
        x = ts.data
        pos = torch.arange(x.numel(), device=x.device).reshape(x.shape)[key]
        flat = torch.zeros(x.numel(), dtype=grad.dtype, device=grad.device)
        flat.index_add_(0, pos.reshape(-1), grad.reshape(-1))
        return flat.reshape(x.shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def neg_(ts):
    values = -ts.data

    def grad_fn(grad):
        return -grad

    return build_unary_ops_tensor(ts, grad_fn, values)


def reshape_(ts, newshape):
    shape = ts.shape
    values = ts.data.reshape(newshape)

    def grad_fn(grad):
        return grad.reshape(shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def flatten_(ts):
    shape = ts.shape
    values = ts.data.reshape(-1)

    def grad_fn(grad):
        return grad.reshape(shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def clip_(ts, min=None, max=None):
    """Clip; boundary values are INCLUDED in the pass-through mask, so e.g.
    d/dx relu(0) = 1."""
    x = ts.data
    values = x if min is None and max is None else torch.clamp(x, min, max)

    mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if min is not None:
        mask = mask & (x >= min)
    if max is not None:
        mask = mask & (x <= max)

    def grad_fn(grad):
        return grad * mask

    return build_unary_ops_tensor(ts, grad_fn, values)


def astype_(ts, dtype):
    """Dtype cast; gradient casts back to the source gradient dtype."""
    src = ts.data.dtype
    values = ts.data.to(torch_dtype(dtype))

    def grad_fn(grad):
        if src.is_floating_point:
            return grad.to(src)
        return grad

    return build_unary_ops_tensor(ts, grad_fn, values)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def sigmoid_(ts):
    """Numerically stable logistic; d/dx = y * (1 - y)."""
    values = torch.sigmoid(ts.data)

    def grad_fn(grad):
        return grad * values * (1.0 - values)

    return build_unary_ops_tensor(ts, grad_fn, values)


def tanh_(ts):
    """True tanh; d/dx = 1 - y**2."""
    values = torch.tanh(ts.data)

    def grad_fn(grad):
        return grad * (1.0 - values * values)

    return build_unary_ops_tensor(ts, grad_fn, values)


def relu_(ts):
    """max(x, 0); subgradient at 0 is 1 (boundary-inclusive, like clip_)."""
    x = ts.data
    values = torch.clamp(x, min=0)

    def grad_fn(grad):
        return grad * (x >= 0)

    return build_unary_ops_tensor(ts, grad_fn, values)


def log_softmax_(ts, axis=-1):
    """Row-stable log-softmax; VJP: g - exp(y) * sum(g, axis, keepdims).
    The kernel under SoftmaxCrossEntropyLoss."""
    values = torch.log_softmax(ts.data, dim=axis)

    def grad_fn(grad):
        return grad - torch.exp(values) * grad.sum(dim=axis, keepdim=True)

    return build_unary_ops_tensor(ts, grad_fn, values)


def softmax_(ts, axis=-1):
    """Row-stable softmax; VJP: dx = y * (g - sum(g*y, axis, keepdims))."""
    values = torch.softmax(ts.data, dim=axis)

    def grad_fn(grad):
        return values * (grad - (grad * values).sum(dim=axis, keepdim=True))

    return build_unary_ops_tensor(ts, grad_fn, values)


_STACK_ACTS = {
    "relu": (lambda z: torch.clamp(z, min=0), lambda z, a: z >= 0),
    "tanh": (torch.tanh, lambda z, a: 1.0 - a * a),
    "sigmoid": (torch.sigmoid, lambda z, a: a * (1.0 - a)),
    "linear": (lambda z: z, lambda z, a: torch.ones_like(z)),
}


def dense_stack_(ts_x, ts_w, ts_b, activation="relu"):
    """L homogeneous Dense+activation layers as ONE primitive:
    h_{l+1} = act(h_l @ w[l] + b[l]), weights stacked w:[L,W,W], b:[L,1,W].

    The forward is a loop over the layer axis that keeps every layer's
    input, pre-activation and output; the hand-written VJP is the reverse
    loop, one backward computation shared by the three gradient functions.
    Each product goes through ``kernels.matmul`` (the CUDA kernel on a GPU),
    so a step of an L-layer body makes 3L matmul launches. ReLU's derivative
    here is the tape's, ``z >= 0``."""
    act_fn, act_grad = _STACK_ACTS[activation]
    x, w, b = ts_x.data, ts_w.data, ts_b.data
    h_ins, zs, acts = [], [], []
    h = x
    for l in range(w.shape[0]):
        h_ins.append(h)
        zs.append(kernels.matmul(h, w[l]) + b[l])
        h = act_fn(zs[-1])
        acts.append(h)

    # the three grad_fns share one backward pass per cotangent; the cache
    # holds a strong reference to the cotangent and compares with `is`, so
    # a freed object whose id is reused never aliases a stale entry
    cache = []  # [grad_object, (dx, dw, db)]

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad,
                        _dense_stack_bwd(grad, w, h_ins, zs, acts, act_grad)]
        return cache[1]

    dependency = []
    for i, ts in enumerate((ts_x, ts_w, ts_b)):
        if ts.requires_grad:
            dependency.append((ts, lambda grad, i=i: memo(grad)[i]))
    requires_grad = bool(dependency)
    return ts_x.__class__(h, requires_grad, dependency)


def _dense_stack_bwd(grad, w, h_ins, zs, acts, act_grad):
    """Reverse loop over layers: dz = dh * act'(z); dW = h_in^T dz;
    db = sum_rows dz; dh = dz @ w^T."""
    dws, dbs = [None] * len(zs), [None] * len(zs)
    dh = grad
    for l in reversed(range(len(zs))):
        dz = dh * act_grad(zs[l], acts[l])
        dws[l] = kernels.matmul(_swap_last2(h_ins[l]), dz)
        dbs[l] = dz.sum(dim=0, keepdim=True)
        dh = kernels.matmul(dz, _swap_last2(w[l]))
    return dh, torch.stack(dws), torch.stack(dbs)


def gelu_(ts):
    """Tanh-approximation GELU with its exact hand derivative."""
    x = ts.data
    c = float(np.float32(np.sqrt(2.0 / np.pi)))
    inner = c * (x + 0.044715 * x ** 3)
    t = torch.tanh(inner)
    values = 0.5 * x * (1.0 + t)

    def grad_fn(grad):
        dinner = c * (1.0 + 3 * 0.044715 * x ** 2)
        return grad * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner)

    return build_unary_ops_tensor(ts, grad_fn, values)


def layer_norm_(ts_x, ts_gamma, ts_beta, eps=1e-5):
    """Layer normalization over the LAST axis with learned scale/shift:
    y = (x - mean)/sqrt(var + eps) * gamma + beta. Hand VJPs:
      dx     = (gamma*g - mean(gamma*g) - xhat * mean(gamma*g * xhat)) / std
      dgamma = sum over leading axes of g * xhat
      dbeta  = sum over leading axes of g
    """
    x, gamma, beta = ts_x.data, ts_gamma.data, ts_beta.data
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    std = torch.sqrt(var + eps)
    xhat = (x - mu) / std
    values = xhat * gamma + beta

    def grad_fn_x(grad):
        gg = grad * gamma
        m1 = gg.mean(dim=-1, keepdim=True)
        m2 = (gg * xhat).mean(dim=-1, keepdim=True)
        return (gg - m1 - xhat * m2) / std

    def grad_fn_gamma(grad):
        return unbroadcast(grad * xhat, ts_gamma.shape)

    def grad_fn_beta(grad):
        return unbroadcast(grad, ts_beta.shape)

    dependency = [(ts, fn) for ts, fn in ((ts_x, grad_fn_x),
                                          (ts_gamma, grad_fn_gamma),
                                          (ts_beta, grad_fn_beta))
                  if ts.requires_grad]
    return ts_x.__class__(values, bool(dependency), dependency)


def rms_norm_(ts_x, ts_gamma, eps=1e-6):
    """RMS normalization over the LAST axis with a learned scale (no
    centering, no shift; the llama-family norm), as the JAX package's:
    y = x * rsqrt(mean(x^2) + eps) * gamma. Hand VJPs, with
    r = rsqrt(mean(x^2) + eps) and xhat = x * r:
      dx     = (gamma*g - xhat * mean(gamma*g * xhat)) * r
      dgamma = sum over leading axes of g * xhat
    """
    x, gamma = ts_x.data, ts_gamma.data
    r = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    xhat = x * r
    values = xhat * gamma

    def grad_fn_x(grad):
        gg = grad * gamma
        m2 = (gg * xhat).mean(dim=-1, keepdim=True)
        return (gg - xhat * m2) * r

    def grad_fn_gamma(grad):
        return unbroadcast(grad * xhat, ts_gamma.shape)

    dependency = [(ts, fn) for ts, fn in ((ts_x, grad_fn_x),
                                          (ts_gamma, grad_fn_gamma))
                  if ts.requires_grad]
    return ts_x.__class__(values, bool(dependency), dependency)


def _silu(x):
    """(x * sigmoid(x), sigmoid(x)) of a raw tensor."""
    s = torch.sigmoid(x)
    return x * s, s


def _silu_grad(x, s):
    """d silu(x) / dx, with s = sigmoid(x)."""
    return s * (1.0 + x * (1.0 - s))


def silu_(ts):
    """SiLU (swish), x * sigmoid(x), the gate of SwiGLU MLPs; with
    s = sigmoid(x), d/dx = s * (1 + x * (1 - s))."""
    x = ts.data
    values, s = _silu(x)

    def grad_fn(grad):
        return grad * _silu_grad(x, s)

    return build_unary_ops_tensor(ts, grad_fn, values)


def rope_tables(t, head_dim, theta, yarn=None):
    """The rotary tables (cos, sin) [t, head_dim // 2] of positions 0..t-1,
    computed in float64 and rounded to float32: angle(p, i) = p * f_i with
    f_i = theta^(-2i / head_dim).

    ``yarn`` (a dict of "factor", "original_max_position_embeddings",
    "beta_fast", "beta_slow" and "attention_factor", as a model's
    ``rope_parameters`` give them) takes YaRN's frequencies instead:
    f_i = f_i / factor * (1 - m_i) + f_i * m_i, with the ramp
    m_i = 1 - clamp((i - low) / (high - low), 0, 1) between the dims
    low = floor(c(beta_fast)) and high = ceil(c(beta_slow)), clamped to
    [0, head_dim - 1], where c(r) = head_dim * ln(orig / (2 pi r)) /
    (2 ln theta); both tables are then scaled by ``attention_factor``."""
    half = head_dim // 2
    i = torch.arange(half, dtype=torch.float64)
    freq = float(theta) ** (-2.0 * i / head_dim)
    scale = 1.0
    if yarn is not None:
        orig = yarn["original_max_position_embeddings"]

        def dim_of(rotations):
            return (head_dim * math.log(orig / (2.0 * math.pi * rotations))
                    / (2.0 * math.log(theta)))

        low = max(math.floor(dim_of(yarn["beta_fast"])), 0)
        high = min(math.ceil(dim_of(yarn["beta_slow"])), head_dim - 1)
        if high == low:
            high += 0.001
        m = 1.0 - ((i - low) / (high - low)).clamp(0.0, 1.0)
        freq = freq / yarn["factor"] * (1.0 - m) + freq * m
        scale = yarn["attention_factor"]
    angle = torch.arange(t, dtype=torch.float64)[:, None] * freq[None, :]
    return ((torch.cos(angle) * scale).float(),
            (torch.sin(angle) * scale).float())


def rope_(ts, cos, sin, interleaved=False):
    """Rotary position embedding over the LAST axis, half-split (GPT-NeoX /
    llama, ``rotate_half``) convention: lane i pairs with lane i + d/2, and
      y1 = x1*cos - x2*sin ;  y2 = x2*cos + x1*sin
    with ``cos``/``sin`` (``rope_tables``) broadcast against the halves,
    e.g. [T, 1, d/2] for x [B, T, H, d]. The tables are constants.

    ``interleaved``: DeepSeek-V3's pairing (its ``apply_rotary_pos_emb``
    first reorders each vector ``view(d/2, 2).transpose.reshape`` and then
    applies ``rotate_half``): x1 = x[..., 0::2] and x2 = x[..., 1::2], lane
    2i paired with lane 2i + 1, and the output [y1, y2] in that reordered
    layout. Hand VJP, the transposed map (re-interleaved for ``interleaved``):
      g1' = g1*cos + g2*sin ;  g2' = g2*cos - g1*sin
    """
    x = ts.data
    half = x.shape[-1] // 2
    if interleaved:
        x1, x2 = x[..., 0::2], x[..., 1::2]
    else:
        x1, x2 = x[..., :half], x[..., half:]
    values = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def grad_fn(grad):
        g1, g2 = grad[..., :half], grad[..., half:]
        d1, d2 = g1 * cos + g2 * sin, g2 * cos - g1 * sin
        if interleaved:
            return torch.stack([d1, d2], dim=-1).reshape(x.shape)
        return torch.cat([d1, d2], dim=-1)

    return build_unary_ops_tensor(ts, grad_fn, values)


# --------------------------------------------------------------------------
# routing: top-k selection, gathers and scatters of rows
# --------------------------------------------------------------------------

def top_k_(ts, k):
    """The indices [..., k] of the ``k`` largest entries along the last
    axis, largest first (``torch.topk``): a plain int64 tensor, not
    differentiated (a selection has no gradient)."""
    x = ts.data if isinstance(ts, Tensor) else ts
    return torch.topk(x, k, dim=-1).indices


def take_along_axis_(ts, index):
    """out[..., j] = x[..., index[..., j]] along the last axis (``index`` an
    int64 tensor of x's leading shape); the VJP scatter-adds the gradient
    back (an index taken twice gets both)."""
    x = ts.data
    values = torch.gather(x, -1, index)

    def grad_fn(grad):
        return torch.zeros_like(x).scatter_add_(-1, index, grad)

    return build_unary_ops_tensor(ts, grad_fn, values)


def gather_rows_(ts, index):
    """Rows ``index`` (int64 [n]) of x along its first axis, in order; the
    VJP index-adds each gradient row back to its source row (a row taken
    twice gets both)."""
    x = ts.data
    values = x.index_select(0, index)

    def grad_fn(grad):
        return torch.zeros_like(x).index_add_(0, index, grad)

    return build_unary_ops_tensor(ts, grad_fn, values)


def scatter_add_rows_(ts, index, n):
    """[n, ...] zeros with row i of x added into row ``index[i]`` (rows
    with one index sum); the VJP gathers the gradient's rows ``index``."""
    x = ts.data
    values = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device).index_add_(0, index, x)

    def grad_fn(grad):
        return grad.index_select(0, index)

    return build_unary_ops_tensor(ts, grad_fn, values)


def grouped_swiglu_(ts_x, counts, experts):
    """SwiGLU experts over rows grouped by expert, as ONE primitive: the
    first ``counts[0]`` rows of x [P, D] go to ``experts[0]``, the next
    ``counts[1]`` to ``experts[1]``, and so on; each expert is a
    (gate [D, F], up [D, F], down [F, D]) triple of Tensors, and its rows r
    give e_r = (silu(x_r @ gate) * (x_r @ up)) @ down. ``counts`` are host
    ints.

    Every product runs through ``kernels.matmul`` on a contiguous block of
    rows (a view: on a GPU, K1; its tensor-core tile takes any number of
    rows where D and F are multiples of 4), three an expert forward and
    six backward (dh, ddown, dx's two, dgate, dup); an expert with no rows
    launches none and gets zero gradients. The 3E + 1 grad_fns share one
    memoised backward, as ``dense_stack_``'s do."""
    x = ts_x.data
    bounds = np.cumsum([0] + [int(c) for c in counts])
    if bounds[-1] != x.shape[0] or len(counts) != len(experts):
        raise ValueError("grouped_swiglu_: counts %s do not cover %d rows of "
                         "%d experts" % (list(counts), x.shape[0],
                                         len(experts)))
    saved, blocks = [], []
    for (gate, up, down), lo, hi in zip(experts, bounds[:-1], bounds[1:]):
        if lo == hi:
            saved.append(None)
            continue
        xj = x[lo:hi]
        g = kernels.matmul(xj, gate.data)
        u = kernels.matmul(xj, up.data)
        saved.append((g, u))
        blocks.append(kernels.matmul(_silu(g)[0] * u, down.data))
    values = torch.cat(blocks) if blocks else torch.zeros_like(x)

    def backward(grad):
        dx, dws = [], []
        for triple, gu, lo, hi in zip(experts, saved, bounds[:-1],
                                      bounds[1:]):
            if gu is None:
                dws += [torch.zeros_like(w.data) for w in triple]
                continue
            (gate, up, down), (g, u) = triple, gu
            xj, dej = x[lo:hi], grad[lo:hi]
            act, s = _silu(g)
            dh = kernels.matmul(dej, _swap_last2(down.data))
            ddown = kernels.matmul(_swap_last2(act * u), dej)
            dg = dh * u * _silu_grad(g, s)
            du = dh * act
            dxj = kernels.matmul(dg, _swap_last2(gate.data))
            dxj += kernels.matmul(du, _swap_last2(up.data))
            dx.append(dxj)
            dws += [kernels.matmul(_swap_last2(xj), dg),
                    kernels.matmul(_swap_last2(xj), du), ddown]
        return [torch.cat(dx) if dx else torch.zeros_like(x)] + dws

    cache = []  # [grad_object, grads] (see dense_stack_)

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, backward(grad)]
        return cache[1]

    leaves = [ts_x] + [w for triple in experts for w in triple]
    dependency = [(ts, lambda grad, i=i: memo(grad)[i])
                  for i, ts in enumerate(leaves) if ts.requires_grad]
    return ts_x.__class__(values, bool(dependency), dependency)


def flash_attention_(ts_q, ts_k, ts_v, causal=False, scale=None, impl=None,
                     dropout_rate=0.0, dropout_rng=None, window=None):
    """Fused multi-head attention as ONE tape primitive:
    out = softmax(Q K^T * scale [+ causal/window mask]) V, Q: [B, H, Tq, d_qk],
    K: [B, Hkv, Tk, d_qk], V: [B, Hkv, Tk, d_v] (Hkv | H: grouped-query
    attention); out [B, H, Tq, d_v], and the VJP gives dv at d_v. The
    kernels take d_qk == d_v <= 128, or d_qk in (128, 192] with d_v <= 128
    (multi-head latent attention's split dims); the plain versions any pair.
    ``scale`` defaults to 1/sqrt(d_qk).

    The forward and the hand-written VJPs run as the CUDA kernels of
    ``ops/attention.py`` on a GPU (the plain versions on the CPU, or on the
    card with ``impl="plain"``). The three grad_fns share one memoised joint
    backward, which launches the dq and dk/dv kernels once per cotangent.

    ``dropout_rate`` > 0 drops attention probabilities inside the kernels
    from a counter hash of the absolute (head, query, key) index and a seed
    (``dropout_rng``: an int, else a uint32 drawn from the seeder's
    generator), so the backward replays the forward's mask without storing
    it. ``window`` (causal only) bands attention to the keys in
    (p - window, p].
    """
    from tinynn_autograd_tpu_torch.ops import attention

    q, k, v = ts_q.data, ts_k.data, ts_v.data
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    seed = _attn_dropout_seed(dropout_rate, dropout_rng)
    o, lse = attention.mha_fwd(q, k, v, causal=causal, scale=scale,
                               impl=impl, dropout_rate=dropout_rate,
                               dropout_seed=seed, window=window)

    # strong reference to the cotangent, compared with `is` (see dense_stack_)
    cache = []  # [grad_object, (dq, dk, dv)]

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, attention.mha_bwd(
                q, k, v, o, lse, grad, causal=causal, scale=scale,
                impl=impl, dropout_rate=dropout_rate, dropout_seed=seed,
                window=window)]
        return cache[1]

    dependency = [(ts, lambda grad, i=i: memo(grad)[i])
                  for i, ts in enumerate((ts_q, ts_k, ts_v))
                  if ts.requires_grad]
    return ts_q.__class__(o, bool(dependency), dependency)


def _attn_dropout_seed(dropout_rate, dropout_rng):
    """The kernels' uint32 dropout seed: ``dropout_rng`` itself when it is
    an int, else a draw from the seeder's generator; None when dropout is
    off."""
    if dropout_rate <= 0.0:
        return None
    return _dropout_seed(dropout_rng)


def _dropout_seed(rng):
    """A uint32 dropout seed: ``rng`` mod 2**32 when it is an int, else (for
    None) a draw from the seeder's generator."""
    if rng is None:
        from tinynn_autograd_tpu_torch.utils import seeder

        return int(torch.randint(0, 2 ** 32, (1,),
                                 generator=seeder.generator()))
    if isinstance(rng, (int, np.integer)):
        return int(rng) % 2 ** 32
    raise TypeError("a dropout seed must be an int or None, got %r" % (rng,))


def dropout_(ts, rate, rng=None):
    """Inverted dropout: zero with probability ``rate``, scale survivors by
    1 / (1 - rate). The mask is the counter hash of ``ops/dropout.py`` over
    the row-major flat index of ``ts`` (the JAX package's interpret-mode
    megakernel mask), seeded by ``rng``: an int, or None for a draw from
    the seeder's generator. On a CUDA tensor the forward is P1's kernel
    (csrc/dropout.cu), on the CPU its plain version; the VJP is the same
    select on the gradient."""
    from tinynn_autograd_tpu_torch.ops import dropout

    values, mask = dropout.dropout_forward(ts.data, rate, _dropout_seed(rng))
    scale = dropout.keep_scale(rate)[1]

    def grad_fn(grad):
        return torch.where(mask, grad * scale, 0.0)

    return build_unary_ops_tensor(ts, grad_fn, values)


def broadcast_to_(ts, shape):
    """x broadcast to ``shape`` (a view, as ``torch.broadcast_to``); the VJP
    sums the gradient back over the broadcast axes (``unbroadcast``)."""
    values = torch.broadcast_to(ts.data, shape)

    def grad_fn(grad):
        return unbroadcast(grad, ts.shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def split_(ts, sizes, axis=-1):
    """x cut along ``axis`` into pieces of ``sizes`` (views, as
    ``torch.split``); each piece's VJP puts its gradient in its place in
    zeros of x's shape (the tape sums the pieces')."""
    x = ts.data
    ax = axis % x.ndim
    if sum(sizes) != x.shape[ax]:
        raise ValueError("split_: sizes %s do not cover axis %d of %s"
                         % (list(sizes), axis, tuple(x.shape)))
    out, start = [], 0
    for size in sizes:
        def grad_fn(grad, start=start, size=size):
            full = torch.zeros(x.shape, dtype=grad.dtype, device=grad.device)
            full.narrow(ax, start, size).copy_(grad)
            return full

        out.append(build_unary_ops_tensor(ts, grad_fn,
                                          x.narrow(ax, start, size)))
        start += size
    return out


def concat_(tensors, axis=0):
    """Concatenate along ``axis``; the VJP slices the gradient back per
    input."""
    tensors = [as_tensor(t) for t in tensors]
    values = torch.cat([t.data for t in tensors], dim=axis)
    ax = axis % values.ndim
    dependency = []
    offset = 0
    for t in tensors:
        size = t.shape[ax]
        if t.requires_grad:
            dependency.append(
                (t, lambda grad, start=offset, size=size:
                 grad.narrow(ax, start, size)))
        offset += size
    return tensors[0].__class__(values, bool(dependency), dependency)


def where_(cond, ts1, ts2):
    """Elementwise select; gradient flows to the selected branch only."""
    c = to_torch(cond)
    device = next((t.device for t in (ts1, ts2) if isinstance(t, Tensor)),
                  c.device)
    ts1, ts2 = as_tensor(ts1, device), as_tensor(ts2, device)
    c = c.to(device=device, dtype=torch.bool)
    values = torch.where(c, ts1.data, ts2.data)

    def grad_fn_ts1(grad):
        return unbroadcast(torch.where(c, grad, 0.0), ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(torch.where(c, 0.0, grad), ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)
