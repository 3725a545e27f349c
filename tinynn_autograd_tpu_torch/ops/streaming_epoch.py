"""Weight-streaming train step (K3, K3b): the tier for DenseStack bodies whose
weights and optimizer slots do not stay on chip.

PyTorch counterpart of the JAX package's ops/streaming_epoch.py. Its nets
have one ``DenseStack`` (the deep MLP's 98-layer body) between small prefix
and suffix layers. Per train step:

1. the prefix forward on the tape;
2. K3 (``csrc/streaming_epoch.cu``) over the body: every layer's output
   ``acts [L, B, W]`` in one launch, the running activation kept on the SMs;
3. the suffix and the loss on the tape, from a fresh leaf at ``acts[L-1]``;
4. K3b over the body, with the pre-update weights: the dh chain, dW and the
   optimizer's rule applied in the kernel, ``w`` and its slots updated IN
   PLACE; it returns the bias gradients ``db [L, 1, W]`` and ``dh0``;
5. the stacked-bias update on ``db`` through the optimizer's ``leaf_update``;
6. the prefix backward, seeded with ``dh0``;
7. the prefix and suffix leaves through ``leaf_update``, one by one.

On a CUDA device steps 2 and 4 launch the kernels; on the CPU they run the
plain versions. The kernels compute in f32 whatever ``set_matmul_precision``
says, as the JAX kernels do. In this tier ReLU's derivative is taken from the
output, ``a > 0``, as in the JAX kernels (the tape's ``relu_`` and
``dense_stack_`` pass where ``z >= 0``).

- ``supports``/``unsupported_reason``: can the tier run this (net,
  optimizer)?
- ``build_streaming_step``: ``step_fn(xb, yb) -> loss``.
- ``stream_forward_reference``, ``stream_backward_reference``: the plain
  PyTorch versions of K3 and K3b. For CPU tensors and the tests.
- ``cuda_stream_forward``, ``cuda_stream_backward``: the kernels' wrappers.
  They launch or raise, never fall back; each counts its launches in
  ``.launches``.
"""

import numpy as np
import torch

from tinynn_autograd_tpu_torch.ops import kernels

SOURCE = kernels.CSRC_DIR / "streaming_epoch.cu"

# Activation codes of the kernel's C interface
ACTIVATIONS = {"linear": 0, "relu": 1, "sigmoid": 2, "tanh": 3}

# The width rule, from the kernel: a warp's 32 lanes take 32 output columns
# (or 32 consecutive k) at a time, so the width is a multiple of 32; each
# block of K3 keeps two f32 row panels of the width in shared memory, at
# least one row each, and its warps' partial sums, which caps it at 28,928
# (the 227 KB a block may use; K3b's two panels alone allow a little more).
# Every width the JAX package's rule accepts (a multiple of 128) up to that
# cap passes; past it one layer's w alone is 3.3 GB, far beyond what the JAX
# kernel's double-buffered layer blocks can hold in VMEM.
CHUNK = 32
MAX_WIDTH = 28928

# The activation and its derivative from the output a = act(z)
_ACTS = {
    "relu": (lambda z: torch.clamp(z, min=0), lambda a: a > 0),
    "tanh": (torch.tanh, lambda a: 1.0 - a * a),
    "sigmoid": (torch.sigmoid, lambda a: a * (1.0 - a)),
    "linear": (lambda z: z, lambda a: torch.ones_like(a)),
}


def _find_stack(net):
    from tinynn_autograd_tpu_torch.nn.layers import DenseStack

    idxs = [i for i, layer in enumerate(net.layers)
            if isinstance(layer, DenseStack)]
    return idxs[0] if len(idxs) == 1 else None


def unsupported_reason(net, optimizer, batch_shape=None):
    """Why the streaming tier cannot run this (net, optimizer), or None when
    it can. ``batch_shape`` ([batch, *features]), where given, also checks
    that the prefix hands the body [batch, width] rows."""
    from tinynn_autograd_tpu_torch.nn.layers import (
        Activation, Dense, DenseStack, Flatten,
    )

    n_stacks = sum(isinstance(layer, DenseStack) for layer in net.layers)
    if n_stacks != 1:
        return "the net has %d DenseStack layers; the tier streams one" \
            % n_stacks
    stack_idx = _find_stack(net)
    stack = net.layers[stack_idx]
    if stack.activation not in ACTIVATIONS:
        return "DenseStack activation %r is not one of %s" % (
            stack.activation, sorted(ACTIVATIONS))
    if stack.depth < 1:
        return "the DenseStack has no layer"
    width = stack.width
    if width is None or not stack.is_init:
        return "the DenseStack has no parameters yet"
    if width % CHUNK or width > MAX_WIDTH:
        return ("DenseStack width %d is not a multiple of %d up to %d (the "
                "kernels' rule)" % (width, CHUNK, MAX_WIDTH))
    if stack.params["w"].dtype != torch.float32:
        return "the DenseStack holds %s parameters" % stack.params["w"].dtype
    for i, layer in enumerate(net.layers):
        if i == stack_idx:
            continue
        if getattr(layer, "compute_dtype", None) is not None:
            return ("layer %s sets compute_dtype: the kernels run f32 math"
                    % layer.name)
        if not isinstance(layer, (Dense, Activation, Flatten)):
            return ("layer %s around the DenseStack is not Dense, an "
                    "activation or Flatten" % type(layer).__name__)
    if optimizer.kernel_code is None:
        return "optimizer %s has no rule in the kernel" \
            % type(optimizer).__name__
    if optimizer.clip_norm is not None:
        return ("clip_norm needs every gradient before any update; the "
                "backward kernel updates each layer as it goes")
    if batch_shape is not None:
        shape = tuple(batch_shape)
        for layer in net.layers[:stack_idx]:
            shape = tuple(layer.init_params(shape))
        if shape != (batch_shape[0], width):
            return ("the layers before the DenseStack give %s, not [batch, "
                    "%d] rows" % (shape, width))
    return None


def supports(net, optimizer, batch_shape=None):
    """Can the streaming tier train this (net, optimizer)?"""
    return unsupported_reason(net, optimizer, batch_shape) is None


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def build_streaming_step(net, loss_fn, optimizer, forward=None,
                         backward=None):
    """Returns ``step_fn(xb, yb) -> loss`` (a device scalar), one train step
    that updates the net's parameters and the optimizer's state in place
    (made on the first step where there is none) and counts the step.
    ``forward``/``backward`` replace the
    body's two functions (the kernels' wrappers on a CUDA device, the plain
    versions on the CPU) where given: a check runs the same step through
    the plain versions on the card."""
    from tinynn_autograd_tpu_torch.core.tensor import Tensor

    reason = unsupported_reason(net, optimizer)
    if reason is not None:
        raise ValueError("the streaming tier cannot run this net: " + reason)
    stack_idx = _find_stack(net)
    stack = net.layers[stack_idx]
    prefix, suffix = net.layers[:stack_idx], net.layers[stack_idx + 1:]

    def step_fn(xb, yb):
        cuda = xb.device.type == "cuda"
        fwd = forward or (cuda_stream_forward if cuda
                          else stream_forward_reference)
        bwd = backward or (cuda_stream_backward if cuda
                           else stream_backward_reference)
        slots = optimizer.live_state(net.params_tree())["slots"]
        scalars = optimizer.scalars_at(optimizer.step_count + 1)
        small = [layer.params if i != stack_idx else {}
                 for i, layer in enumerate(net.layers)]
        for leaves in small:
            for p in leaves.values():
                p.grad = None

        h0 = Tensor(xb)
        for layer in prefix:
            h0 = layer.forward(h0)
        w, b = stack.params["w"].data, stack.params["b"].data
        acts = fwd(h0.data.contiguous(), w, b, stack.activation)
        h_last = Tensor(acts[-1], requires_grad=True)
        out = h_last
        for layer in suffix:
            out = layer.forward(out)
        loss_t = loss_fn.loss(out, Tensor(yb))
        loss_t.backward()

        def leaf_slots(i, k):
            return {n: slots[n][i][k] for n in optimizer.slot_names}

        db, dh0 = bwd(stack.activation, optimizer, h0.data.contiguous(),
                      h_last.grad.contiguous(), acts, w,
                      leaf_slots(stack_idx, "w"), scalars)
        # the stacked biases through the same per-leaf update (elementwise,
        # so one [L, 1, W] call is L per-layer calls)
        b.add_(optimizer.leaf_update(db, b, scalars,
                                   leaf_slots(stack_idx, "b")))
        if h0.requires_grad:
            h0.backward(dh0)
        for i, leaves in enumerate(small):
            for k, p in leaves.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p.data)
                p.data.add_(optimizer.leaf_update(
                    g.to(p.data.dtype), p.data, scalars, leaf_slots(i, k)))
        optimizer.advance(1)
        return loss_t.data

    return step_fn


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def stream_forward_reference(h0, w, b, activation):
    """K3's function in plain PyTorch: ``acts [L, B, W]`` with
    ``acts[l] = act(acts[l-1] @ w[l] + b[l])`` and ``acts[-1] = h0``."""
    act = _ACTS[activation][0]
    acts = torch.empty((w.shape[0],) + tuple(h0.shape), dtype=torch.float32,
                       device=h0.device)
    h = h0
    for l in range(w.shape[0]):
        h = act(kernels.matmul_reference(h, w[l]) + b[l])
        acts[l] = h
    return acts


def stream_backward_reference(activation, optimizer, h0, dlast, acts, w,
                              slots, scalars):
    """K3b's function in plain PyTorch. From the loss gradient ``dlast``
    [B, W] at the body's output, last layer first: ``dz = dh * act'(a)``,
    ``dh = dz @ w[l]^T`` with the pre-update ``w[l]``, ``dW = h_in^T dz``,
    and ``optimizer.leaf_update`` (the rule at ``scalars``, the step's
    ``optimizer.scalars_at``, and weight decay) applied to ``w[l]`` and the
    ``slots`` ({name: [L, W, W]}) in place. Returns ``(db [L, 1, W], dh0
    [B, W])``."""
    deriv = _ACTS[activation][1]
    n_layers = w.shape[0]
    db = torch.empty((n_layers, 1, w.shape[-1]), dtype=torch.float32,
                     device=w.device)
    dh = dlast
    for l in reversed(range(n_layers)):
        dz = dh * deriv(acts[l])
        h_in = acts[l - 1] if l > 0 else h0
        dh = kernels.matmul_reference(dz, w[l].T)
        dw = kernels.matmul_reference(h_in.T, dz)
        db[l] = dz.sum(dim=0, keepdim=True)
        w[l].add_(optimizer.leaf_update(
            dw, w[l], scalars, {n: slots[n][l] for n in optimizer.slot_names}))
    return db, dh


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _bind(lib, ctypes):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tinynn_stream_forward.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.tinynn_stream_forward.restype = i32
    lib.tinynn_stream_backward.argtypes = ([ptr] * 9 + [i32] * 5 + [f32] * 7
                                           + [ptr])
    lib.tinynn_stream_backward.restype = i32


def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError("%s is on %s, not %s" % (name, t.device, device))
    if t.dtype != torch.float32:
        raise TypeError("%s is %s; the kernel takes float32" % (name, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s is not contiguous" % name)
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))


def _body_shape(w, h0):
    """(L, B, W) of a call, checked against the kernels' limits."""
    if w.ndim != 3 or h0.ndim != 2:
        raise ValueError("w must be [L, W, W] and h0 [B, W], got %s and %s"
                         % (tuple(w.shape), tuple(h0.shape)))
    n_layers, width, batch = w.shape[0], w.shape[-1], h0.shape[0]
    if width % CHUNK or not CHUNK <= width <= MAX_WIDTH:
        raise ValueError("width %d is not a multiple of %d up to %d"
                         % (width, CHUNK, MAX_WIDTH))
    if not (0 < n_layers < 2 ** 16 and 0 < batch < 2 ** 31):
        raise ValueError("%d layers of %d rows are out of range"
                         % (n_layers, batch))
    return n_layers, batch, width


def cuda_stream_forward(h0, w, b, activation):
    """``stream_forward_reference``'s function through K3, one launch.
    Every tensor is a contiguous float32 CUDA tensor on one device. Raises
    on anything the kernel does not take and when the launch fails; never
    computes the forward another way."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError("cuda_stream_forward needs CUDA tensors, got %s"
                         % device)
    n_layers, batch, width = _body_shape(w, h0)
    _check("h0", h0, device, (batch, width))
    _check("w", w, device, (n_layers, width, width))
    _check("b", b, device, (n_layers, 1, width))
    acts = torch.empty((n_layers, batch, width), dtype=torch.float32,
                       device=device)
    lib = kernels.load_library("streaming_epoch", _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tinynn_stream_forward(
            h0.data_ptr(), w.data_ptr(), b.data_ptr(), acts.data_ptr(),
            n_layers, batch, width, ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError("stream forward kernel launch failed: CUDA error "
                           "%d" % err)
    cuda_stream_forward.launches += 1
    return acts


cuda_stream_forward.launches = 0


def cuda_stream_backward(activation, optimizer, h0, dlast, acts, w, slots,
                         scalars):
    """``stream_backward_reference``'s function through K3b: one call, two
    kernels on the stream (the dh chain, then dW with the update), ``w``
    and ``slots`` updated in place. Every tensor is a contiguous float32
    CUDA tensor on one device. Raises on anything the kernel does not take
    and when a launch fails; never computes the backward another way."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError("cuda_stream_backward needs CUDA tensors, got %s"
                         % device)
    n_layers, batch, width = _body_shape(w, h0)
    _check("h0", h0, device, (batch, width))
    _check("dlast", dlast, device, (batch, width))
    _check("acts", acts, device, (n_layers, batch, width))
    _check("w", w, device, (n_layers, width, width))
    names = optimizer.slot_names
    if set(slots) != set(names):
        raise ValueError("slots %s, the optimizer has %s"
                         % (sorted(slots), sorted(names)))
    for name in names:
        _check("slot %s" % name, slots[name], device,
               (n_layers, width, width))
    code, consts = optimizer.kernel_rule()
    slot_ptrs = [slots[n].data_ptr() for n in names] + [0] * (2 - len(names))
    db = torch.empty((n_layers, 1, width), dtype=torch.float32, device=device)
    dh0 = torch.empty((batch, width), dtype=torch.float32, device=device)
    # `dz` lives until both launches are queued: freed earlier, the caching
    # allocator could hand it out while the kernels still use it
    dz = torch.empty((n_layers, batch, width), dtype=torch.float32,
                     device=device)
    s0, s1 = (float(np.float32(s)) for s in scalars)
    lib = kernels.load_library("streaming_epoch", _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tinynn_stream_backward(
            h0.data_ptr(), dlast.data_ptr(), acts.data_ptr(), w.data_ptr(),
            *slot_ptrs, db.data_ptr(), dh0.data_ptr(), dz.data_ptr(),
            n_layers, batch, width, ACTIVATIONS[activation], code, s0, s1,
            *consts, float(np.float32(optimizer.weight_decay)), stream)
    del dz
    if err != 0:
        raise RuntimeError("stream backward kernel launch failed: CUDA error "
                           "%d" % err)
    cuda_stream_backward.launches += 1
    return db, dh0


cuda_stream_backward.launches = 0
