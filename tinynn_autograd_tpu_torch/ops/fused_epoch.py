"""Whole-epoch training kernel (K2): every step of an epoch in one launch.

PyTorch counterpart of the JAX package's ops/fused_epoch.py. The JAX
megakernel keeps the parameters and optimizer moments in VMEM across a
sequential grid of steps and traces its body from the tape. Here the body is
written out by hand in ``csrc/fused_epoch.cu``: one persistent cooperative
CUDA kernel per epoch, with the state resident in device memory (and in the
50 MB L2) and grid-wide barriers between the phases of a step. It takes the
nets ``supports`` accepts: Dense layers, each followed by at most one ReLU,
Sigmoid or Tanh, Flatten, softmax cross-entropy (with or without class
weights), and SGD or Adam with a constant learning rate and any weight
decay.

- ``supports``: can the kernel run this (net, optimizer, loss)?
- ``build_fused_epoch``: ``epoch_fn(params, slots, t0, xb, yb) -> (t,
  losses)``. The parameters and slots are the model's own tensors, updated
  IN PLACE: that saves a copy of the state (2.2 MB for the flagship with
  Adam) per epoch. On a CUDA device it launches the kernel; on the CPU it
  runs the plain version.
- ``fused_epoch_reference``: the plain PyTorch version, the same arithmetic
  layer by layer (not through the tape). For CPU tensors and the tests.
- ``cuda_fused_epoch``: the kernel's wrapper. It launches or raises, never
  falls back; ``cuda_fused_epoch.launches`` counts its launches.
"""

import dataclasses
import numbers

import numpy as np
import torch

from tinynn_autograd_tpu_torch.ops import kernels

SOURCE = kernels.CSRC_DIR / "fused_epoch.cu"

# Activation codes of the kernel's C interface.
ACT_NONE, ACT_RELU, ACT_SIGMOID, ACT_TANH = 0, 1, 2, 3
OPT_SGD, OPT_ADAM = 0, 1
MAX_LAYERS = 16  # MAX_LAYERS in csrc/fused_epoch.cu

# The state the kernel keeps resident from step to step: parameters,
# optimizer slots, gradients and activations. On the H100 it lives in device
# memory and is served from the 50 MB L2 (two 25 MB halves), so it is held
# to about half of it, 24 MB, leaving the rest for the batches streaming
# through and other work on the card. The flagship with Adam needs 3.4 MB.
# (The TPU kernel's VMEM budget of 6 MB is a TPU figure and does not apply.)
STATE_BUDGET = 24 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class EpochSpec:
    """What the kernel is told about the net and the optimizer."""
    layers: tuple       # (d_in, d_out, activation code) for each Dense
    optimizer: int      # OPT_SGD or OPT_ADAM
    b1c: float = 0.0    # 1 - beta1, as the f32 the step loop multiplies by
    b2c: float = 0.0    # 1 - beta2
    eps: float = 0.0
    weight_decay: float = 0.0


def _activation_code(layer):
    from tinynn_autograd_tpu_torch.nn.layers import ReLU, Sigmoid, Tanh

    return {ReLU: ACT_RELU, Sigmoid: ACT_SIGMOID,
            Tanh: ACT_TANH}.get(type(layer))


def _dense_indices(net):
    from tinynn_autograd_tpu_torch.nn.layers import Dense

    return [i for i, layer in enumerate(net.layers)
            if isinstance(layer, Dense)]


def unsupported_reason(net, params_tree, optimizer, loss, batch_shape=None):
    """Why the kernel cannot run this (net, optimizer, loss), or None when
    it can. ``batch_shape`` ([batch, *features]), where given, also checks
    the input layout and counts the activations in the state."""
    from tinynn_autograd_tpu_torch.nn.layers import Dense, Flatten
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.optimizer import SGD, Adam

    prev_dense = False
    for layer in net.layers:
        if getattr(layer, "compute_dtype", None) is not None:
            return ("layer %s sets compute_dtype: the kernel runs f32 math"
                    % layer.name)
        if isinstance(layer, Dense):
            prev_dense = True
        elif _activation_code(layer) is not None:
            if not prev_dense:
                return ("activation %s does not directly follow a Dense "
                        "layer" % layer.name)
            prev_dense = False
        elif isinstance(layer, Flatten):
            prev_dense = False
        else:
            return "layer %s is not Dense, ReLU, Sigmoid, Tanh or Flatten" \
                % type(layer).__name__
    dense = _dense_indices(net)
    if not dense:
        return "the net has no Dense layer"
    if len(dense) > MAX_LAYERS:
        return "more than %d Dense layers" % MAX_LAYERS
    if batch_shape is not None and len(batch_shape) != 2 and not any(
            isinstance(layer, Flatten) for layer in net.layers[:dense[0]]):
        return ("inputs of shape %s reach the first Dense layer without a "
                "Flatten" % (tuple(batch_shape),))
    if type(optimizer) not in (SGD, Adam):
        return "optimizer %s is not SGD or Adam" % type(optimizer).__name__
    if callable(optimizer.lr) or not isinstance(optimizer.lr, numbers.Real):
        return "the learning rate is not a number (a schedule?)"
    if optimizer.clip_norm is not None:
        return "clip_norm needs a global gradient norm"
    if type(loss) is not SoftmaxCrossEntropyLoss:
        return "loss %s is not SoftmaxCrossEntropyLoss" % type(loss).__name__
    for i in dense:
        leaves = params_tree[i]
        if "w" not in leaves or "b" not in leaves:
            return "Dense layer %d has no parameters yet" % i
        if leaves["w"].dtype != torch.float32:
            return "Dense layer %d holds %s parameters" % (i, leaves["w"].dtype)
    n_floats = sum(v.numel() for i in dense for v in params_tree[i].values())
    state = n_floats * (2 + len(optimizer.slot_names))  # + grads
    if batch_shape is not None:
        widths = sum(params_tree[i]["w"].shape[1] for i in dense)
        state += 3 * batch_shape[0] * widths  # z, h, dz
    if 4 * state > STATE_BUDGET:
        return ("the state (%d bytes) exceeds the %d-byte budget"
                % (4 * state, STATE_BUDGET))
    return None


def supports(net, params_tree, optimizer, loss, batch_shape=None):
    """Can this (net, optimizer, loss) run as one whole-epoch kernel?"""
    return unsupported_reason(net, params_tree, optimizer, loss,
                              batch_shape) is None


def layer_descriptor(net):
    """(d_in, d_out, activation code) for each Dense layer, in order: what
    the wrapper packs for the C side."""
    dense = _dense_indices(net)
    out = []
    for i in dense:
        layer = net.layers[i]
        nxt = net.layers[i + 1] if i + 1 < len(net.layers) else None
        act = _activation_code(nxt) if nxt is not None else None
        d_in, d_out = (int(d) for d in layer.params["w"].shape)
        out.append((d_in, d_out, ACT_NONE if act is None else act))
    return out


def epoch_spec(net, optimizer):
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam

    if isinstance(optimizer, Adam):
        return EpochSpec(
            tuple(layer_descriptor(net)), OPT_ADAM,
            b1c=float(np.float32(1.0 - optimizer._b1)),
            b2c=float(np.float32(1.0 - optimizer._b2)),
            eps=float(np.float32(optimizer._eps)),
            weight_decay=float(np.float32(optimizer.weight_decay)))
    return EpochSpec(tuple(layer_descriptor(net)), OPT_SGD,
                     weight_decay=float(np.float32(optimizer.weight_decay)))


def dense_leaves(net, tree):
    """[(w, b)] for each Dense layer of a list-of-dicts tree."""
    return [(tree[i]["w"], tree[i]["b"]) for i in _dense_indices(net)]


def build_fused_epoch(net, loss_fn, optimizer, n_steps, batch_shape,
                      label_shape):
    """Returns ``epoch_fn(params, slots, t0, xb, yb) -> (t, losses)``.

    ``params`` is the model's parameter tree and ``slots`` the optimizer's
    slot trees by name; both are updated in place. ``t0`` is the step count
    before the epoch, ``t`` the count after it. ``xb`` is [n_steps,
    *batch_shape], ``yb`` [n_steps, *label_shape]; ``losses`` [n_steps]."""
    reason = unsupported_reason(net, net.params_tree(), optimizer, loss_fn,
                                batch_shape)
    if reason is not None:
        raise ValueError("the whole-epoch kernel cannot run this net: "
                         + reason)
    spec = epoch_spec(net, optimizer)
    batch = int(batch_shape[0])
    features = int(np.prod(batch_shape[1:]))
    if features != spec.layers[0][0] or tuple(label_shape) != (
            batch, spec.layers[-1][1]):
        raise ValueError(
            "batches %s -> %s do not fit the net's %d inputs and %d outputs"
            % (tuple(batch_shape), tuple(label_shape), spec.layers[0][0],
               spec.layers[-1][1]))
    weight = loss_fn._weight

    def epoch_fn(params, slots, t0, xb, yb):
        xb = xb.reshape(n_steps, batch, features)
        yb = yb.reshape(n_steps, batch, spec.layers[-1][1])
        scalars = torch.from_numpy(
            optimizer.step_scalars(t0, n_steps)).to(xb.device)
        run = (fused_epoch_reference if xb.device.type == "cpu"
               else cuda_fused_epoch)
        losses = run(spec, dense_leaves(net, params),
                     {name: dense_leaves(net, slots[name])
                      for name in optimizer.slot_names},
                     xb, yb, scalars,
                     None if weight is None else weight.to(xb.device),
                     bf16=kernels.matmul_precision() == "bf16")
        return t0 + n_steps, losses

    return epoch_fn


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _activate(act, z):
    if act == ACT_RELU:
        return torch.clamp(z, min=0)
    if act == ACT_SIGMOID:
        return torch.sigmoid(z)
    if act == ACT_TANH:
        return torch.tanh(z)
    return z


def _activation_grad(act, g, z, h):
    """The tape's VJPs: ReLU's subgradient is 1 at 0; Sigmoid and Tanh take
    their derivative from the output."""
    if act == ACT_RELU:
        return g * (z >= 0)
    if act == ACT_SIGMOID:
        return g * h * (1.0 - h)
    if act == ACT_TANH:
        return g * (1.0 - h * h)
    return g


def fused_epoch_reference(spec, params, slots, xb, yb, scalars,
                          class_weight=None, bf16=False):
    """The kernel's function in plain PyTorch: ``params`` ([(w, b)] per
    Dense) and ``slots`` ({"m": [(w, b)], "v": [(w, b)]} for Adam, {} for
    SGD) are updated in place over the ``n_steps`` steps of ``xb``
    [n_steps, B, F] and ``yb`` [n_steps, B, C]; ``scalars`` [n_steps, 2]
    are the optimizer's per-step scalars (``step_scalars``). Returns the
    losses [n_steps]. With ``bf16`` each product operand is rounded to bf16
    and the products are summed in f32."""
    if bf16:
        def mm(a, b):
            return kernels.matmul_reference(a.to(torch.bfloat16).float(),
                                            b.to(torch.bfloat16).float())
    else:
        mm = kernels.matmul_reference
    n_steps, batch = xb.shape[0], xb.shape[1]
    acts = [act for _, _, act in spec.layers]
    losses = torch.empty(n_steps, dtype=torch.float32, device=xb.device)
    for s in range(n_steps):
        y = yb[s]
        hs, zs = [xb[s]], []
        for act, (w, b) in zip(acts, params):
            zs.append(mm(hs[-1], w) + b)
            hs.append(_activate(act, zs[-1]))
        # softmax cross-entropy, as nn/losses.py and its tape
        log_p = torch.log_softmax(hs[-1], dim=-1)
        nll = -(log_p * y).sum(dim=1, keepdim=True)
        g = torch.full((batch, 1), 1.0 / batch, device=xb.device)
        if class_weight is not None:
            per_sample_w = (y * class_weight).sum(dim=1, keepdim=True)
            nll = nll * per_sample_w
            g = g * per_sample_w
        losses[s] = nll.sum() / batch
        g_log_p = -g * y
        dz = g_log_p - torch.exp(log_p) * g_log_p.sum(dim=-1, keepdim=True)
        dz = _activation_grad(acts[-1], dz, zs[-1], hs[-1])
        # backward: every gradient before any weight changes
        grads = [None] * len(params)
        for l in reversed(range(len(params))):
            grads[l] = (mm(hs[l].T, dz), dz.sum(dim=0, keepdim=True))
            if l > 0:
                dz = _activation_grad(acts[l - 1], mm(dz, params[l][0].T),
                                      zs[l - 1], hs[l])
        # the optimizer, as nn/optimizer.py
        scale, rsqrt_c2 = scalars[s, 0], scalars[s, 1]
        for l, (pair, grad_pair) in enumerate(zip(params, grads)):
            for j, (p, grad) in enumerate(zip(pair, grad_pair)):
                if spec.optimizer == OPT_ADAM:
                    m, v = slots["m"][l][j], slots["v"][l][j]
                    m.add_(spec.b1c * (grad - m))
                    v.add_(spec.b2c * (grad * grad - v))
                    step = scale * m / (torch.sqrt(v) * rsqrt_c2 + spec.eps)
                else:
                    step = scale * grad
                if spec.weight_decay:
                    step = step - spec.weight_decay * p
                p.add_(step)
    return losses


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _bind(lib, ctypes):
    ptr = ctypes.c_void_p
    lib.tinynn_fused_epoch.argtypes = (
        [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
         ctypes.POINTER(ctypes.c_void_p)] + [ptr] * 6
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
        + [ctypes.c_int, ptr, ptr])
    lib.tinynn_fused_epoch.restype = ctypes.c_int
    lib.tinynn_fused_epoch_grid.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.tinynn_fused_epoch_grid.restype = ctypes.c_int


def kernel_grid():
    """(co-resident blocks per SM, SMs): the launch's grid on the current
    CUDA device."""
    import ctypes

    lib = kernels.load_library("fused_epoch", _bind)
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.tinynn_fused_epoch_grid(ctypes.byref(per_sm), ctypes.byref(sms))
    if err != 0:
        raise RuntimeError("occupancy query failed: CUDA error %d" % err)
    return per_sm.value, sms.value


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


def phase_names(spec):
    """The kernel's phases in the order of ``phase_ns``."""
    n = len(spec.layers)
    return (["forward %d" % l for l in range(n)] + ["loss"]
            + ["backward %d" % l for l in reversed(range(n))]
            + ["optimizer"])


def cuda_fused_epoch(spec, params, slots, xb, yb, scalars,
                     class_weight=None, bf16=False, phase_ns=None):
    """``fused_epoch_reference``'s function through the hand-written CUDA
    kernel: one cooperative launch for the whole epoch, ``params`` and
    ``slots`` updated in place. Every tensor is a contiguous float32 CUDA
    tensor on one device. ``phase_ns``, an int64 CUDA tensor with one entry
    per ``phase_names(spec)``, accumulates block 0's time in each phase,
    barrier wait included (a trace; None turns it off). Raises on anything
    the kernel does not take and when the launch fails; never computes the
    epoch another way."""
    device = xb.device
    if device.type != "cuda":
        raise ValueError("cuda_fused_epoch needs CUDA tensors, got %s"
                         % device)
    n_layers = len(spec.layers)
    if not 1 <= n_layers <= MAX_LAYERS or len(params) != n_layers:
        raise ValueError("%d layers in the spec, %d parameter pairs (at most "
                         "%d)" % (n_layers, len(params), MAX_LAYERS))
    adam = spec.optimizer == OPT_ADAM
    if spec.optimizer not in (OPT_SGD, OPT_ADAM) or set(slots) != (
            {"m", "v"} if adam else set()):
        raise ValueError("optimizer %d with slots %s"
                         % (spec.optimizer, sorted(slots)))
    if xb.ndim != 3 or yb.ndim != 3:
        raise ValueError("xb and yb must be [n_steps, batch, features]")
    n_steps, batch = xb.shape[0], xb.shape[1]
    _check("xb", xb, device, (n_steps, batch, spec.layers[0][0]))
    _check("yb", yb, device, (n_steps, batch, spec.layers[-1][1]))
    _check("scalars", scalars, device, (n_steps, 2))
    if class_weight is not None:
        _check("class_weight", class_weight, device, (spec.layers[-1][1],))
    if phase_ns is not None and (
            phase_ns.device != device or phase_ns.dtype != torch.int64
            or tuple(phase_ns.shape) != (2 * n_layers + 2,)):
        raise ValueError("phase_ns must be an int64 [%d] tensor on %s"
                         % (2 * n_layers + 2, device))
    if not (0 < n_steps < 2 ** 31 and 0 < batch < 2 ** 31):
        raise ValueError("epoch of %d steps of %d rows is out of range"
                         % (n_steps, batch))

    import ctypes

    # `scratch` holds the gradients and activations until the launch is
    # queued: freed earlier, the caching allocator would hand one layer's
    # buffers to the next. After the launch it may reuse them: they were
    # allocated on the stream the kernel runs on.
    dims, ptrs, scratch = [], [], []
    prev_out = spec.layers[0][0]
    for l, (d_in, d_out, act) in enumerate(spec.layers):
        if d_in != prev_out or act not in (ACT_NONE, ACT_RELU, ACT_SIGMOID,
                                           ACT_TANH):
            raise ValueError("layer %d: (%d, %d, %d) does not chain"
                             % (l, d_in, d_out, act))
        prev_out = d_out
        w, b = params[l]
        _check("w%d" % l, w, device, (d_in, d_out))
        _check("b%d" % l, b, device, (1, d_out))
        leaves = [w, b, torch.empty_like(w), torch.empty_like(b)]
        for name in ("m", "v"):
            if adam:
                sw, sb = slots[name][l]
                _check("%s_w%d" % (name, l), sw, device, (d_in, d_out))
                _check("%s_b%d" % (name, l), sb, device, (1, d_out))
                leaves += [sw, sb]
            else:
                leaves += [None, None]
        z = torch.empty((batch, d_out), dtype=torch.float32, device=device)
        h = z if act == ACT_NONE else torch.empty_like(z)
        leaves += [z, h, torch.empty_like(z)]
        scratch.append(leaves)
        dims += [d_in, d_out, act]
        ptrs += [0 if t is None else t.data_ptr() for t in leaves]
    losses = torch.empty(n_steps, dtype=torch.float32, device=device)
    row_loss = torch.empty(batch, dtype=torch.float32, device=device)

    lib = kernels.load_library("fused_epoch", _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tinynn_fused_epoch(
            n_layers, (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            xb.data_ptr(), yb.data_ptr(),
            0 if class_weight is None else class_weight.data_ptr(),
            scalars.data_ptr(), losses.data_ptr(), row_loss.data_ptr(),
            batch, n_steps, spec.optimizer, spec.b1c, spec.b2c, spec.eps,
            spec.weight_decay, int(bool(bf16)),
            0 if phase_ns is None else phase_ns.data_ptr(), stream)
    del scratch
    if err == 801:  # cudaErrorNotSupported
        raise RuntimeError("the device cannot launch cooperative kernels")
    if err != 0:
        raise RuntimeError("fused epoch kernel launch failed: CUDA error %d"
                           % err)
    cuda_fused_epoch.launches += 1
    return losses


cuda_fused_epoch.launches = 0
