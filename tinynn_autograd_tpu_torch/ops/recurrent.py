"""Recurrent sequence primitives: LSTM and GRU as one tape edge each.

PyTorch counterpart of the JAX package's ops/recurrent.py. The whole time
recurrence of a layer is ONE primitive with a hand-written VJP:

- the input projection is hoisted out of the recurrence: one [T*B, D] x
  [D, G*H] ``kernels.matmul`` for all steps (K1 on a GPU);
- the serial part, one [B, H] x [H, G*H] product and the gate arithmetic a
  step, is one launch of the recurrent kernel (``ops/recurrent_kernel.py``,
  K5 for the LSTM, K5c for the GRU);
- the backward is one launch of the reverse kernel (K5b, K5d), which emits
  the per-step gate cotangents, followed by the products that are not on
  the serial chain: dx, dWx and dWh as [T*B, .] ``kernels.matmul``s, db as
  a sum. dx is made only when the input needs a gradient.

The joint backward is memoised: one reverse pass per cotangent however many
inputs need a gradient.

Layout (the JAX package's): x [B, T, D] at the API ([T, B, D] inside),
wx [D, G*H], wh [H, G*H], b [1, G*H], gates fused on the last axis (LSTM
i, f, g, o; GRU z, r, n); the output is the hidden sequence [B, T, H].
``reverse=True`` runs the recurrence backwards in time with outputs aligned
to their input positions (the backward half of a bidirectional RNN).

``impl``: None runs the kernels for CUDA tensors and the plain versions
for CPU tensors; "plain" asks for the plain versions on the card too. A CUDA
tensor the kernels do not take raises ``ValueError`` naming the rule;
nothing falls back.
"""

import torch

from tinynn_autograd_tpu_torch.ops import kernels
from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk


def _use_kernels(impl, x):
    if impl not in (None, "plain"):
        raise ValueError("impl must be None (the tensors' device decides) or "
                         "'plain', got %r" % (impl,))
    return impl is None and x.is_cuda


def _check(x, wx, wh, b, gates):
    if x.ndim != 3:
        raise ValueError("recurrent input must be [B, T, D], got %s"
                         % (tuple(x.shape),))
    H = wh.shape[0]
    want = {"wx": (x.shape[2], gates * H), "wh": (H, gates * H),
            "b": (1, gates * H)}
    for name, t in (("wx", wx), ("wh", wh), ("b", b)):
        if tuple(t.shape) != want[name]:
            raise ValueError("%s of shape %s, expected %s" % (
                name, tuple(t.shape), want[name]))
    return x.shape[0], x.shape[1], x.shape[2], H


def _shifted(seq, first, reverse):
    """The state entering each step: ``seq`` shifted one step in time, with
    ``first`` where the walk starts."""
    if reverse:
        return torch.cat([seq[1:], first[None]], dim=0)
    return torch.cat([first[None], seq[:-1]], dim=0)


def _post_scan(dz_flat, da_flat, xt, hprev, wx, need_dx):
    """The products after the reverse kernel: dx = da wx^T (when needed),
    dWx = x^T da, dWh = hprev^T dz, db = sum_rows da. For the LSTM dz and
    da are the same gate cotangents; for the GRU dz is du."""
    T, B, D = xt.shape
    H = hprev.shape[2]
    dx = None
    if need_dx:
        dx = kernels.matmul(da_flat, wx.T).reshape(T, B, D).transpose(0, 1)
    dwx = kernels.matmul(xt.reshape(T * B, D).T, da_flat)
    dwh = kernels.matmul(hprev.reshape(T * B, H).T, dz_flat)
    db = da_flat.sum(dim=0, keepdim=True)
    return dx, dwx, dwh, db


def lstm_scan_(ts_x, ts_wx, ts_wh, ts_b, h0=None, c0=None, reverse=False,
               impl=None):
    """LSTM over [B, T, D] -> hidden sequence [B, T, H] as one tape edge.

        z = x_t @ wx + h @ wh + b
        i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
        c = f * c_prev + i * g
        h = o * tanh(c)

    ``h0``/``c0`` are optional Tensors [B, H] (zeros when omitted); their
    gradients come out of the reverse kernel's final carry."""
    x, wx, wh, b = ts_x.data, ts_wx.data, ts_wh.data, ts_b.data
    B, T, D, H = _check(x, wx, wh, b, 4)
    h0a = x.new_zeros((B, H)) if h0 is None else h0.data
    c0a = x.new_zeros((B, H)) if c0 is None else c0.data
    xt = x.transpose(0, 1)  # [T, B, D]
    xp = (kernels.matmul(xt.reshape(T * B, D), wx) + b).reshape(T, B, 4 * H)
    on_card = _use_kernels(impl, x)
    forward = rk.cuda_lstm_forward if on_card else rk.lstm_forward_reference
    hs, cs, gates = forward(xp, wh, h0a, c0a, reverse=reverse)

    def joint_bwd(grad):
        gt = grad.to(x.dtype).transpose(0, 1).contiguous()  # [T, B, H]
        cprev = _shifted(cs, c0a, reverse)
        hprev = _shifted(hs, h0a, reverse)
        backward = (rk.cuda_lstm_backward if on_card
                    else rk.lstm_backward_reference)
        dzs, dh0, dc0 = backward(gt, gates, cs, cprev, wh.T, reverse=reverse)
        dz_flat = dzs.reshape(T * B, 4 * H)
        dx, dwx, dwh, db = _post_scan(dz_flat, dz_flat, xt, hprev, wx,
                                      ts_x.requires_grad)
        return dx, dwx, dwh, db, dh0, dc0

    return _build_recurrent_node(ts_x, ts_wx, ts_wh, ts_b, h0, c0,
                                 hs.transpose(0, 1), joint_bwd)


def gru_scan_(ts_x, ts_wx, ts_wh, ts_b, h0=None, reverse=False, impl=None):
    """GRU over [B, T, D] -> hidden sequence [B, T, H] as one tape edge
    (single-bias form: the reset gate multiplies the hidden contribution):

        a = x_t @ wx + b;   u = h @ wh
        z = sigmoid(a_z + u_z);  r = sigmoid(a_r + u_r)
        n = tanh(a_n + r * u_n)
        h' = (1 - z) * n + z * h
    """
    x, wx, wh, b = ts_x.data, ts_wx.data, ts_wh.data, ts_b.data
    B, T, D, H = _check(x, wx, wh, b, 3)
    h0a = x.new_zeros((B, H)) if h0 is None else h0.data
    xt = x.transpose(0, 1)
    ap = (kernels.matmul(xt.reshape(T * B, D), wx) + b).reshape(T, B, 3 * H)
    on_card = _use_kernels(impl, x)
    forward = rk.cuda_gru_forward if on_card else rk.gru_forward_reference
    hs, gates, un = forward(ap, wh, h0a, reverse=reverse)

    def joint_bwd(grad):
        gt = grad.to(x.dtype).transpose(0, 1).contiguous()
        hprev = _shifted(hs, h0a, reverse)
        backward = (rk.cuda_gru_backward if on_card
                    else rk.gru_backward_reference)
        das, dus, dh0 = backward(gt, hprev, gates, un, wh.T, reverse=reverse)
        dx, dwx, dwh, db = _post_scan(dus.reshape(T * B, 3 * H),
                                      das.reshape(T * B, 3 * H), xt, hprev,
                                      wx, ts_x.requires_grad)
        return dx, dwx, dwh, db, dh0, None

    return _build_recurrent_node(ts_x, ts_wx, ts_wh, ts_b, h0, None,
                                 hs.transpose(0, 1), joint_bwd)


def _build_recurrent_node(ts_x, ts_wx, ts_wh, ts_b, h0, c0, out, joint_bwd):
    """The tape node: one dependency per input that needs a gradient, all
    served by one memoised joint backward (a strong reference to the
    cotangent, compared with ``is``, as in ``dense_stack_``)."""
    cache = []  # [grad_object, (dx, dwx, dwh, db, dh0, dc0)]

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, joint_bwd(grad)]
        return cache[1]

    parents = [(ts_x, 0), (ts_wx, 1), (ts_wh, 2), (ts_b, 3), (h0, 4),
               (c0, 5)]
    dependency = [(ts, lambda grad, slot=slot: memo(grad)[slot])
                  for ts, slot in parents
                  if ts is not None and ts.requires_grad]
    return ts_x.__class__(out, bool(dependency), dependency)
