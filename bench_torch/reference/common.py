"""What the references share: the product in a stated precision, the
softmax cross-entropy on one-hot rows (the default loss: a reference
module may define its own ``loss(logits, y)``), Adam, and the readings of
a model's first three train steps.

``precision`` is "f32" (TF32 off: the configurations' own precision) or
"tf32", the nearest precision below it, which serves as the control: each
product's operands rounded to TF32's 10 explicit mantissa bits, to nearest
even, then multiplied in f32, as the tensor cores do in TF32. The rounding
is explicit so that the control reads the same on any device.

A fault planted in a reference put in the program's place (the checks'
test of their own reach):
- "frozen": a step returns its state unchanged;
- "half_batch": each step uses the first half of its batch, the mean taken
  over it;
- "wrong_label": a token altered where it is produced: the first step's
  batch carries its last row's targets moved to the next class (a one-hot
  row rolled by one; ids plus one, modulo the width of the logits);
- "wrong_answer": an answer altered where it is produced: the eval's first
  row reports the second row's logits;
- "fresh_state": the optimizer's state lost between calls: the second
  call starts from zero moments at step 1;
- "wrong_beta2": Adam's beta2 taken as 0.99, a term that matters only from
  the second step on.
"""

import torch
import torch.nn.functional as F

FAULTS = ("frozen", "half_batch", "wrong_label", "wrong_answer",
          "fresh_state", "wrong_beta2")


def exact():
    """Turn TF32 off for every f32 product of this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x):
    """``x`` (f32) rounded to TF32, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with every operand rounded to TF32, in the forward and in the
    backward's two products. ``b`` is 2-D or has ``a``'s batch axes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = g @ tf32(b).transpose(-1, -2)
        if b.ndim == 2 and a.ndim > 2:
            gb = tf32(a).reshape(-1, a.shape[-1]).T @ g.reshape(
                -1, g.shape[-1])
        else:
            gb = tf32(a).transpose(-1, -2) @ g
        return ga, gb


def mm(a, b, precision):
    if precision == "tf32":
        return _TF32Product.apply(a, b)
    if precision != "f32":
        raise ValueError("precision %r" % (precision,))
    return a @ b


def cross_entropy(logits, onehot):
    """Mean over the rows of -sum(labels * log_softmax(logits))."""
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=1).mean()


def wrong_label(y, width):
    """``y`` with its last row's targets moved to the next class: one-hot
    rows (float) rolled by one, class ids plus one modulo ``width``."""
    y = y.clone()
    y[-1] = y[-1].roll(1) if y.is_floating_point() else (y[-1] + 1) % width
    return y


def adam_(p, g, m, v, t, opt):
    """One Adam step of leaf ``p`` in place (Kingma and Ba, with the bias
    corrections)."""
    b1, b2 = opt["beta1"], opt["beta2"]
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    p.sub_(opt["lr"] * m_hat / (v_hat.sqrt() + opt["eps"]))


def train_readings(forward, loss_fn, params, batches, opt, precision="f32",
                   fault=None):
    """The readings of the train steps on ``batches`` [(x, y)] from
    ``params`` ({name: tensor}, copied), each step's loss
    ``loss_fn(logits, y)``: each step's loss, the first step's gradient,
    each leaf's change after the first step and after the last, and Adam's
    moments after the last."""
    if fault == "wrong_beta2":
        opt = dict(opt, beta2=0.99)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad, t = [], None, 0
    for step, (x, y) in enumerate(batches, 1):
        if fault == "half_batch":
            x, y = x[:len(x) // 2], y[:len(y) // 2]
        if fault == "fresh_state" and step == 2:
            t = 0
            for k in params:
                m[k].zero_()
                v2[k].zero_()
        logits = forward(p, x, precision)
        if fault == "wrong_label" and step == 1:
            y = wrong_label(y, logits.shape[-1])
        loss = loss_fn(logits, y)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if grad is None:
            grad = {k: g.detach().clone() for k, g in zip(p, grads)}
        t += 1
        if fault != "frozen":
            with torch.no_grad():
                for (k, leaf), g in zip(p.items(), grads):
                    adam_(leaf, g, m[k], v2[k], t, opt)
        if step == 1:
            first = {k: p[k].detach() - params[k] for k in params}
    if fault == "frozen":
        grad = {k: torch.zeros_like(g) for k, g in grad.items()}
    change = {k: p[k].detach() - params[k] for k in params}
    return {"losses": losses, "grad": grad, "change": change,
            "change_first": first, "state": {"m": m, "v": v2}}


def eval_logits(forward, params, x, precision="f32", fault=None,
                rows=4096):
    """The logits of ``x``, ``rows`` rows at a time."""
    with torch.no_grad():
        out = torch.cat([forward(params, x[i:i + rows], precision)
                         for i in range(0, len(x), rows)])
    if fault == "wrong_answer":
        out[0] = out[1]
    return out
