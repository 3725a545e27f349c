"""Optimizers as per-leaf updates over the parameter tree (a list of
per-layer dicts), as in the JAX package's nn/optimizer.py: ``BaseOptimizer``
with ``weight_decay`` and global-norm ``clip_norm``, and the seven rules
``SGD``, ``Momentum``, ``Adam``, ``Lion``, ``RMSProp``, ``Adagrad`` and
``Adadelta``, each in the JAX package's algebraic form (``rsqrt`` where it
uses ``rsqrt``), so that the two agree at rounding level. ``lr`` may be a
number or a schedule (nn/scheduler.py), a callable ``t -> lr`` evaluated on
the host.

Entry points (nn/model.py, parallel/ and the kernels' hosts in ops/ reach a
step's update only through them):
- ``update(grads, params, state) -> (steps, state)`` and its stateful
  facade ``compute_step(grads, params)``, the step tier's update.
- ``live_state(params)``, ``step_count`` and ``advance(n_steps)``: the
  state, made on first use, and its step count.
- ``scalars_at(t)``/``step_scalars(t0, n_steps)``: a step's scalars;
  ``leaf_update(g, p, scalars, slots)``: one leaf's rule and weight decay.
- ``kernel_rule()``: the code and constants ``csrc/optim_rules.cuh`` reads
  (K2, K3b and P2 apply the same rule at the same scalars).

``steps`` is what gets ADDED to the params (param += step).

Unlike the JAX package's pure update, the optimizer slots (Adam's m and v)
are updated IN PLACE: that saves a second copy of the optimizer state on the
device each step. The step counter ``t`` is a host integer, so the learning
rate and the bias corrections are host scalars and cost no device work.

``slot_dtype``/``stochastic_rounding`` (bf16 optimizer state) are not ported
yet and raise.
"""

import builtins

import numpy as np
import torch

from tinynn_autograd_tpu_torch.core.tensor import to_torch


def _leaf_keys(tree):
    """(layer index, key) of every leaf of a list-of-dicts tree, in the JAX
    package's flatten order: layers in order, keys sorted."""
    return [(i, k) for i, d in enumerate(tree) for k in sorted(d)]


def _tree_of(obj):
    """Coerce list-of-dicts possibly holding Tensors into torch tensors."""
    return [{k: to_torch(v) for k, v in d.items()} for d in obj]


class BaseOptimizer:

    # names of per-parameter state slots, e.g. ("m", "v") for Adam
    slot_names = ()
    # the rule's code in csrc/optim_rules.cuh (its ``Opt`` enum); None: no
    # kernel applies it
    kernel_code = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # a subclass may change the rule, so it inherits no kernel code
        cls.kernel_code = cls.__dict__.get("kernel_code")

    def __init__(self, lr, weight_decay=0.0, slot_dtype=None,
                 stochastic_rounding=False, clip_norm=None):
        """``clip_norm``: global-norm gradient clipping (torch semantics:
        grads scaled by min(1, clip_norm / (||g||_2 + 1e-6)) over ALL leaves
        jointly), applied inside ``update`` before the rule."""
        if slot_dtype is not None or stochastic_rounding:
            raise NotImplementedError(
                "slot_dtype/stochastic_rounding are not ported to the "
                "PyTorch package yet (see ROADMAP.md, queue 1)")
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self._state = None

    # ------------------------------------------------------ functional API

    def init_state(self, params):
        slots = {
            name: [{k: torch.zeros_like(v) for k, v in d.items()}
                   for d in params]
            for name in self.slot_names
        }
        return {"t": 0, "slots": slots}

    def step_leaf(self, g, lr, t, slots):
        """Apply the rule to one leaf: the slots are updated in place, the
        step is returned in the gradient's dtype. Returns (step, slots)."""
        return self.rule(g, self.scalars(lr, t), slots).to(g.dtype), slots

    def leaf_update(self, g, p, scalars, slots):
        """One leaf's step at the step's ``scalars``: the rule, in the
        gradient's dtype, then weight decay on the parameter ``p``. The
        slots are updated in place; ``p`` is not touched."""
        step = self.rule(g, scalars, slots).to(g.dtype)
        if self.weight_decay:
            step = step - self.weight_decay * p
        return step

    def update(self, grads, params, state):
        """Returns (steps, state). ``state``'s slots are updated in place and
        its step counter advances; ``params`` are not touched."""
        t = state["t"] + 1
        scalars = self.scalars_at(t)

        keys = _leaf_keys(grads)
        g_leaves = [grads[i][k] for i, k in keys]
        if self.clip_norm is not None and g_leaves:
            total = torch.sqrt(builtins.sum(
                torch.sum(g.float() ** 2) for g in g_leaves))
            scale = torch.clamp(self.clip_norm / (total + 1e-6), max=1.0)
            g_leaves = [g * scale.to(g.dtype) for g in g_leaves]

        steps = [{} for _ in grads]
        for (i, k), g in zip(keys, g_leaves):
            p = params[i][k]
            slots_i = {n: state["slots"][n][i][k] for n in self.slot_names}
            steps[i][k] = self.leaf_update(g.to(p.dtype), p, scalars, slots_i)
        state["t"] = t
        return steps, state

    def rule(self, g, scalars, slots):
        """One leaf's step (before weight decay) from its gradient, the
        step's ``scalars`` and its slots, which are updated in place."""
        raise NotImplementedError

    def scalars(self, lr, t):
        """(s0, s1), the f32 scalars of step ``t`` at learning rate ``lr``
        that ``rule`` multiplies by: (-lr, 0) unless the rule says
        otherwise."""
        return float(-np.float32(lr)), 0.0

    def scalars_at(self, t):
        """The scalars of step ``t`` at the learning rate ``lr`` gives it:
        the schedule's ``lr(t)``, or ``lr`` itself when it is a number."""
        return self.scalars(self.lr(t) if callable(self.lr) else self.lr, t)

    def step_scalars(self, t0, n_steps):
        """[n_steps, 2] float32: the scalars of steps t0+1 ... t0+n_steps,
        computed as ``update`` computes them."""
        return np.array([self.scalars_at(t)
                         for t in range(t0 + 1, t0 + 1 + n_steps)],
                        np.float32).reshape(n_steps, 2)

    def kernel_rule(self):
        """(code, (c0, c1, c2, c3)): the rule's code and constants as
        csrc/optim_rules.cuh reads them, the f32 values ``rule`` multiplies
        by, from the attributes as they are at the call."""
        if self.kernel_code is None:
            raise ValueError("optimizer %s has no rule in the kernel"
                             % type(self).__name__)
        consts = self._kernel_constants() + (0.0,) * 4
        return self.kernel_code, tuple(float(np.float32(c))
                                       for c in consts[:4])

    def _kernel_constants(self):
        return ()  # c0, c1, ...; the rest are 0

    # ------------------------------------------------ the state's lifetime

    def live_state(self, params):
        """The optimizer's state, made from the parameter tree ``params``
        (zero slots, step 0) when there is none."""
        if self._state is None:
            self._state = self.init_state(params)
        return self._state

    @property
    def step_count(self):
        """The steps taken: 0 while there is no state."""
        return 0 if self._state is None else self._state["t"]

    def advance(self, n_steps):
        """Count ``n_steps`` steps that a kernel applied to the live state
        (K2's epoch, the streaming tier's step)."""
        self._state["t"] += n_steps

    # ----------------------------------------- reference-compatible facade

    def compute_step(self, grads, params):
        """Stateful eager facade: same list-of-dicts structures in/out."""
        params_t = _tree_of(params)
        steps, _ = self.update(_tree_of(grads), params_t,
                               self.live_state(params_t))
        return steps

    def reset(self):
        self._state = None

    def state_dict(self):
        return self._state

    def load_state_dict(self, state):
        self._state = state


class SGD(BaseOptimizer):
    """step = -lr * g."""

    kernel_code = 0

    def __init__(self, lr, weight_decay=0.0, clip_norm=None):
        super().__init__(lr, weight_decay, clip_norm=clip_norm)

    def rule(self, g, scalars, slots):
        return scalars[0] * g


class Momentum(BaseOptimizer):
    """acc = momentum * acc + g; step = -lr * acc."""

    slot_names = ("acc",)
    kernel_code = 2

    def __init__(self, lr, momentum=0.9, weight_decay=0.0,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._momentum = momentum

    def rule(self, g, scalars, slots):
        acc = slots["acc"].mul_(self._momentum).add_(g)
        return scalars[0] * acc

    def _kernel_constants(self):
        return (self._momentum,)


class Adam(BaseOptimizer):
    """EMA moments with bias correction:
    m += (1-b1)(g - m); v += (1-b2)(g^2 - v);
    step = -lr * m_hat / (sqrt(v_hat) + eps).
    """

    slot_names = ("m", "v")
    kernel_code = 1

    def __init__(self, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.0, slot_dtype=None,
                 stochastic_rounding=False, clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._b1 = beta1
        self._b2 = beta2
        self._eps = epsilon

    def scalars(self, lr, t):
        """(-(lr/c1), rsqrt(c2)) of step t. The JAX package's algebraic
        form, in f32, so the two agree at rounding level: b**t = exp(t*ln b),
        and the bias corrections are folded into scalars:
          -lr * m_hat / (sqrt(v_hat) + eps)
            == -(lr/c1) * m / (sqrt(v) * rsqrt(c2) + eps)"""
        tf = np.float32(t)
        one = np.float32(1.0)
        c1 = one - np.exp(tf * np.log(np.float32(self._b1)))
        c2 = one - np.exp(tf * np.log(np.float32(self._b2)))
        return float(-(np.float32(lr) / c1)), float(one / np.sqrt(c2))

    def rule(self, g, scalars, slots):
        m, v = slots["m"], slots["v"]
        m.add_((1.0 - self._b1) * (g - m))
        v.add_((1.0 - self._b2) * (g * g - v))
        scale, rsqrt_c2 = scalars
        return scale * m / (torch.sqrt(v) * rsqrt_c2 + self._eps)

    def _kernel_constants(self):
        return (1.0 - self._b1, 1.0 - self._b2, self._eps)


class Lion(BaseOptimizer):
    """Lion (Chen et al. 2023): the step is the sign of an interpolated
    momentum, u = sign(b1 * m + (1 - b1) * g), step = -lr * u; then
    m = b2 * m + (1 - b2) * g."""

    slot_names = ("m",)
    kernel_code = 3

    def __init__(self, lr=1e-4, beta1=0.9, beta2=0.99, weight_decay=0.0,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._b1 = beta1
        self._b2 = beta2

    def rule(self, g, scalars, slots):
        m = slots["m"]
        u = torch.sign(self._b1 * m + (1.0 - self._b1) * g)
        m.mul_(self._b2).add_((1.0 - self._b2) * g)
        return scalars[0] * u

    def _kernel_constants(self):
        return (self._b1, 1.0 - self._b1, self._b2, 1.0 - self._b2)


class RMSProp(BaseOptimizer):
    """ms += (1-decay)(g^2 - ms);
    mom = momentum*mom + lr*g*rsqrt(ms + eps); step = -mom."""

    slot_names = ("ms", "mom")
    kernel_code = 4

    def __init__(self, lr=0.01, decay=0.99, momentum=0.0, epsilon=1e-8,
                 weight_decay=0.0, slot_dtype=None,
                 stochastic_rounding=False, clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._decay = decay
        self._momentum = momentum
        self._eps = epsilon

    def scalars(self, lr, t):
        """(lr, 0): the rule adds lr * g * rsqrt(...) to its momentum."""
        return float(np.float32(lr)), 0.0

    def rule(self, g, scalars, slots):
        ms, mom = slots["ms"], slots["mom"]
        ms.add_((1.0 - self._decay) * (g * g - ms))
        mom.mul_(self._momentum).add_(
            scalars[0] * g * torch.rsqrt(ms + self._eps))
        return -mom

    def _kernel_constants(self):
        return (1.0 - self._decay, self._momentum, self._eps)


class Adagrad(BaseOptimizer):
    """G += g^2; step = -lr * g * rsqrt(G + eps)."""

    slot_names = ("G",)
    kernel_code = 5

    def __init__(self, lr, weight_decay=0.0, epsilon=1e-8,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._eps = epsilon

    def rule(self, g, scalars, slots):
        G = slots["G"].add_(g * g)
        return scalars[0] * g * torch.rsqrt(G + self._eps)

    def _kernel_constants(self):
        return (self._eps,)


class Adadelta(BaseOptimizer):
    """Zeiler 2012: Eg += (1-decay)(g^2 - Eg);
    delta = g * sqrt(d + eps) * rsqrt(Eg + eps); step = -lr * delta;
    d += (1-decay)(delta^2 - d)."""

    slot_names = ("Eg", "d")
    kernel_code = 6

    def __init__(self, lr=1.0, weight_decay=0.0, decay=0.9, epsilon=1e-8,
                 slot_dtype=None, stochastic_rounding=False,
                 clip_norm=None):
        super().__init__(lr, weight_decay, slot_dtype, stochastic_rounding,
                         clip_norm)
        self._decay = decay
        self._eps = epsilon

    def rule(self, g, scalars, slots):
        Eg, d = slots["Eg"], slots["d"]
        Eg.add_((1.0 - self._decay) * (g * g - Eg))
        delta = g * torch.sqrt(d + self._eps) * torch.rsqrt(Eg + self._eps)
        d.add_((1.0 - self._decay) * (delta * delta - d))
        return scalars[0] * delta

    def _kernel_constants(self):
        return (1.0 - self._decay, self._eps)
