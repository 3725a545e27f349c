"""Learning-rate schedules, as in the JAX package's nn/scheduler.py.

A schedule is a plain callable ``t -> lr``: pass one as the ``lr`` of any
optimizer. The step counter ``t`` is a host integer here, so a schedule is
evaluated on the host, in f32 as the JAX package evaluates it on its device
counter, and returns a Python float. The kernels take the learning rate as a
per-step launch argument, so a schedule costs them nothing.
"""

import numpy as np

_F = np.float32


def _clip01(x):
    return _F(min(max(x, _F(0.0)), _F(1.0)))


def _cosine(frac):
    return _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * frac))


class Schedule:

    def __call__(self, t):
        raise NotImplementedError


class ConstantLR(Schedule):

    def __init__(self, lr):
        self.lr = lr

    def __call__(self, t):
        return self.lr


class StepDecayLR(Schedule):
    """lr * gamma ** floor(t / step_size)."""

    def __init__(self, lr, step_size, gamma=0.1):
        self.lr = lr
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, t):
        k = _F(int(t) // self.step_size)
        return float(_F(self.lr) * _F(self.gamma) ** k)


class ExponentialDecayLR(Schedule):
    """lr * decay_rate ** (t / decay_steps)."""

    def __init__(self, lr, decay_steps, decay_rate):
        self.lr = lr
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate

    def __call__(self, t):
        return float(_F(self.lr) * _F(self.decay_rate)
                     ** (_F(t) / _F(self.decay_steps)))


class CosineDecayLR(Schedule):
    """Cosine anneal from lr to alpha*lr over decay_steps."""

    def __init__(self, lr, decay_steps, alpha=0.0):
        self.lr = lr
        self.decay_steps = decay_steps
        self.alpha = alpha

    def __call__(self, t):
        cosine = _cosine(_clip01(_F(t) / _F(self.decay_steps)))
        return float(_F(self.lr) * (_F(1.0 - self.alpha) * cosine
                                    + _F(self.alpha)))


class WarmupCosineLR(Schedule):
    """Linear warmup for warmup_steps, then cosine decay to alpha*lr."""

    def __init__(self, lr, warmup_steps, decay_steps, alpha=0.0):
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps
        self.alpha = alpha

    def __call__(self, t):
        tf = _F(t)
        if tf < _F(self.warmup_steps):
            return float(_F(self.lr) * tf / _F(max(self.warmup_steps, 1)))
        frac = _clip01((tf - _F(self.warmup_steps))
                       / _F(max(self.decay_steps - self.warmup_steps, 1)))
        return float(_F(self.lr) * (_F(1.0 - self.alpha) * _cosine(frac)
                                    + _F(self.alpha)))
