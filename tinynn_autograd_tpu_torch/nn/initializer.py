"""Parameter initializers: Normal / TruncatedNormal / Uniform / Constant /
Zeros / Ones / Xavier{Uniform,Normal} / He{Uniform,Normal} with conv-aware
``get_fans``, as in the JAX package.

Every draw comes from an explicit CPU ``torch.Generator``: the one passed as
``generator=``, else the seeder's current one (see utils/seeder). The values
are made on the CPU and moved to the device with the rest of the net, so one
seed gives the same weights on every device. The numbers differ from the JAX
package's (another generator); parity tests copy parameters instead.

TruncatedNormalInit truncates at mean ± 2*std for any std, by redrawing the
samples that fall outside.
"""

import numpy as np
import torch

from tinynn_autograd_tpu_torch.core.tensor import Tensor
from tinynn_autograd_tpu_torch.utils import seeder


def get_fans(shape):
    """fan_in/fan_out; 2-D dense [in, out] or 4-D conv [out, in, kh, kw]."""
    fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
    fan_out = shape[1] if len(shape) == 2 else shape[0]
    return fan_in, fan_out


class Initializer:
    """Draw an array and wrap it as a trainable float32 Tensor."""

    def __call__(self, shape, generator=None):
        gen = generator if generator is not None else seeder.generator()
        values = self.init(tuple(int(s) for s in shape), gen)
        return Tensor(values, requires_grad=True, dtype=torch.float32)

    def init(self, shape, generator):
        raise NotImplementedError


class NormalInit(Initializer):

    def __init__(self, mean=0.0, std=1.0):
        self._mean = mean
        self._std = std

    def init(self, shape, generator):
        return self._mean + self._std * torch.randn(shape, generator=generator)


class TruncatedNormalInit(Initializer):
    """N(mean, std) truncated to mean ± 2*std."""

    def __init__(self, mean=0.0, std=1.0):
        self._mean = mean
        self._std = std

    def init(self, shape, generator):
        draw = torch.randn(shape, generator=generator)
        out = draw.abs() > 2.0
        while out.any():
            draw[out] = torch.randn(int(out.sum()), generator=generator)
            out = draw.abs() > 2.0
        return self._mean + self._std * draw


class UniformInit(Initializer):

    def __init__(self, a=0.0, b=1.0):
        self._a = a
        self._b = b

    def init(self, shape, generator):
        return torch.empty(shape).uniform_(self._a, self._b,
                                           generator=generator)


class ConstantInit(Initializer):

    def __init__(self, val):
        self._val = val

    def init(self, shape, generator):
        return torch.full(shape, self._val, dtype=torch.float32)


class ZerosInit(ConstantInit):

    def __init__(self):
        super().__init__(0.0)


class OnesInit(ConstantInit):

    def __init__(self):
        super().__init__(1.0)


class XavierUniformInit(Initializer):
    """U(-a, a), a = gain * sqrt(6 / (fan_in + fan_out)) (Glorot & Bengio
    2010)."""

    def __init__(self, gain=1.0):
        self._gain = gain

    def init(self, shape, generator):
        fan_in, fan_out = get_fans(shape)
        a = float(self._gain * np.sqrt(6.0 / (fan_in + fan_out)))
        return torch.empty(shape).uniform_(-a, a, generator=generator)


class XavierNormalInit(Initializer):
    """N(0, std), std = gain * sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, gain=1.0):
        self._gain = gain

    def init(self, shape, generator):
        fan_in, fan_out = get_fans(shape)
        std = float(self._gain * np.sqrt(2.0 / (fan_in + fan_out)))
        return std * torch.randn(shape, generator=generator)


class HeUniformInit(Initializer):
    """U(-a, a), a = gain * sqrt(6 / fan_in) (He et al. 2015)."""

    def __init__(self, gain=1.0):
        self._gain = gain

    def init(self, shape, generator):
        fan_in, _ = get_fans(shape)
        a = float(self._gain * np.sqrt(6.0 / fan_in))
        return torch.empty(shape).uniform_(-a, a, generator=generator)


class HeNormalInit(Initializer):
    """N(0, std), std = gain * sqrt(2 / fan_in)."""

    def __init__(self, gain=1.0):
        self._gain = gain

    def init(self, shape, generator):
        fan_in, _ = get_fans(shape)
        std = float(self._gain * np.sqrt(2.0 / fan_in))
        return std * torch.randn(shape, generator=generator)
