"""Network layers and activations: the MLP trainer's subset of the JAX
package's nn/layers.py (Layer, Dense, Activation, ReLU, Sigmoid, Tanh,
Flatten).

Every layer's forward is Tensor algebra over the tape primitives. Layers own
their parameters as tape Tensors (so they are the framework's own classes,
not ``nn.Module``s), lazily initialized from the first input's shape, and
expose ``param_shapes`` for checkpoint compatibility checks.
"""

import contextlib

import numpy as np

import tinynn_autograd_tpu_torch.ops as ops
from tinynn_autograd_tpu_torch.nn.initializer import (
    XavierUniformInit, ZerosInit,
)
from tinynn_autograd_tpu_torch.utils import seeder


def _init_scope(seed):
    """Parameter-draw scope: a dedicated generator when the layer was given
    an explicit ``seed``, else the global seeder stream."""
    return (seeder.scope(seed) if seed is not None
            else contextlib.nullcontext())


class Layer:
    """Base layer: named, owns a ``params`` dict and a training flag."""

    def __init__(self, name):
        self.name = name
        self.params = {}
        self.is_training = True

    def forward(self, inputs):
        raise NotImplementedError

    def init_params(self, input_shape):
        """Static shape inference: materialize lazy params (if any) and
        return the output shape. Default: shape-preserving, no params."""
        return input_shape

    def set_phase(self, phase):
        self.is_training = phase == "TRAIN"

    @property
    def param_shapes(self):
        return {k: tuple(v.shape) for k, v in self.params.items() if v is not None}

    # layers with parameters override; others are always "initialized"
    @property
    def is_init(self):
        return True


class Dense(Layer):
    """y = x @ w + b; w: [num_in, num_out], b: [1, num_out]. ``num_in`` may
    be omitted and is inferred from the first input (lazy init). ``seed``
    pins the layer's parameter draws to a dedicated generator.

    Parameters are drawn on the CPU; ``Net.to`` moves them to the device.
    ``compute_dtype`` (mixed precision) is not ported yet and raises."""

    def __init__(self, num_out, num_in=None,
                 w_init=None, b_init=None, seed=None, compute_dtype=None):
        super().__init__("Linear")
        if compute_dtype is not None:
            raise NotImplementedError(
                "Dense(compute_dtype=...) is not ported to the PyTorch "
                "package yet (see ROADMAP.md, queue 1)")
        self.compute_dtype = None
        self.initializers = {
            "w": w_init if w_init is not None else XavierUniformInit(),
            "b": b_init if b_init is not None else ZerosInit(),
        }
        self.shapes = {"w": [num_in, num_out], "b": [1, num_out]}
        self.params = {"w": None, "b": None}
        self._seed = seed

        self._is_init = False
        if num_in is not None:
            self._init_parameters(num_in)

    @property
    def is_init(self):
        return self._is_init

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return inputs @ self.params["w"] + self.params["b"]

    def init_params(self, input_shape):
        """Shape-only initialization (no compute)."""
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return (input_shape[0], self.shapes["w"][1])

    def _init_parameters(self, input_size):
        self.shapes["w"][0] = int(input_size)
        with _init_scope(self._seed):
            self.params["w"] = self.initializers["w"](self.shapes["w"])
            self.params["b"] = self.initializers["b"](self.shapes["b"])
        self._is_init = True


class Flatten(Layer):
    """[N, ...] -> [N, prod(...)]."""

    def __init__(self):
        super().__init__("Flatten")

    def init_params(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))

    def forward(self, inputs):
        n = inputs.shape[0]
        return inputs.reshape((n, int(np.prod(inputs.shape[1:]))))


class Activation(Layer):
    """Stateless elementwise layer."""

    def __init__(self, name):
        super().__init__(name)

    def forward(self, inputs):
        return self.func(inputs)

    def func(self, x):
        raise NotImplementedError


class Sigmoid(Activation):

    def __init__(self):
        super().__init__("Sigmoid")

    def func(self, x):
        return ops.sigmoid(x)


class Tanh(Activation):

    def __init__(self):
        super().__init__("Tanh")

    def func(self, x):
        return ops.tanh(x)


class ReLU(Activation):

    def __init__(self):
        super().__init__("ReLU")

    def func(self, x):
        return ops.relu(x)
