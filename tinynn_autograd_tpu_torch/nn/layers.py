"""Network layers and activations: the MLP trainers' subset of the JAX
package's nn/layers.py (Layer, Dense, DenseStack, Activation, ReLU, Sigmoid,
Tanh, Flatten).

Every layer's forward is Tensor algebra over the tape primitives. Layers own
their parameters as tape Tensors (so they are the framework's own classes,
not ``nn.Module``s), lazily initialized from the first input's shape, and
expose ``param_shapes`` for checkpoint compatibility checks.
"""

import contextlib

import numpy as np
import torch

import tinynn_autograd_tpu_torch.ops as ops
from tinynn_autograd_tpu_torch.core.tensor import Tensor
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


class DenseStack(Layer):
    """``depth`` homogeneous Dense(width->width)+activation layers with
    STACKED parameters (w: [depth, W, W], b: [depth, 1, W]) executed as one
    primitive (``ops.dense_stack_``). ``activation`` is "relu", "tanh",
    "sigmoid" or "linear". ``width`` may be omitted and is inferred from the
    first input (lazy init); ``seed`` pins the parameter draws.

    The deep-MLP body: on the card the weight-streaming tier
    (ops/streaming_epoch.py) trains it with two kernels a step."""

    def __init__(self, depth, width=None, activation="relu", w_init=None,
                 b_init=None, seed=None):
        super().__init__("DenseStack")
        self.depth = depth
        self.activation = activation
        self._seed = seed
        self.initializers = {
            "w": w_init if w_init is not None else XavierUniformInit(),
            "b": b_init if b_init is not None else ZerosInit(),
        }
        self.shapes = {"w": [depth, width, width], "b": [depth, 1, width]}
        self.params = {"w": None, "b": None}
        self._is_init = False
        if width is not None:
            self._init_parameters(width)

    @property
    def width(self):
        return self.shapes["w"][-1]

    @property
    def is_init(self):
        return self._is_init

    def _init_parameters(self, width):
        width = int(width)
        self.shapes = {"w": [self.depth, width, width],
                       "b": [self.depth, 1, width]}
        # per-layer draws with the 2-D fans, stacked
        with _init_scope(self._seed):
            ws = [self.initializers["w"]((width, width)).data
                  for _ in range(self.depth)]
            bs = [self.initializers["b"]((1, width)).data
                  for _ in range(self.depth)]
        self.params = {"w": Tensor(torch.stack(ws), requires_grad=True),
                       "b": Tensor(torch.stack(bs), requires_grad=True)}
        self._is_init = True

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return (input_shape[0], self.width)

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return ops.dense_stack_(inputs, self.params["w"], self.params["b"],
                                activation=self.activation)


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
