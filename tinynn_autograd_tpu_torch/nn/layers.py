"""Network layers and activations: the MLP trainers' and the transformer
classifier's subset of the JAX package's nn/layers.py (Layer, Dense,
DenseStack, LayerNorm, Embedding, PositionalEmbedding, TransformerBlock,
GlobalAvgPool1D, Flatten, Activation, ReLU, Sigmoid, Tanh, GELU).

Every layer's forward is Tensor algebra over the tape primitives. Layers own
their parameters as tape Tensors (so they are the framework's own classes,
not ``nn.Module``s), lazily initialized from the first input's shape, and
expose ``param_shapes`` for checkpoint compatibility checks.
"""

import contextlib

import numpy as np
import torch

import tinynn_autograd_tpu_torch.ops as ops
from tinynn_autograd_tpu_torch.core.tensor import Tensor, to_torch
from tinynn_autograd_tpu_torch.nn.initializer import (
    NormalInit, OnesInit, XavierUniformInit, ZerosInit,
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


class LayerNorm(Layer):
    """Layer normalization over the last axis with learned gamma/beta
    (``ops.layer_norm_``, hand VJPs). ``dim`` may be omitted and is inferred
    from the first input (lazy init, like Dense)."""

    def __init__(self, dim=None, eps=1e-5, gamma_init=None, beta_init=None):
        super().__init__("LayerNorm")
        self.eps = eps
        self.initializers = {
            "gamma": gamma_init if gamma_init is not None else OnesInit(),
            "beta": beta_init if beta_init is not None else ZerosInit(),
        }
        self.shapes = {"gamma": [1, dim], "beta": [1, dim]}
        self.params = {"gamma": None, "beta": None}
        self._is_init = False
        if dim is not None:
            self._init_parameters(dim)

    @property
    def is_init(self):
        return self._is_init

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return ops.layer_norm_(inputs, self.params["gamma"],
                               self.params["beta"], eps=self.eps)

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return tuple(input_shape)

    def _init_parameters(self, dim):
        self.shapes = {"gamma": [1, int(dim)], "beta": [1, int(dim)]}
        self.params["gamma"] = self.initializers["gamma"](self.shapes["gamma"])
        self.params["beta"] = self.initializers["beta"](self.shapes["beta"])
        self._is_init = True


class Embedding(Layer):
    """Token embedding: int ids [..] -> vectors [.., dim] by table lookup
    (``ops.getitem_``, whose VJP scatter-adds: repeated ids accumulate)."""

    def __init__(self, vocab, dim, w_init=None, seed=None):
        super().__init__("Embedding")
        self.initializers = {
            "w": w_init if w_init is not None else NormalInit(std=0.02),
        }
        self.shapes = {"w": [vocab, dim]}
        with _init_scope(seed):
            self.params = {"w": self.initializers["w"](self.shapes["w"])}

    def init_params(self, input_shape):
        return tuple(input_shape) + (self.shapes["w"][1],)

    def forward(self, inputs):
        ids = inputs.data if isinstance(inputs, Tensor) else to_torch(inputs)
        return self.params["w"][ids]


class PositionalEmbedding(Layer):
    """Learned additive position embedding: x [B, T, D] + pos [1, T, D]."""

    def __init__(self, seq_len, dim, w_init=None, seed=None):
        super().__init__("PositionalEmbedding")
        self.initializers = {
            "pos": w_init if w_init is not None else NormalInit(std=0.02),
        }
        self.shapes = {"pos": [1, seq_len, dim]}
        with _init_scope(seed):
            self.params = {
                "pos": self.initializers["pos"](self.shapes["pos"])}

    def init_params(self, input_shape):
        return tuple(input_shape)

    def forward(self, inputs):
        return inputs + self.params["pos"]


def _not_ported(what):
    return NotImplementedError(
        "%s is not ported to the PyTorch package yet (see ROADMAP.md, "
        "queue 1)" % what)


class TransformerBlock(Layer):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + MLP(LN(x)), as
    Tensor algebra over the tape primitives.

    ``attn``: "fused" (default) runs the attention core as the one
    primitive ``ops.flash_attention_`` (the flash kernels on a GPU); "tape"
    keeps the explicit chain of batched ``dot_``, an additive -1e9 mask,
    ``softmax_`` and ``dot_`` (same numerics, [T, T] scores materialised;
    the cross-check path). ``causal`` masks the future, ``attn_window``
    (causal only) bands attention to the keys in (p - window, p], and
    ``attn_dropout`` drops attention probabilities inside the fused kernels
    in the TRAIN phase (seeded from the seeder's generator).

    Not ported yet, each raising ``NotImplementedError``: residual
    ``dropout`` (it needs ``dropout_``), attention dropout under
    ``attn="tape"`` (likewise), and ``compute_dtype``."""

    def __init__(self, dim, num_heads, mlp_ratio=4, causal=False,
                 w_init=None, eps=1e-5, seed=None, attn="fused",
                 dropout=0.0, attn_dropout=0.0, attn_window=None,
                 compute_dtype=None):
        super().__init__("TransformerBlock")
        if dim % num_heads:
            raise ValueError("dim %d is not a multiple of num_heads %d"
                             % (dim, num_heads))
        if attn not in ("fused", "tape"):
            raise ValueError("attn must be 'fused' or 'tape', got %r"
                             % (attn,))
        if attn_window is not None and not causal:
            raise ValueError("attn_window (sliding-window attention) "
                             "requires causal=True")
        if dropout:
            raise _not_ported("TransformerBlock(dropout=...) (residual "
                              "dropout needs dropout_)")
        if attn_dropout and attn == "tape":
            raise _not_ported("attn_dropout under attn='tape' (it needs "
                              "dropout_)")
        if compute_dtype is not None:
            raise _not_ported("TransformerBlock(compute_dtype=...)")
        self.compute_dtype = None
        self.attn_window = attn_window
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.causal = causal
        self.attn = attn
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.eps = eps
        self._masks = {}
        init = w_init if w_init is not None else XavierUniformInit()
        hidden = int(dim * mlp_ratio)
        self.shapes = {
            "wq": [dim, dim], "wk": [dim, dim], "wv": [dim, dim],
            "wo": [dim, dim],
            "w1": [dim, hidden], "b1": [1, hidden],
            "w2": [hidden, dim], "b2": [1, dim],
            "g1": [1, dim], "be1": [1, dim],
            "g2": [1, dim], "be2": [1, dim],
        }
        zeros, ones = ZerosInit(), OnesInit()
        self.params = {}
        with _init_scope(seed):
            for k, shape in self.shapes.items():
                if k.startswith("g"):
                    self.params[k] = ones(shape)
                elif k.startswith(("b", "be")):
                    self.params[k] = zeros(shape)
                else:
                    self.params[k] = init(shape)

    def init_params(self, input_shape):
        return tuple(input_shape)

    def _mask(self, t, device):
        """The tape path's additive mask [t, t] (0 where visible, -1e9
        elsewhere) on ``device``, or None when not causal."""
        if not self.causal:
            return None
        key = (t, str(device))
        if key not in self._masks:
            from tinynn_autograd_tpu_torch.ops.attention import band_mask

            self._masks[key] = torch.from_numpy(np.where(
                band_mask(t, self.attn_window), 0.0, -1e9).astype(
                    np.float32)).to(device)
        return self._masks[key]

    def forward(self, inputs):
        p = self.params
        b, t, d = inputs.shape
        h, hd = self.num_heads, self.head_dim

        def split_heads(x):  # [B,T,D] -> [B,H,T,hd], a strided view
            return x.reshape((b, t, h, hd)).transpose((0, 2, 1, 3))

        xn = ops.layer_norm_(inputs, p["g1"], p["be1"], eps=self.eps)
        q = split_heads(xn @ p["wq"])
        k = split_heads(xn @ p["wk"])
        v = split_heads(xn @ p["wv"])
        scale = 1.0 / np.sqrt(hd)
        if self.attn == "fused":
            rate = self.attn_dropout if self.is_training else 0.0
            ctx_h = ops.flash_attention_(q, k, v, causal=self.causal,
                                         scale=scale, dropout_rate=rate,
                                         window=self.attn_window)
        else:
            scores = (q @ k.transpose((0, 1, 3, 2))) * scale
            mask = self._mask(t, inputs.device)
            if mask is not None:
                scores = scores + mask
            ctx_h = ops.softmax_(scores, axis=-1) @ v
        ctx = ctx_h.transpose((0, 2, 1, 3)).reshape((b, t, d))
        x = inputs + ctx @ p["wo"]
        yn = ops.layer_norm_(x, p["g2"], p["be2"], eps=self.eps)
        y = ops.gelu_(yn @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return x + y


class GlobalAvgPool1D(Layer):
    """[B, T, D] -> [B, D]: mean over the sequence axis (the sequence
    classifier's readout)."""

    def __init__(self):
        super().__init__("GlobalAvgPool1D")

    def init_params(self, input_shape):
        return (input_shape[0], input_shape[2])

    def forward(self, inputs):
        return ops.mean_(inputs, axis=1)


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


class GELU(Activation):

    def __init__(self):
        super().__init__("GELU")

    def func(self, x):
        return ops.gelu(x)
