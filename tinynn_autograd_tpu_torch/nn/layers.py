"""Network layers and activations: the MLP trainers', the transformer
classifier's and the recurrent classifier's subset of the JAX package's
nn/layers.py (Layer, Dense, DenseStack, LayerNorm, RMSNorm, Embedding,
PositionalEmbedding, TransformerBlock, GlobalAvgPool1D, LSTM, GRU,
Bidirectional, Flatten, Dropout, Activation, ReLU, Sigmoid, Tanh, GELU),
and the mixture-of-experts language models' decoder sublayers,
AttentionBlock, LatentAttentionBlock, SwiGLU and TokenChoiceMoE, which the
JAX package does not have.

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
from tinynn_autograd_tpu_torch.utils import profiler, seeder


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
    ``bias=False`` leaves b out: y = x @ w.

    Parameters are drawn on the CPU; ``Net.to`` moves them to the device.
    ``compute_dtype`` (mixed precision) is not ported yet and raises."""

    def __init__(self, num_out, num_in=None,
                 w_init=None, b_init=None, seed=None, compute_dtype=None,
                 bias=True):
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
        if not bias:
            del self.shapes["b"], self.params["b"]
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
        if "b" not in self.params:
            return inputs @ self.params["w"]
        return inputs @ self.params["w"] + self.params["b"]

    def init_params(self, input_shape):
        """Shape-only initialization (no compute)."""
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return (input_shape[0], self.shapes["w"][1])

    def _init_parameters(self, input_size):
        self.shapes["w"][0] = int(input_size)
        with _init_scope(self._seed):
            for k in self.params:
                self.params[k] = self.initializers[k](self.shapes[k])
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


class RMSNorm(Layer):
    """RMS normalization over the last axis with a learned scale g [1, dim]
    (``ops.rms_norm_``, hand VJPs), as the JAX package's RMSNorm. ``dim``
    may be omitted and is inferred from the first input (lazy init)."""

    def __init__(self, dim=None, eps=1e-6, gamma_init=None):
        super().__init__("RMSNorm")
        self.eps = eps
        self.initializers = {
            "g": gamma_init if gamma_init is not None else OnesInit(),
        }
        self.shapes = {"g": [1, dim]}
        self.params = {"g": None}
        self._is_init = False
        if dim is not None:
            self._init_parameters(dim)

    @property
    def is_init(self):
        return self._is_init

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        return tuple(input_shape)

    def _init_parameters(self, dim):
        self.shapes = {"g": [1, int(dim)]}
        self.params["g"] = self.initializers["g"](self.shapes["g"])
        self._is_init = True

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        return ops.rms_norm_(inputs, self.params["g"], eps=self.eps)


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
    the cross-check path). ``causal`` masks the future and ``attn_window``
    (causal only) bands attention to the keys in (p - window, p].

    ``dropout``: inverted dropout (``ops.dropout_``) on the attention
    projection's and the MLP's outputs, the residual sites; ``attn_dropout``
    on the attention probabilities: inside the flash kernels under
    ``attn="fused"`` (their own hash of the (head, query, key) index), a
    ``dropout_`` on the materialised probabilities under ``attn="tape"``.
    Both only in the TRAIN phase. A block with either takes a seed from the
    Net (``set_rng``, an int; else one draw from the seeder's generator)
    and derives its three sites' seeds from it by the JAX megakernel's rule,
    ``seed * 7919 + k`` mod 2**32 for k = 0 (attention), 1 (attention
    projection), 2 (MLP).

    Not ported yet: ``compute_dtype``, which raises ``NotImplementedError``."""

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
        self._rng = None
        if dropout or attn_dropout:
            # only blocks with dropout take a seed from the Net, as in the
            # JAX package
            self.set_rng = self._set_rng
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

    def _set_rng(self, rng):
        self._rng = rng

    def _drop_seeds(self):
        """The three sites' seeds (attention probabilities, attention
        projection, MLP) from the Net's seed, else one seeder draw."""
        rng = self._rng
        self._rng = None
        if rng is None:
            rng = ops._dropout_seed(None)
        return [(int(rng) * 7919 + k) % 2 ** 32 for k in range(3)]

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

        drop = self.is_training and (self.dropout > 0.0
                                     or self.attn_dropout > 0.0)
        seeds = self._drop_seeds() if drop else None
        attn_rate = self.attn_dropout if drop else 0.0
        xn = ops.layer_norm_(inputs, p["g1"], p["be1"], eps=self.eps)
        q = split_heads(xn @ p["wq"])
        k = split_heads(xn @ p["wk"])
        v = split_heads(xn @ p["wv"])
        scale = 1.0 / np.sqrt(hd)
        if self.attn == "fused":
            ctx_h = ops.flash_attention_(
                q, k, v, causal=self.causal, scale=scale,
                dropout_rate=attn_rate,
                dropout_rng=seeds[0] if attn_rate > 0.0 else None,
                window=self.attn_window)
        else:
            scores = (q @ k.transpose((0, 1, 3, 2))) * scale
            mask = self._mask(t, inputs.device)
            if mask is not None:
                scores = scores + mask
            probs = ops.softmax_(scores, axis=-1)
            if attn_rate > 0.0:
                probs = ops.dropout_(probs, attn_rate, seeds[0])
            ctx_h = probs @ v
        ctx = ctx_h.transpose((0, 2, 1, 3)).reshape((b, t, d))
        attn_out = ctx @ p["wo"]
        if drop and self.dropout > 0.0:
            attn_out = ops.dropout_(attn_out, self.dropout, seeds[1])
        x = inputs + attn_out
        yn = ops.layer_norm_(x, p["g2"], p["be2"], eps=self.eps)
        y = ops.gelu_(yn @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        if drop and self.dropout > 0.0:
            y = ops.dropout_(y, self.dropout, seeds[2])
        return x + y


def _draw(shapes, seed, scales=("g",)):
    """{key: a leaf of ``shapes[key]``}: Xavier uniform weights (each 2-D,
    so each draws with its own fans) and unit scales for the keys
    ``scales``."""
    init, ones = XavierUniformInit(), OnesInit()
    with _init_scope(seed):
        return {k: ones(shape) if k in scales else init(shape)
                for k, shape in shapes.items()}


def _swiglu(xn, gate, up, down):
    """down(silu(xn gate) * (xn up)) on rows xn [n, dim]: one expert of
    ``ops.grouped_swiglu_`` that takes every row (K1's three products
    forward, six backward)."""
    return ops.grouped_swiglu_(xn, [xn.shape[0]], [(gate, up, down)])


class AttentionBlock(Layer):
    """The attention half of a pre-RMSNorm decoder layer, no biases:
    x + o(attn(rmsnorm(x))) on x [B, T, dim].

    q [dim, num_heads * head_dim], k and v [dim, num_kv_heads * head_dim]
    and o [num_heads * head_dim, dim] are separate projections, so the
    query width need not be ``dim``; ``num_kv_heads`` divides
    ``num_heads`` (grouped-query attention, run as such by
    ``ops.flash_attention_``). q and k are rotated by ``ops.rope_``
    (half-split) with the tables of ``rope_theta``, or YaRN's where
    ``yarn`` gives its parameters (``ops.rope_tables``). The attention is
    causal, scaled by 1/sqrt(head_dim), and with ``window`` banded to the
    keys in (p - window, p]. While ``utils/profiler`` records, the two
    rotations are the span ``tinynn.attn.rope``."""

    def __init__(self, dim, num_heads, num_kv_heads, head_dim, window=None,
                 rope_theta=10000.0, yarn=None, eps=1e-6, seed=None):
        super().__init__("AttentionBlock")
        if num_heads % num_kv_heads:
            raise ValueError("num_kv_heads %d does not divide num_heads %d"
                             % (num_kv_heads, num_heads))
        self.dim, self.head_dim = dim, head_dim
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.window, self.eps = window, eps
        self.rope_theta, self.yarn = float(rope_theta), yarn
        self._tables = {}
        q, kv = num_heads * head_dim, num_kv_heads * head_dim
        self.shapes = {"g": [1, dim], "wq": [dim, q], "wk": [dim, kv],
                       "wv": [dim, kv], "wo": [q, dim]}
        self.params = _draw(self.shapes, seed)

    def init_params(self, input_shape):
        return tuple(input_shape)

    def _rope(self, t, device):
        """cos, sin [t, 1, head_dim / 2] on ``device``, made once."""
        key = (t, str(device))
        if key not in self._tables:
            self._tables[key] = tuple(
                table.to(device)[:, None, :] for table in ops.rope_tables(
                    t, self.head_dim, self.rope_theta, self.yarn))
        return self._tables[key]

    def forward(self, inputs):
        p = self.params
        b, t, _ = inputs.shape
        h, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        xn = ops.rms_norm_(inputs, p["g"], eps=self.eps)
        q = (xn @ p["wq"]).reshape((b, t, h, hd))
        k = (xn @ p["wk"]).reshape((b, t, hkv, hd))
        v = (xn @ p["wv"]).reshape((b, t, hkv, hd))
        cos, sin = self._rope(t, inputs.device)
        with profiler.span("tinynn.attn.rope"):
            q, k = ops.rope_(q, cos, sin), ops.rope_(k, cos, sin)
        heads = (0, 2, 1, 3)  # [B, T, H, hd] -> [B, H, T, hd], a view
        ctx = ops.flash_attention_(
            q.transpose(heads), k.transpose(heads), v.transpose(heads),
            causal=True, scale=1.0 / np.sqrt(hd), window=self.window)
        return inputs + ctx.transpose(heads).reshape((b, t, h * hd)) @ p["wo"]


class LatentAttentionBlock(Layer):
    """The attention half of a DeepSeek-V3 decoder layer: multi-head latent
    attention without a query latent (``q_lora_rank`` null), no biases:
    x + o(mla(rmsnorm(x))) on x [B, T, dim], with z = rmsnorm(x) and

    - q = z W_q [dim, H (n + r)], each head's q_nope (its first n =
      ``qk_nope_dim``) and q_pe (its last r = ``qk_rope_dim``);
    - [c, k_pe] = z W_kva [dim, kv_rank + r]: the latent c and one k_pe that
      every head shares; c = rmsnorm(c) (its own scale "gkv");
    - [k_nope, v] = c W_kvb [kv_rank, H (n + v_dim)], per head;
    - q_pe and k_pe rotated by ``ops.rope_`` with DeepSeek-V3's pairing
      (``interleaved``) and the tables of ``rope_theta`` over r;
    - q = [q_nope, q_pe], k = [k_nope, k_pe] (k_pe broadcast over the H
      heads), softmax(q k^T / sqrt(n + r) + causal) v on
      ``ops.flash_attention_`` at the split head dims n + r and v_dim;
    - then o [H v_dim, dim].

    Each matrix is a leaf of its own; "g" and "gkv" are unit scales. While
    ``utils/profiler`` records, a call is the span ``tinynn.mla`` with the
    children ``.project`` (the norm, q, kv_a, the latent norm, kv_b),
    ``.rope`` (the two rotations and q's and k's assembly), ``.attend``
    (the attention kernels) and ``.out`` (o and the residual)."""

    def __init__(self, dim, num_heads, qk_nope_dim, qk_rope_dim, v_dim,
                 kv_rank, rope_theta=10000.0, eps=1e-6, seed=None):
        super().__init__("LatentAttentionBlock")
        if qk_rope_dim % 2:
            raise ValueError("qk_rope_dim %d is odd: rope pairs its lanes"
                             % qk_rope_dim)
        self.dim, self.num_heads = dim, num_heads
        self.qk_nope_dim, self.qk_rope_dim = qk_nope_dim, qk_rope_dim
        self.v_dim, self.kv_rank = v_dim, kv_rank
        self.rope_theta, self.eps = float(rope_theta), eps
        self._tables = {}
        qk = qk_nope_dim + qk_rope_dim
        self.shapes = {"g": [1, dim], "wq": [dim, num_heads * qk],
                       "wkva": [dim, kv_rank + qk_rope_dim],
                       "gkv": [1, kv_rank],
                       "wkvb": [kv_rank, num_heads * (qk_nope_dim + v_dim)],
                       "wo": [num_heads * v_dim, dim]}
        self.params = _draw(self.shapes, seed, scales=("g", "gkv"))

    def init_params(self, input_shape):
        return tuple(input_shape)

    def _rope(self, t, device):
        """cos, sin [t, qk_rope_dim / 2] on ``device``, made once."""
        key = (t, str(device))
        if key not in self._tables:
            self._tables[key] = tuple(
                table.to(device) for table in ops.rope_tables(
                    t, self.qk_rope_dim, self.rope_theta))
        return self._tables[key]

    def forward(self, inputs):
        p = self.params
        b, t, _ = inputs.shape
        h, n, r = self.num_heads, self.qk_nope_dim, self.qk_rope_dim
        dv = self.v_dim
        heads = (0, 2, 1, 3)  # [B, T, H, d] -> [B, H, T, d], a view
        with profiler.span("tinynn.mla"):
            with profiler.span("tinynn.mla.project"):
                xn = ops.rms_norm_(inputs, p["g"], eps=self.eps)
                q_nope, q_pe = ops.split_(
                    (xn @ p["wq"]).reshape((b, t, h, n + r)), (n, r))
                c, k_pe = ops.split_(xn @ p["wkva"], (self.kv_rank, r))
                kv = ops.rms_norm_(c, p["gkv"], eps=self.eps) @ p["wkvb"]
                k_nope, v = ops.split_(kv.reshape((b, t, h, n + dv)), (n, dv))
            with profiler.span("tinynn.mla.rope"):
                cos, sin = self._rope(t, inputs.device)
                q_pe = ops.rope_(q_pe, cos[:, None, :], sin[:, None, :],
                                 interleaved=True)
                k_pe = ops.rope_(k_pe, cos, sin, interleaved=True)
                q = ops.concat_([q_nope, q_pe], axis=-1)
                k = ops.concat_([k_nope, ops.broadcast_to_(
                    k_pe.reshape((b, t, 1, r)), (b, t, h, r))], axis=-1)
            with profiler.span("tinynn.mla.attend"):
                ctx = ops.flash_attention_(
                    q.transpose(heads), k.transpose(heads),
                    v.transpose(heads), causal=True,
                    scale=1.0 / np.sqrt(n + r))
            with profiler.span("tinynn.mla.out"):
                return inputs + ctx.transpose(heads).reshape(
                    (b, t, h * dv)) @ p["wo"]


class SwiGLU(Layer):
    """The dense half of a pre-RMSNorm decoder layer, no biases:
    x + down(silu(gate z) * (up z)) with z = rmsnorm(x), gate and up
    [dim, width], down [width, dim] (DeepSeek-V3's leading dense layers;
    ``TokenChoiceMoE``'s shared expert is the same MLP on its normalised
    rows)."""

    def __init__(self, dim, width, eps=1e-6, seed=None):
        super().__init__("SwiGLU")
        self.dim, self.width, self.eps = dim, width, eps
        self.shapes = {"g": [1, dim], "gate": [dim, width],
                       "up": [dim, width], "down": [width, dim]}
        self.params = _draw(self.shapes, seed)

    def init_params(self, input_shape):
        return tuple(input_shape)

    def forward(self, inputs):
        p = self.params
        x = inputs.reshape((-1, self.dim))
        y = _swiglu(ops.rms_norm_(x, p["g"], eps=self.eps), p["gate"],
                    p["up"], p["down"])
        return inputs + y.reshape(inputs.shape)


class TokenChoiceMoE(Layer):
    """The expert half of a pre-RMSNorm decoder layer, no biases:
    x + moe(rmsnorm(x)), with ``num_experts`` SwiGLU experts of width
    ``width`` and ``top_k`` of them a token, no capacity limit (no token is
    dropped) and no auxiliary loss.

    The router, W_r [dim, num_experts], gives s = softmax(x W_r); a token
    goes to the experts S of its ``top_k`` largest s, with weights
    w_j = s_j / sum over S of s (the weights renormalised over S).

    ``scoring="sigmoid"`` (DeepSeek-V3's ``noaux_tc`` router with one
    group): s = sigmoid(x W_r), S the ``top_k`` largest s + b, where b
    (``score_bias``, DeepSeek-V3's ``e_score_correction_bias``: not a leaf,
    zero at first; ``set_score_bias`` sets it) takes part in the selection
    only, and w_j = ``routed_scaling`` * s_j / (sum over S of s + 1e-20).
    ``shared_width`` adds a shared expert, a SwiGLU MLP of that width
    (leaves "shared_gate", "shared_up", "shared_down") on every token.

    The layer holds the experts ``experts_held`` (global ids; the leaves
    "e<id>_gate" [dim, width], "e<id>_up" [dim, width] and "e<id>_down"
    [width, dim]), as one rank of expert parallelism does: it routes over
    all the experts and adds only its own experts' part,
    sum over S and held of w_j * down_j(silu(gate_j x) * up_j x), and the
    shared expert's output where it has one (every rank computes it alike).
    On one device the exchange of an expert-parallel layer has nothing to
    do. The router takes its gradient through the held experts' w_j, the
    whole top-k denominator included.

    The dispatch sorts the (token, expert) pairs of the held experts by
    expert on the device and reads the experts' counts back to the host,
    once a call (the layer's one host sync); the tokens' rows are
    gathered into one block, each expert's three products run on its
    contiguous rows (``ops.grouped_swiglu_``), and the weighted rows are
    added back to their tokens. While ``utils/profiler`` records, a call
    is the span ``tinynn.moe`` with the children ``.route``, ``.dispatch``,
    ``.experts``, ``.combine`` and, with a shared expert, ``.shared``, and
    adds to the counters
    ``moe.routed_pairs`` (the pairs computed), ``moe.max_expert_tokens``
    (the busiest held expert's tokens) and ``moe.syncs`` (read-backs)."""

    def __init__(self, dim, width, num_experts, top_k, experts_held=None,
                 eps=1e-6, seed=None, scoring="softmax", routed_scaling=1.0,
                 shared_width=None):
        super().__init__("TokenChoiceMoE")
        held = sorted(range(num_experts) if experts_held is None
                      else {int(e) for e in experts_held})
        if not held or held[0] < 0 or held[-1] >= num_experts:
            raise ValueError("experts_held %s are not experts of %d"
                             % (experts_held, num_experts))
        if not 1 <= top_k <= num_experts:
            raise ValueError("top_k %d of %d experts" % (top_k, num_experts))
        if scoring not in ("softmax", "sigmoid"):
            raise ValueError("scoring must be 'softmax' or 'sigmoid', got %r"
                             % (scoring,))
        self.dim, self.width = dim, width
        self.num_experts, self.top_k = num_experts, top_k
        self.experts_held, self.eps = held, eps
        self.scoring, self.routed_scaling = scoring, float(routed_scaling)
        self.shared_width = shared_width
        self._local = {}
        self.set_score_bias(torch.zeros(num_experts))
        self.shapes = {"g": [1, dim], "wr": [dim, num_experts]}
        for e in held:
            self.shapes.update({"e%d_gate" % e: [dim, width],
                                "e%d_up" % e: [dim, width],
                                "e%d_down" % e: [width, dim]})
        if shared_width:
            self.shapes.update({"shared_gate": [dim, shared_width],
                                "shared_up": [dim, shared_width],
                                "shared_down": [shared_width, dim]})
        self.params = _draw(self.shapes, seed)

    def init_params(self, input_shape):
        return tuple(input_shape)

    def set_score_bias(self, bias):
        """Sets the sigmoid router's selection bias b [num_experts]."""
        bias = torch.as_tensor(bias, dtype=torch.float32)
        if bias.shape != (self.num_experts,):
            raise ValueError("score bias of shape %s, not (%d,)"
                             % (tuple(bias.shape), self.num_experts))
        self.score_bias = bias
        self._bias = {}

    def _bias_on(self, device):
        """``score_bias`` on ``device``, copied once."""
        key = str(device)
        if key not in self._bias:
            self._bias[key] = self.score_bias.to(device)
        return self._bias[key]

    def forward(self, inputs):
        shape = inputs.shape
        p = self.params
        with profiler.span("tinynn.moe"):
            x = inputs.reshape((-1, self.dim))
            xn = ops.rms_norm_(x, p["g"], eps=self.eps)
            y = self.experts_part(xn)
            if self.shared_width:
                with profiler.span("tinynn.moe.shared"):
                    y = y + _swiglu(xn, p["shared_gate"], p["shared_up"],
                                    p["shared_down"])
        return inputs + y.reshape(shape)

    def _local_ids(self, device):
        """[num_experts] int64 on ``device``: a held expert's place among the
        held ones, len(held) for the others."""
        key = str(device)
        if key not in self._local:
            ids = torch.full((self.num_experts,), len(self.experts_held),
                             dtype=torch.int64)
            ids[self.experts_held] = torch.arange(len(self.experts_held))
            self._local[key] = ids.to(device)
        return self._local[key]

    def _dispatch(self, top):
        """(the held pairs' places in the flat [tokens * top_k] routing, by
        expert and then by token; each held expert's count on the host)."""
        n_held = len(self.experts_held)
        key = self._local_ids(top.device)[top.reshape(-1)]
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=n_held + 1)[:n_held].tolist()
        routed = sum(counts)
        profiler.count("moe.syncs")
        profiler.count("moe.routed_pairs", routed)
        profiler.count("moe.max_expert_tokens", max(counts))
        return order[:routed], counts

    def experts_part(self, xn):
        """The held experts' part of the layer's output for normalised rows
        xn [n, dim]: [n, dim], zero on the rows no held expert takes."""
        p, k = self.params, self.top_k
        n = xn.shape[0]
        with profiler.span("tinynn.moe.route"):
            if self.scoring == "softmax":
                probs = ops.softmax_(xn @ p["wr"], axis=-1)
                top = ops.top_k_(probs, k)
                weights = ops.take_along_axis_(probs, top)
                weights = weights / weights.sum(axis=-1, keepdims=True)
            else:
                probs = ops.sigmoid_(xn @ p["wr"])
                top = ops.top_k_(probs.data + self._bias_on(probs.device), k)
                weights = ops.take_along_axis_(probs, top)
                weights = weights / (weights.sum(axis=-1, keepdims=True)
                                     + 1e-20) * self.routed_scaling
        with profiler.span("tinynn.moe.dispatch"):
            pairs, counts = self._dispatch(top)
            tokens = torch.div(pairs, k, rounding_mode="floor")
            rows = ops.gather_rows_(xn, tokens)
            pair_w = ops.gather_rows_(weights.reshape((n * k, 1)), pairs)
        with profiler.span("tinynn.moe.experts"):
            out = ops.grouped_swiglu_(rows, counts, [
                (p["e%d_gate" % e], p["e%d_up" % e], p["e%d_down" % e])
                for e in self.experts_held])
        with profiler.span("tinynn.moe.combine"):
            return ops.scatter_add_rows_(out * pair_w, tokens, n)


class GlobalAvgPool1D(Layer):
    """[B, T, D] -> [B, D]: mean over the sequence axis (the sequence
    classifier's readout)."""

    def __init__(self):
        super().__init__("GlobalAvgPool1D")

    def init_params(self, input_shape):
        return (input_shape[0], input_shape[2])

    def forward(self, inputs):
        return ops.mean_(inputs, axis=1)


class _RecurrentBase(Layer):
    """Shared plumbing of LSTM and GRU: the fused-gate weights wx [D, G*H],
    wh [H, G*H] and b [1, G*H], lazy initialization from the first input's
    feature size, and the full-sequence or last-step output.

    ``impl`` is the scan's: None runs the recurrent kernels on a GPU and
    their plain versions on the CPU; "plain" runs the plain versions on the
    GPU too (to compare a model with its kernels leaf by leaf)."""

    _GATES = None  # subclass: the number of fused gates G

    def __init__(self, name, num_hidden, num_in=None, return_sequences=False,
                 w_init=None, u_init=None, seed=None, reverse=False,
                 impl=None):
        super().__init__(name)
        self.num_hidden = int(num_hidden)
        self.return_sequences = return_sequences
        self.reverse = reverse
        self.impl = impl
        self._seed = seed
        self.initializers = {
            "wx": w_init if w_init is not None else XavierUniformInit(),
            "wh": u_init if u_init is not None else XavierUniformInit(),
        }
        g = self._GATES
        self.shapes = {"wx": [num_in, g * self.num_hidden],
                       "wh": [self.num_hidden, g * self.num_hidden],
                       "b": [1, g * self.num_hidden]}
        self.params = {"wx": None, "wh": None, "b": None}
        self._is_init = False
        if num_in is not None:
            self._init_parameters(num_in)

    @property
    def is_init(self):
        return self._is_init

    def _bias_data(self):
        return torch.zeros(tuple(self.shapes["b"]), dtype=torch.float32)

    def _init_parameters(self, input_size):
        self.shapes["wx"][0] = int(input_size)
        with _init_scope(self._seed):
            self.params["wx"] = self.initializers["wx"](self.shapes["wx"])
            self.params["wh"] = self.initializers["wh"](self.shapes["wh"])
        self.params["b"] = Tensor(self._bias_data(), requires_grad=True)
        self._is_init = True

    def init_params(self, input_shape):
        if not self._is_init:
            self._init_parameters(input_shape[-1])
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.num_hidden)
        return (input_shape[0], self.num_hidden)

    def _scan(self, inputs):
        raise NotImplementedError

    def forward(self, inputs):
        if not self._is_init:
            self._init_parameters(inputs.shape[-1])
        hs = self._scan(inputs)
        if self.return_sequences:
            return hs
        # a reverse cell's final state sits at position 0 (outputs stay
        # aligned to their input positions)
        return hs[:, 0] if self.reverse else hs[:, -1]


class LSTM(_RecurrentBase):
    """LSTM over [B, T, D] -> [B, H] (the last hidden state) or [B, T, H]
    (``return_sequences=True``): one ``ops.lstm_scan_`` primitive, whose
    forward and backward are one recurrent kernel launch each on a GPU.
    The forget-gate bias starts at 1.0; gates fused in i, f, g, o order."""

    _GATES = 4

    def __init__(self, num_hidden, num_in=None, return_sequences=False,
                 w_init=None, u_init=None, seed=None, reverse=False,
                 impl=None):
        super().__init__("LSTM", num_hidden, num_in=num_in,
                         return_sequences=return_sequences,
                         w_init=w_init, u_init=u_init, seed=seed,
                         reverse=reverse, impl=impl)

    def _bias_data(self):
        h = self.num_hidden
        b = torch.zeros((1, 4 * h), dtype=torch.float32)
        b[:, h:2 * h] = 1.0
        return b

    def _scan(self, inputs):
        return ops.lstm_scan_(inputs, self.params["wx"], self.params["wh"],
                              self.params["b"], reverse=self.reverse,
                              impl=self.impl)


class GRU(_RecurrentBase):
    """GRU over [B, T, D] -> [B, H] or [B, T, H] (``return_sequences``):
    one ``ops.gru_scan_`` primitive (single-bias Cho et al. form, gates
    fused in z, r, n order)."""

    _GATES = 3

    def __init__(self, num_hidden, num_in=None, return_sequences=False,
                 w_init=None, u_init=None, seed=None, reverse=False,
                 impl=None):
        super().__init__("GRU", num_hidden, num_in=num_in,
                         return_sequences=return_sequences,
                         w_init=w_init, u_init=u_init, seed=seed,
                         reverse=reverse, impl=impl)

    def _scan(self, inputs):
        return ops.gru_scan_(inputs, self.params["wx"], self.params["wh"],
                             self.params["b"], reverse=self.reverse,
                             impl=self.impl)


class _TwoWayParams:
    """Write-through merged view of the two direction layers' parameter
    dicts, keys ``f_<name>`` and ``b_<name>``. Net and Model use only the
    mapping surface below, and ``params_tree`` copies it into plain dicts,
    so checkpoints and the optimizers see ordinary trees."""

    def __init__(self, fwd, bwd):
        self._fwd, self._bwd = fwd, bwd

    def _route(self, key):
        side, name = key.split("_", 1)
        return (self._fwd if side == "f" else self._bwd).params, name

    def keys(self):
        # dict_keys, not a list: Net.set_parameters compares with the
        # checkpoint dict's .keys() (set semantics)
        return dict.fromkeys(
            ["f_%s" % k for k in self._fwd.params]
            + ["b_%s" % k for k in self._bwd.params]).keys()

    def __iter__(self):
        return iter(self.keys())

    def __getitem__(self, key):
        inner, name = self._route(key)
        return inner[name]

    def __setitem__(self, key, value):
        inner, name = self._route(key)
        inner[name] = value

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def __eq__(self, other):
        return dict(self.items()) == dict(
            other.items() if hasattr(other, "items") else other)


class Bidirectional(Layer):
    """A recurrent layer (LSTM or GRU) run forward in time and an
    independent twin run backward in time (``reverse=True``), their outputs
    concatenated on the feature axis: [B, T, 2H] when the wrapped layer
    returns sequences, else [B, 2H] (the forward cell's last state and the
    backward cell's state at position 0).

    ``backward_layer`` defaults to a twin of the wrapped layer (same class,
    width, return_sequences and impl; its seed is the wrapped layer's +
    0x9E37).
    The parameters are one write-through dict (keys ``f_*`` and ``b_*``),
    so optimizers and checkpoints see one ordinary layer."""

    def __init__(self, forward_layer, backward_layer=None):
        if forward_layer.reverse:
            raise ValueError("Bidirectional's wrapped layer must run "
                             "forward (reverse=False); the wrapper builds "
                             "the reverse twin itself.")
        if backward_layer is None:
            seed = forward_layer._seed
            num_in = (forward_layer.shapes["wx"][0]
                      if forward_layer.is_init else None)
            backward_layer = type(forward_layer)(
                forward_layer.num_hidden, num_in=num_in,
                return_sequences=forward_layer.return_sequences,
                seed=None if seed is None else seed + 0x9E37,
                reverse=True, impl=forward_layer.impl)
        else:
            if not backward_layer.reverse:
                raise ValueError("backward_layer must have reverse=True")
            if (backward_layer.return_sequences
                    != forward_layer.return_sequences):
                raise ValueError("forward/backward return_sequences differ")
        # fwd and bwd exist before Layer.__init__ assigns ``self.params``,
        # which goes through the setter below
        self.fwd = forward_layer
        self.bwd = backward_layer
        super().__init__("Bidirectional(%s)" % forward_layer.name)

    @property
    def params(self):
        return _TwoWayParams(self.fwd, self.bwd)

    @params.setter
    def params(self, value):
        view = _TwoWayParams(self.fwd, self.bwd)
        for k in value.keys():
            view[k] = value[k]

    @property
    def is_init(self):
        return self.fwd.is_init and self.bwd.is_init

    # Model.load marks a loaded layer initialized through ``_is_init``:
    # both direction layers, so that neither redraws over the loaded weights
    @property
    def _is_init(self):
        return self.fwd._is_init and self.bwd._is_init

    @_is_init.setter
    def _is_init(self, value):
        self.fwd._is_init = value
        self.bwd._is_init = value

    def init_params(self, input_shape):
        self.fwd.init_params(input_shape)
        out = self.bwd.init_params(input_shape)
        return tuple(out[:-1]) + (2 * out[-1],)

    def set_phase(self, phase):
        self.fwd.set_phase(phase)
        self.bwd.set_phase(phase)
        super().set_phase(phase)

    def forward(self, inputs):
        out_f = self.fwd.forward(inputs)
        out_b = self.bwd.forward(inputs)
        return ops.concat_([out_f, out_b], axis=-1)


class Flatten(Layer):
    """[N, ...] -> [N, prod(...)]."""

    def __init__(self):
        super().__init__("Flatten")

    def init_params(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))

    def forward(self, inputs):
        n = inputs.shape[0]
        return inputs.reshape((n, int(np.prod(inputs.shape[1:]))))


class Dropout(Layer):
    """Inverted dropout (``ops.dropout_``); the identity in the TEST phase
    and at rate 0.

    Its seed comes from the Net (``set_rng``, an int, see ``Net.forward``):
    the step tier and K2 derive it from the optimizer's step counter, so
    both draw the masks the JAX package's megakernel draws in interpret
    mode. Without one (the eager facade) it draws from the seeder's
    generator."""

    def __init__(self, rate=0.5):
        super().__init__("Dropout")
        self.rate = rate
        self._rng = None

    def set_rng(self, rng):
        self._rng = rng

    def forward(self, inputs):
        rng, self._rng = self._rng, None
        if not self.is_training or self.rate == 0.0:
            return inputs
        return ops.dropout_(inputs, self.rate, rng)


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
