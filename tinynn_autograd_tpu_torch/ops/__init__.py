"""Functional op namespace: the primitives of the MLP trainers, the
transformer classifier, the recurrent classifier and the mixture-of-experts
language model, plus coercing wrappers, as in the JAX package's ``ops``
namespace."""

from tinynn_autograd_tpu_torch.core.tensor import as_tensor as _as_tensor
from tinynn_autograd_tpu_torch.ops import kernels
from tinynn_autograd_tpu_torch.ops.primitives import (
    _attn_dropout_seed,
    _dropout_seed,
    add_,
    astype_,
    broadcast_to_,
    build_binary_ops_tensor,
    build_unary_ops_tensor,
    clip_,
    concat_,
    dense_stack_,
    div_,
    dot_,
    dropout_,
    exp_,
    flash_attention_,
    flatten_,
    gather_rows_,
    gelu_,
    getitem_,
    grouped_swiglu_,
    layer_norm_,
    log_,
    log_softmax_,
    max_,
    mean_,
    min_,
    mul_,
    neg_,
    pow_,
    relu_,
    reshape_,
    rms_norm_,
    rope_,
    rope_tables,
    scatter_add_rows_,
    sigmoid_,
    silu_,
    softmax_,
    split_,
    sub_,
    sum_,
    take_along_axis_,
    tanh_,
    top_k_,
    transpose_,
    unbroadcast,
    where_,
)
from tinynn_autograd_tpu_torch.ops.recurrent import gru_scan_, lstm_scan_


def max(obj, axis=None):  # noqa: A001 - parity with reference namespace
    return max_(_as_tensor(obj), axis=axis)


def min(obj, axis=None):  # noqa: A001
    return min_(_as_tensor(obj), axis=axis)


def exp(obj):
    return exp_(_as_tensor(obj))


def sum(obj, axis=None, keepdims=False):  # noqa: A001
    return sum_(_as_tensor(obj), axis=axis, keepdims=keepdims)


def mean(obj, axis=None, keepdims=False):
    return mean_(_as_tensor(obj), axis=axis, keepdims=keepdims)


def log(obj):
    return log_(_as_tensor(obj))


def reshape(obj, newshape):
    return reshape_(_as_tensor(obj), newshape)


def flatten(obj):
    return flatten_(_as_tensor(obj))


def clip(obj, min=None, max=None):  # noqa: A002
    return clip_(_as_tensor(obj), min, max)


def matmul(obj1, obj2):
    obj1 = _as_tensor(obj1)
    return dot_(obj1, _as_tensor(obj2, obj1.device))


def transpose(obj, axes=None):
    return transpose_(_as_tensor(obj), axes=axes)


def sigmoid(obj):
    return sigmoid_(_as_tensor(obj))


def tanh(obj):
    return tanh_(_as_tensor(obj))


def relu(obj):
    return relu_(_as_tensor(obj))


def gelu(obj):
    return gelu_(_as_tensor(obj))


def silu(obj):
    return silu_(_as_tensor(obj))


def log_softmax(obj, axis=-1):
    return log_softmax_(_as_tensor(obj), axis=axis)


def where(cond, a, b):
    return where_(cond, a, b)
