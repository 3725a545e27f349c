"""The PyTorch package's tape against the JAX package's, primitive by
primitive.

The same numpy inputs (np.random.RandomState) go through a JAX Tensor op and
its counterpart in ``tinynn_autograd_tpu_torch``; the forward values and
every input's ``.grad`` after ``backward(cotangent)`` must agree. Tolerances:
rtol 1e-6 / atol 1e-6 for elementwise ops (the same f32 arithmetic, up to
the last ulp of transcendental functions), rtol 1e-5 / atol 1e-5 for
products and reductions (f32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu.core.tensor import Tensor as JTensor
import tinynn_autograd_tpu.ops as jops
from tinynn_autograd_tpu_torch.core.tensor import Tensor as TTensor
import tinynn_autograd_tpu_torch.ops as tops

torch.set_num_threads(1)

EW = dict(rtol=1e-6, atol=1e-6)   # elementwise
RED = dict(rtol=1e-5, atol=1e-5)  # dot_ and reductions


def randn(*shape):
    return lambda r: r.randn(*shape).astype(np.float32)


def positive(*shape):
    return lambda r: (r.rand(*shape) + 0.5).astype(np.float32)


def const(arr, dtype=np.float32):
    return lambda r: np.asarray(arr, dtype)


def with_zeros(*shape):
    def make(r):
        x = r.randn(*shape).astype(np.float32)
        x.reshape(-1)[::3] = 0.0  # ReLU exactly at 0
        return x
    return make


def with_bounds(*shape):
    def make(r):
        x = r.uniform(-1, 1, shape).astype(np.float32)
        x.reshape(-1)[::4] = 0.5
        x.reshape(-1)[1::4] = -0.5
        return x
    return make


COND = np.random.RandomState(3).rand(3, 4) > 0.5


def shared_subgraph(o, x, w):
    h = x @ w
    y = h * h          # h reaches the root along three paths
    z = y + h * 2.0 - h.sum(axis=0)
    return (z * y).mean(axis=1)


# name -> (fn(ops, *tensors), input makers, tolerance)
CASES = {
    "add_broadcast": (lambda o, a, b: a + b, [randn(2, 3, 4), randn(3, 1)], EW),
    "add_row": (lambda o, a, b: a + b, [randn(5, 4), randn(1, 4)], EW),
    "add_scalar": (lambda o, a: 2.0 + a + 1, [randn(3, 4)], EW),
    "sub_broadcast": (lambda o, a, b: a - b, [randn(3, 4), randn(4)], EW),
    "rsub_scalar": (lambda o, a: 1.5 - a, [randn(3, 4)], EW),
    "mul_broadcast": (lambda o, a, b: a * b, [randn(2, 3, 4), randn(2, 1, 4)], EW),
    "mul_scalar": (lambda o, a: a * 3.0, [randn(4)], EW),
    "div_broadcast": (lambda o, a, b: a / b, [randn(3, 4), positive(3, 1)], EW),
    "rdiv_scalar": (lambda o, a: 1.0 / a, [positive(3, 4)], EW),
    "pow_const": (lambda o, a: a ** 2, [randn(3, 4)], EW),
    "pow_tensor": (lambda o, a, b: a ** b, [positive(3, 4), randn(3, 4)], EW),
    "neg": (lambda o, a: -a, [randn(3, 4)], EW),
    "dot_1d_1d": (lambda o, a, b: a @ b, [randn(7), randn(7)], RED),
    "dot_2d_1d": (lambda o, a, b: a @ b, [randn(5, 7), randn(7)], RED),
    "dot_1d_2d": (lambda o, a, b: a @ b, [randn(7), randn(7, 3)], RED),
    "dot_2d_2d": (lambda o, a, b: a @ b, [randn(9, 13), randn(13, 6)], RED),
    "dot_transposed_view": (lambda o, a, b: a.T @ b, [randn(13, 9), randn(13, 6)], RED),
    "dot_batched": (lambda o, a, b: a @ b, [randn(2, 5, 7), randn(7, 3)], RED),
    "dot_batched_broadcast": (lambda o, a, b: a @ b, [randn(2, 1, 5, 7), randn(3, 7, 4)], RED),
    "dot_4d_2d": (lambda o, a, b: a @ b, [randn(2, 3, 5, 7), randn(7, 4)], RED),
    "dot_3d_3d": (lambda o, a, b: a @ b, [randn(2, 5, 7), randn(2, 7, 3)], RED),
    "dot_broadcast_weight": (lambda o, a, b: a @ b, [randn(2, 5, 7), randn(1, 7, 3)], RED),
    "exp": (lambda o, a: o.exp(a), [randn(3, 4)], EW),
    "log": (lambda o, a: a.log(), [positive(3, 4)], EW),
    "sum_all": (lambda o, a: a.sum(), [randn(3, 4, 5)], RED),
    "sum_axis": (lambda o, a: a.sum(axis=1), [randn(3, 4, 5)], RED),
    "sum_tuple_keepdims": (lambda o, a: a.sum(axis=(0, 2), keepdims=True), [randn(3, 4, 5)], RED),
    "mean_all": (lambda o, a: a.mean(), [randn(3, 4)], RED),
    "mean_axis_neg": (lambda o, a: a.mean(axis=-1), [randn(3, 4, 5)], RED),
    "mean_keepdims": (lambda o, a: a.mean(axis=0, keepdims=True), [randn(3, 4)], RED),
    "max_all_tied": (lambda o, a: a.max(), [const([[1, 3, 3], [2, 3, 0]])], RED),
    "max_axis_tied": (lambda o, a: a.max(axis=1), [const([[1, 3, 3], [2, 2, 0]])], RED),
    "max_nonleading_axis": (lambda o, a: a.max(axis=2), [randn(2, 3, 4)], RED),
    "min_axis_tied": (lambda o, a: a.min(axis=0), [const([[1, 0, 3], [1, 2, 0]])], RED),
    "reshape": (lambda o, a: a.reshape((4, 6)), [randn(2, 3, 4)], EW),
    "transpose_default": (lambda o, a: a.T, [randn(3, 4)], EW),
    "transpose_axes": (lambda o, a: a.transpose((1, 0, 2)), [randn(2, 3, 4)], EW),
    "transpose_negative_axes": (lambda o, a: a.transpose((-1, 0, 1)), [randn(2, 3, 4)], EW),
    "flatten": (lambda o, a: a.flatten(), [randn(2, 3, 4)], EW),
    "getitem_slice": (lambda o, a: a[1:3, ::2], [randn(4, 5)], EW),
    "getitem_int": (lambda o, a: a[2], [randn(4, 5)], EW),
    "getitem_duplicate_rows": (lambda o, a: a[np.array([0, 2, 0, 0])], [randn(4, 5)], EW),
    "getitem_duplicate_cols": (lambda o, a: a[:, [1, 1, 3]], [randn(4, 5)], EW),
    "getitem_mask": (lambda o, a: a[np.arange(20).reshape(4, 5) % 3 == 0], [randn(4, 5)], EW),
    "clip_boundary": (lambda o, a: a.clip(-0.5, 0.5), [with_bounds(4, 6)], EW),
    "clip_min_only": (lambda o, a: a.clip(min=-0.5), [with_bounds(4, 6)], EW),
    "astype_int_to_float": (lambda o, a, b: o.astype_(a, np.float32) * b,
                            [const([[1, -2, 3]], np.int32), randn(2, 3)], EW),
    "astype_bf16_roundtrip": (lambda o, a: o.astype_(o.astype_(a, "bfloat16"), np.float32),
                              [randn(3, 4)], EW),
    "relu_at_zero": (lambda o, a: o.relu(a), [with_zeros(4, 6)], EW),
    "sigmoid": (lambda o, a: o.sigmoid(a), [randn(4, 6)], EW),
    "tanh": (lambda o, a: o.tanh(a), [randn(4, 6)], EW),
    "log_softmax_last": (lambda o, a: o.log_softmax(a), [randn(4, 10)], RED),
    "log_softmax_axis0": (lambda o, a: o.log_softmax(a, axis=0), [randn(4, 10)], RED),
    "softmax": (lambda o, a: o.softmax_(a, axis=-1), [randn(4, 10)], RED),
    "where": (lambda o, a, b: o.where(COND, a, b), [randn(3, 4), randn(1, 4)], EW),
    "shared_subgraph": (shared_subgraph, [randn(4, 3), randn(3, 5)], RED),
}


def _run(tensor_cls, ops, fn, arrays, cot):
    ts = [tensor_cls(a, requires_grad=True) for a in arrays]
    out = fn(ops, *ts)
    if cot is None:
        cot = np.asarray(np.random.RandomState(1).randn(*out.shape), np.float32)
    out.backward(cot)
    return (np.asarray(out.numpy(), np.float32),
            [np.asarray(t.grad, np.float32) for t in ts], cot)


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_matches_jax(name):
    fn, makers, tol = CASES[name]
    rng = np.random.RandomState(0)
    arrays = [m(rng) for m in makers]
    j_out, j_grads, cot = _run(JTensor, jops, fn, arrays, None)
    t_out, t_grads, _ = _run(TTensor, tops, fn, arrays, cot)
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out, **tol)
    for i, (tg, jg) in enumerate(zip(t_grads, j_grads)):
        assert tg.shape == jg.shape, (i, tg.shape, jg.shape)
        np.testing.assert_allclose(tg, jg, err_msg="grad of input %d" % i,
                                   **tol)


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 3, 5, 7)], ids=str)
def test_folded_dot_matches_the_batched_and_summed_form(shape):
    # an N-D a times a 2-D w: the forward and dX as one 2-D product over
    # a's rows, dW as one 2-D product over them (not B products summed)
    rng = np.random.RandomState(5)
    a_np = rng.randn(*shape).astype(np.float32)
    w_np = rng.randn(shape[-1], 4).astype(np.float32)
    cot = rng.randn(*shape[:-1], 4).astype(np.float32)
    a = TTensor(a_np, requires_grad=True)
    w = TTensor(w_np, requires_grad=True)
    out = tops.dot_(a, w)
    out.backward(cot)
    ta, tw, tc = (torch.from_numpy(x) for x in (a_np, w_np, cot))
    np.testing.assert_allclose(out.numpy(), torch.matmul(ta, tw).numpy(),
                               **RED)
    np.testing.assert_allclose(np.asarray(a.grad),
                               torch.matmul(tc, tw.T).numpy(), **RED)
    batched = torch.matmul(ta.transpose(-1, -2), tc)
    summed = batched.reshape(-1, *batched.shape[-2:]).sum(0)
    np.testing.assert_allclose(np.asarray(w.grad), summed.numpy(), **RED)


@pytest.mark.parametrize("w_shape", [(2, 7, 3), (1, 7, 3)],
                         ids=["3d_3d", "broadcast_weight"])
def test_n_d_weights_keep_torch_matmul(monkeypatch, w_shape):
    # both operands N-D: the forward and both VJPs stay torch.matmul
    from tinynn_autograd_tpu_torch.ops import kernels

    calls = []
    reference = kernels.matmul_reference
    monkeypatch.setattr(kernels, "matmul_reference",
                        lambda a, b: calls.append(1) or reference(a, b))
    rng = np.random.RandomState(6)
    a = TTensor(rng.randn(2, 5, 7).astype(np.float32), requires_grad=True)
    w = TTensor(rng.randn(*w_shape).astype(np.float32), requires_grad=True)
    out = tops.dot_(a, w)
    out.backward(np.ones(out.shape, np.float32))
    assert calls == []
    assert tuple(np.asarray(w.grad).shape) == w_shape


def test_backward_accumulates_into_leaves():
    """A second backward adds to the leaf gradients (reference contract)."""
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    grads = []
    for tensor_cls in (JTensor, TTensor):
        t = tensor_cls(x, requires_grad=True)
        y = (t * t).sum()
        y.backward()
        y.backward()
        grads.append(np.asarray(t.grad))
    np.testing.assert_allclose(grads[1], grads[0], **EW)
    np.testing.assert_allclose(grads[1], 4 * x, **EW)


def test_raw_torch_payloads_never_require_grad():
    a = TTensor(np.ones((2, 3), np.float32), requires_grad=True)
    b = TTensor(np.ones((3, 2), np.float32), requires_grad=True)
    loss = tops.relu(a @ b).sum()
    loss.backward()
    for t in (a, b, loss):
        assert not t.data.requires_grad
        assert not t.grad.requires_grad


def test_payload_dtypes_follow_the_jax_package():
    assert TTensor(np.zeros(3)).dtype == torch.float32      # f64 -> f32
    assert TTensor(1.5).dtype == torch.float32
    assert TTensor(np.zeros(3, np.int32)).dtype == torch.int32
    ints = TTensor(np.arange(3), requires_grad=True)
    assert ints.grad.dtype == torch.float32                  # float grads


def test_numpy_inputs_are_copied():
    arr = np.zeros(3, np.float32)
    t = TTensor(arr, requires_grad=True)
    t.data.add_(1.0)
    assert arr.sum() == 0.0
