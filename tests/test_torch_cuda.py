"""The CUDA matmul kernel on the card (tests marked ``cuda``; they skip
without a CUDA device, since the kernel has no CPU mode).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu_torch.ops import kernels

# the flagship MLP's products at batch 128: per Dense layer the forward
# x @ W, the weight gradient x^T @ g and the input gradient g @ W^T (the
# first layer has none), as (m, k, n, a transposed, b transposed); then the
# 10,000-row eval product and two ragged shapes
LAYERS = [(784, 200), (200, 100), (100, 70), (70, 30), (30, 10)]
SHAPES = ([(128, i, o, False, False) for i, o in LAYERS]
          + [(i, 128, o, True, False) for i, o in LAYERS]
          + [(128, o, i, False, True) for i, o in LAYERS[1:]]
          + [(10000, 784, 200, False, False), (130, 129, 131, False, False),
             (1, 784, 200, False, False)])


def _operands(m, k, n, ta, tb, device, dtype):
    """A transposed operand is a transposed VIEW of a contiguous tensor, as
    the tape's VJPs pass it."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((k, m) if ta else (m, k), generator=gen)
    b = torch.randn((n, k) if tb else (k, n), generator=gen)
    a, b = a.to(device, dtype), b.to(device, dtype)
    return (a.T if ta else a), (b.T if tb else b)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_reference_at_flagship_shapes(dtype):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-1))
    for shape in SHAPES:
        a, b = _operands(*shape, dev, getattr(torch, dtype))
        before = kernels.cuda_matmul.launches
        got = kernels.cuda_matmul(a, b)
        torch.cuda.synchronize()
        assert kernels.cuda_matmul.launches == before + 1
        ref = kernels.matmul_reference(a, b)
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   err_msg=str(shape), **tol)


@pytest.mark.cuda
def test_cuda_train_step_launches_fourteen_kernels():
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam

    dev = _cuda()
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=dev)
    rng = np.random.RandomState(0)
    x = rng.rand(128, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 128)]
    before = kernels.cuda_matmul.launches
    model.train_step(x, y)
    assert kernels.cuda_matmul.launches == before + 14
    model.predict(x)
    assert kernels.cuda_matmul.launches == before + 19
