"""The CUDA kernels on the card: the matmul (K1) and the whole-epoch kernel
(K2). Tests marked ``cuda``; they skip without a CUDA device, since the
kernels have no CPU mode.

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


def _flagship_epoch(dev, n_steps):
    """The flagship MLP (pinned seed-1 weights) as the whole-epoch kernel's
    inputs: net, optimizer, spec, n_steps batches of 128 and the step
    scalars. The data seed is
    pinned too: Adam turns a weight gradient whose terms nearly cancel into
    a full-size step, so the kernel's and cuBLAS's summation orders leave a
    few weights 1e-5 apart on some data (PERF.md), not on this."""
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.utils import datasets, seeder

    with seeder.scope(1):
        net = build_mnist_mlp()
    net.to(dev)
    opt = Adam(1e-3)
    (x, y), _ = datasets.synthetic_mnist(n_steps * 128, 10, seed=5)
    xb = torch.from_numpy(x).to(dev).reshape(n_steps, 128, 784)
    yb = torch.from_numpy(datasets.one_hot(y)).to(dev).reshape(n_steps, 128, 10)
    scalars = torch.from_numpy(opt.step_scalars(0, n_steps)).to(dev)
    return net, opt, fused_epoch.epoch_spec(net, opt), xb, yb, scalars


def _state(net, opt):
    from tinynn_autograd_tpu_torch.ops.fused_epoch import dense_leaves

    params = [{k: v.clone() for k, v in d.items()} for d in net.params_tree()]
    slots = opt.init_state(params)["slots"]
    return (dense_leaves(net, params),
            {k: dense_leaves(net, tree) for k, tree in slots.items()})


@pytest.mark.cuda
def test_cuda_fused_epoch_matches_reference_at_flagship_width():
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    net, opt, spec, xb, yb, scalars = _flagship_epoch(dev, 5)
    (kp, ks), (rp, rs) = _state(net, opt), _state(net, opt)
    before = fused_epoch.cuda_fused_epoch.launches
    got = fused_epoch.cuda_fused_epoch(spec, kp, ks, xb, yb, scalars)
    torch.cuda.synchronize()
    assert fused_epoch.cuda_fused_epoch.launches == before + 1
    ref = fused_epoch.fused_epoch_reference(spec, rp, rs, xb, yb, scalars)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    pairs = list(zip(kp, rp)) + [
        pair for k in ("m", "v") for pair in zip(ks[k], rs[k])]
    for i, (a, b) in enumerate(pairs):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg="leaf pair %d" % i)


@pytest.mark.cuda
def test_cuda_auto_epoch_is_one_fused_launch():
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=dev)
    rng = np.random.RandomState(0)
    x = rng.rand(4 * 128, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4 * 128)]
    k1, k2 = kernels.cuda_matmul.launches, fused_epoch.cuda_fused_epoch.launches
    losses = model.train_epoch(x, y, batch_size=128)
    torch.cuda.synchronize()
    assert fused_epoch.cuda_fused_epoch.launches == k2 + 1
    assert kernels.cuda_matmul.launches == k1
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert model.optimizer.state_dict()["t"] == 4
