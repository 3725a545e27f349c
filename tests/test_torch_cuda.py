"""The CUDA kernels on the card: the matmul (K1), the whole-epoch kernel
(K2, with Dropout and the seven optimizer rules), the weight-streaming
kernels (K3, K3b), the flash-attention kernels (K4's forward, K4b-d's dq and
dk/dv, their 3xTF32 products also held against float64), the recurrent
kernels (K5-K5d), the dropout pass (P1), the optimizer-only probe (P2), the
fused transformer-block forward (K7), the ring all-reduce (P3) and the
whole-epoch kernel over ranks with its gradient ring (K6).
Tests marked ``cuda``; they skip without a CUDA device, since the kernels
have no CPU mode.

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


# the other main paths' products, as (m, k, n, a transposed, b transposed):
# config 8's ten a step (two LSTM layers of 256, T = 128, batch 64: the
# input projections, the head's three, dx of layer 2 through wx^T, dWx and
# dWh through the transposed sequences), 6b's three (its head), and ragged
# shapes that no 16-byte copy fits
CONFIG8_SHAPES = [(8192, 64, 1024, False, False),
                  (8192, 256, 1024, False, False),
                  (64, 256, 16, False, False), (256, 64, 16, True, False),
                  (64, 16, 256, False, True), (8192, 1024, 256, False, True),
                  (256, 8192, 1024, True, False),
                  (64, 8192, 1024, True, False)]
CONFIG6B_SHAPES = [(4, 512, 16, False, False), (512, 4, 16, True, False),
                   (4, 16, 512, False, True)]
RAGGED_SHAPES = [(130, 129, 131, False, False), (1, 784, 200, False, False),
                 (3, 1001, 7, True, True), (129, 1031, 65, True, False),
                 (200, 17, 333, False, True), (1, 1, 1, False, False)]
MAIN_SHAPES = {"config8": CONFIG8_SHAPES, "config6b": CONFIG6B_SHAPES,
               "ragged": RAGGED_SHAPES}


def _hold_matmul(a, b, dtype, what, plan=None):
    got = kernels.cuda_matmul(a, b, plan)
    torch.cuda.synchronize()
    ref = kernels.matmul_reference(a, b)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-1))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), err_msg=what,
                               **tol)
    return got


# past this depth the rounding of an f32 sum of unit-normal products
# reaches the f32 gate's atol (K1's one chain of K products an output: up
# to 3.9e-4 against float64 at K = 8,192 on the H100, cuBLAS's 2.1e-4):
# there the kernel is held against float64 within LONG_K_FACTOR times
# cuBLAS's f32 error on the same operands, a limit TF32 must miss
LONG_K = 256
LONG_K_FACTOR = 4.0


def _long_k_errors(a, b, got):
    """max |C - A B| (A B in float64) of the kernel's C, cuBLAS's f32 C and
    cuBLAS's TF32 C."""
    exact = torch.matmul(a.double(), b.double())
    f32 = torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return [float((c.double() - exact).abs().max()) for c in (got, f32, tf32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", sorted(MAIN_SHAPES))
def test_cuda_kernel_matches_reference_at_main_path_shapes(group, dtype):
    # config 8's f32 products past K = LONG_K against float64, beside
    # cuBLAS; every other product at the gate (on a config-8 step's own
    # operands all ten at the gate: the test below)
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype)
    for shape in MAIN_SHAPES[group]:
        a, b = _operands(*shape, dev, dtype)
        if group == "config8" and dtype == torch.float32 \
                and shape[1] > LONG_K:
            mine, f32, tf32 = _long_k_errors(a, b, kernels.cuda_matmul(a, b))
            assert mine <= LONG_K_FACTOR * f32, (shape, mine, f32)
            assert tf32 > LONG_K_FACTOR * f32, (shape, tf32, f32)
        else:
            _hold_matmul(a, b, dtype, str(shape))


@pytest.mark.cuda
def test_cuda_kernel_matches_reference_on_a_config8_step():
    # the ten products of one config-8 train step (two LSTM layers of 256,
    # T = 128, batch 64), on the operands the step gives K1
    from tinynn_autograd_tpu_torch.models import build_rnn_classifier
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(build_rnn_classifier(64, 16, hidden=(256, 256), seed=77),
                  SoftmaxCrossEntropyLoss(), Adam(1e-3), device=dev)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 128, 64).astype(np.float32)
    y = np.eye(16, dtype=np.float32)[rng.randint(0, 16, 64)]
    seen, matmul = [], kernels.matmul

    def record(a, b):
        seen.append((a.clone(), b.clone()))
        return matmul(a, b)

    kernels.matmul = record
    try:
        model.train_step(x, y)
    finally:
        kernels.matmul = matmul
    assert sorted((a.shape[0], a.shape[1], b.shape[1]) for a, b in seen) \
        == sorted(s[:3] for s in CONFIG8_SHAPES + [CONFIG8_SHAPES[6]] * 2)
    for a, b in seen:
        _hold_matmul(a, b, torch.float32, str((a.shape, b.shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [0, 1, 2, 3])
@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_cuda_kernel_matches_reference_at_every_plan(config, split):
    # each tile configuration at each of these splits, over every layout:
    # unit strides along the tile's rows (16-byte copies), across them, an
    # operand one float off 16-byte alignment, and ragged edges
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    bm, bn = kernels.MATMUL_TILES[config][:2]
    m, k, n = 2 * bm + 3, 16 * 8 * split + 5, bn + 9
    chunk = -(-(-(-k // split)) // 16) * 16
    plan = kernels.MatmulPlan(config, bm, bn, split, chunk)
    for ta in (False, True):
        for tb in (False, True):
            a, b = _operands(m, k, n, ta, tb, dev, torch.float32)
            _hold_matmul(a, b, torch.float32, "%s %s" % (ta, tb), plan)
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(m * k + 1, generator=gen).to(dev)[1:].view(m, k)
    b = torch.randn(k * n + 1, generator=gen).to(dev)[1:].view(k, n)
    _hold_matmul(a, b, torch.float32, "misaligned", plan)
    _hold_matmul(a.to(torch.bfloat16), b, torch.float32, "bf16 @ f32", plan)


@pytest.mark.cuda
def test_cuda_matmul_tiles_hold_the_measured_blocks_an_sm():
    # plan_matmul's cost model takes each configuration's blocks an SM from
    # MATMUL_TILES: it must be what the card reports for the built kernel
    _cuda()
    for config, (_, _, per_sm, _) in enumerate(kernels.MATMUL_TILES):
        assert kernels.matmul_occupancy(config, 1)[0] == per_sm, config


@pytest.mark.cuda
def test_cuda_split_k_reruns_are_bit_identical():
    dev = _cuda()
    for m, k, n, ta, tb in [(64, 8192, 1024, True, False),
                            (256, 8192, 1024, True, False),
                            (128, 784, 200, False, False),
                            (128, 100, 200, False, True)]:
        assert kernels.plan_matmul(m, n, k).split > 1
        a, b = _operands(m, k, n, ta, tb, dev, torch.float32)
        first = kernels.cuda_matmul(a, b)
        again = kernels.cuda_matmul(a, b)
        torch.cuda.synchronize()
        assert torch.equal(first, again), (m, k, n)


@pytest.mark.cuda
def test_cuda_matmul_refuses_a_bad_plan():
    dev = _cuda()
    a, b = _operands(64, 100, 64, False, False, dev, torch.float32)
    before = kernels.cuda_matmul.launches
    for plan in (kernels.MatmulPlan(0, 64, 64, 9, 16),   # past 8 blocks
                 kernels.MatmulPlan(0, 64, 64, 2, 112),  # an empty slice
                 kernels.MatmulPlan(0, 64, 64, 2, 32),   # K not covered
                 kernels.MatmulPlan(5, 64, 64, 1, 100),   # no such tile
                 # the tensor-core tile: slices not of whole 32-deep stages
                 kernels.MatmulPlan(4, 128, 128, 1, 100)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.cuda_matmul(a, b, plan)
    # the tensor-core tile refuses operands it cannot read: rows off 16-byte
    # alignment, and bf16
    tc = kernels.MatmulPlan(4, 128, 128, 1, 128)
    gen = torch.Generator().manual_seed(2)
    off = torch.randn(64 * 100 + 1, generator=gen).to(dev)[1:].view(64, 100)
    for x, y in ((off, b), (a.to(torch.bfloat16), b.to(torch.bfloat16))):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.cuda_matmul(x, y, tc)
    assert kernels.cuda_matmul.launches == before


# config 6b's block products as the tape hands them to K1, (m, k, n, a
# transposed, b transposed): the forward [8192, 512] @ [512, 512 | 2048]
# and [8192, 2048] @ [2048, 512]; the input gradients through the weights'
# transposed views; the folded weight gradients, X^T @ G over all 8,192
# tokens (both operands views of [4, 2048, .] activations); and ragged
# shapes on the tensor-core tile
TC_SHAPES = [(8192, 512, 512, False, False), (8192, 512, 2048, False, False),
             (8192, 2048, 512, False, False), (8192, 512, 512, False, True),
             (8192, 2048, 512, False, True), (8192, 512, 2048, False, True),
             (512, 8192, 512, True, False), (512, 8192, 2048, True, False),
             (2048, 8192, 512, True, False), (1000, 516, 1028, False, False),
             (332, 1028, 260, True, True)]
TC_FACTOR = 4.0  # the contract of the attention kernels and of long K


def _tc_operands(m, k, n, ta, tb, dev, seed=0):
    """The 6b layouts: a transposed A is the [tokens, m] activations of a
    [4, tokens / 4, m] tensor, folded and transposed; B likewise."""
    gen = torch.Generator().manual_seed(seed)
    if ta:
        a = torch.randn(4, k // 4, m, generator=gen).to(dev)
        a = a.reshape(-1, m).T
    else:
        a = torch.randn(m, k, generator=gen).to(dev)
    b = torch.randn((n, k) if tb else (k, n), generator=gen).to(dev)
    return a, (b.T if tb else b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
def test_cuda_tensor_core_tile_holds_against_float64(shape):
    # 3xTF32 within TC_FACTOR times the f32 plain version's (cuBLAS, TF32
    # off) error against float64; plain TF32 misses that; reruns of a plan
    # are bit-identical; tc_launches counts each launch
    from tinynn_autograd_tpu_torch.ops import tf32

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n, ta, tb = shape
    a, b = _tc_operands(*shape, dev)
    assert kernels.tc_aligned(a, b)
    plan = kernels.plan_matmul(m, n, k, aligned=True)
    assert plan.config == kernels.MATMUL_TC, plan
    before = (kernels.cuda_matmul.launches, kernels.cuda_matmul.tc_launches)
    got = kernels.cuda_matmul(a, b)
    again = kernels.cuda_matmul(a, b)
    torch.cuda.synchronize()
    assert (kernels.cuda_matmul.launches, kernels.cuda_matmul.tc_launches) \
        == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    exact = torch.matmul(a.double(), b.double())
    mine, f32, plain_tf32 = [
        float((c.double() - exact).abs().max())
        for c in (got, kernels.matmul_reference(a, b), tf32.matmul_tf32(a, b))]
    assert mine <= TC_FACTOR * f32, (shape, mine, f32)
    assert plain_tf32 > TC_FACTOR * f32, (shape, plain_tf32, f32)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_cuda_tensor_core_tile_matches_reference_at_every_split(split):
    # the tensor-core tile at these splits over the four layouts it reads,
    # with ragged edges in m, n and k
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    # ragged against the 128x128 tile and the 32-deep stages, and every
    # stride a multiple of 4 (the tile's 16-byte rows)
    m, k, n = 2 * 128 + 4, 32 * 5 * split - 20, 128 + 12
    slices, chunk = kernels._k_slices(k, split, kernels.MATMUL_TC_BK)
    assert slices == split
    plan = kernels.MatmulPlan(kernels.MATMUL_TC, 128, 128, split, chunk)
    for ta in (False, True):
        for tb in (False, True):
            a, b = _operands(m, k, n, ta, tb, dev, torch.float32)
            assert kernels.tc_aligned(a, b)
            _hold_matmul(a, b, torch.float32, "%s %s" % (ta, tb), plan)


@pytest.mark.cuda
def test_cuda_unaligned_products_keep_the_cuda_core_tiles():
    dev = _cuda()
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(1000 * 517 + 1, generator=gen).to(dev)[1:].view(1000, 517)
    b = torch.randn(517, 300, generator=gen).to(dev)
    assert not kernels.tc_aligned(a, b)
    before = kernels.cuda_matmul.tc_launches
    _hold_matmul(a, b, torch.float32, "unaligned")
    assert kernels.cuda_matmul.tc_launches == before


@pytest.mark.cuda
def test_cuda_folded_products_go_through_the_kernel():
    # a Dense on a sequence: [4, 2048, 512] @ [512, 2048] is one launch of
    # the tensor-core tile, and its dW one more, through dot_
    from tinynn_autograd_tpu_torch.core.tensor import Tensor
    from tinynn_autograd_tpu_torch.ops import primitives

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    x = Tensor(torch.randn(4, 2048, 512, generator=gen).to(dev),
               requires_grad=True)
    w = Tensor(torch.randn(512, 2048, generator=gen).to(dev) * 0.05,
               requires_grad=True)
    before = (kernels.cuda_matmul.launches, kernels.cuda_matmul.tc_launches)
    y = primitives.dot_(x, w)
    y.backward(torch.ones(4, 2048, 2048, device=dev))
    torch.cuda.synchronize()
    assert (kernels.cuda_matmul.launches - before[0],
            kernels.cuda_matmul.tc_launches - before[1]) == (3, 3)
    xs, ws = x.data.reshape(-1, 512), w.data
    np.testing.assert_allclose(y.data.reshape(-1, 2048).cpu().numpy(),
                               kernels.matmul_reference(xs, ws).cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    g = torch.ones(8192, 2048, device=dev)
    np.testing.assert_allclose(
        w.grad.cpu().numpy(), kernels.matmul_reference(xs.T, g).cpu().numpy(),
        rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
def test_cuda_folded_rows_past_the_grid_launch_in_runs():
    # [2, rows / 2, 16] @ [16, 24] with more rows than a launch's grid holds:
    # two launches through matmul, one result
    dev = _cuda()
    rows = kernels.MATMUL_MAX_ROWS + 200
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(2, rows // 2, 16, generator=gen).to(dev)
    b = torch.randn(16, 24, generator=gen).to(dev)
    before = kernels.cuda_matmul.launches
    got = kernels.matmul(a, b)
    torch.cuda.synchronize()
    assert kernels.cuda_matmul.launches == before + 2
    assert tuple(got.shape) == (2, rows // 2, 24)
    want = kernels.matmul_reference(a.reshape(-1, 16), b)
    torch.testing.assert_close(got.reshape(-1, 24), want, rtol=1e-5,
                               atol=1e-4)


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
@pytest.mark.parametrize("plan_name", ["default", "single_slice"])
def test_cuda_fused_epoch_holds_under_its_plan_and_single_slices(plan_name):
    # K2 under the plan it launches (K split across a cluster's blocks) and
    # under one forced to one K slice a product: both within the gates of
    # the plain version in its default order of sums, so the split is not
    # what keeps the numbers in
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    net, opt, spec, xb, yb, scalars = _flagship_epoch(dev, 10)
    plan = fused_epoch.epoch_plan(spec, 128)
    if plan_name == "default":
        assert max(max(split) for split in plan.splits) > 1
    else:
        plan = fused_epoch.plan_epoch(spec.layers, 128, plan.blocks,
                                      max_split=1)
    (kp, ks), (rp, rs) = _state(net, opt), _state(net, opt)
    got = fused_epoch.cuda_fused_epoch(spec, kp, ks, xb, yb, scalars,
                                       plan=plan)
    torch.cuda.synchronize()
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
def test_cuda_traced_k2_epochs_add_into_the_phase_counter():
    # two traced epochs with no synchronise between them: K2's phase clock
    # adds both launches into k2.phase_ns, k2.steps counts both, and K2's
    # host spans open once a launch; untraced, nothing is recorded
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.utils import datasets, profiler

    dev = _cuda()
    n_steps = 20
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=dev)
    (x, y), _ = datasets.synthetic_mnist(n_steps * 128, 10, seed=5)
    x, y = model.stage(x, datasets.one_hot(y))
    profiler.reset()
    model.train_epoch(x, y, fused=True)
    torch.cuda.synchronize()
    assert profiler.totals() == {}
    with profiler.recording():
        model.train_epoch(x, y, fused=True)
        one = profiler.totals()
        profiler.reset()
        before = fused_epoch.cuda_fused_epoch.launches
        model.train_epoch(x, y, fused=True)
        model.train_epoch(x, y, fused=True)
        assert fused_epoch.cuda_fused_epoch.launches == before + 2
        two = profiler.totals()
    profiler.reset()
    spec = fused_epoch.epoch_spec(model.net, model.optimizer)
    assert list(one["k2.phase_ns"]) == fused_epoch.phase_names(spec)
    assert one["k2.steps"] == n_steps and two["k2.steps"] == 2 * n_steps
    assert all(v > 0 for v in two["k2.phase_ns"].values())
    ratio = sum(two["k2.phase_ns"].values()) / sum(one["k2.phase_ns"].values())
    assert 1.5 < ratio < 2.5
    for name in ("tinynn.epoch", "tinynn.k2.scalars", "tinynn.k2.plan",
                 "tinynn.k2.launch"):
        assert two[name]["count"] == 2
    assert two["tinynn.k2.plan"]["ns"] <= two["tinynn.k2.launch"]["ns"]


@pytest.mark.cuda
def test_cuda_fused_epoch_matches_reference_at_ragged_widths():
    # inputs of 30 features (rows padded to 32 for the 16-byte copies),
    # widths 20 and 5 (the kernel's copies of w and its activations padded
    # to whole float4s), Tanh and a class-weighted loss: K2 against its
    # plain version at K2's gates
    from tinynn_autograd_tpu_torch.nn import layers
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.net import Net
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.utils import seeder

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    with seeder.scope(3):
        net = Net([layers.Dense(20, num_in=30), layers.Tanh(),
                   layers.Dense(5, num_in=20)])
    net.to(dev)
    opt = Adam(1e-3)
    spec = fused_epoch.epoch_spec(net, opt)
    rng = np.random.RandomState(0)
    n_steps, batch = 5, 24
    xb = torch.from_numpy(rng.randn(n_steps, batch, 30).astype(np.float32))
    yb = torch.from_numpy(np.eye(5, dtype=np.float32)[
        rng.randint(0, 5, (n_steps, batch))])
    weight = torch.tensor([0.5, 1.0, 1.5, 2.0, 1.0], device=dev)
    xb, yb = xb.to(dev), yb.to(dev)
    scalars = torch.from_numpy(opt.step_scalars(0, n_steps)).to(dev)
    (kp, ks), (rp, rs) = _state(net, opt), _state(net, opt)
    got = fused_epoch.cuda_fused_epoch(spec, kp, ks, xb, yb, scalars,
                                       class_weight=weight)
    torch.cuda.synchronize()
    ref = fused_epoch.fused_epoch_reference(spec, rp, rs, xb, yb, scalars,
                                            class_weight=weight)
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


# the streaming kernels: (layers, batch, width, activation); the deep MLP's
# body at batch 128, with ReLU and with the two bodies whose derivative is
# neither 0 nor 1, a ragged batch on a 3-block cluster, a cluster of one, a
# width past 3488, where a cluster of K3 takes one row and K3b's first pass
# eight, and a width past 3616, where a cluster of either takes one
STREAM_SHAPES = {"deep_mlp": (98, 128, 256, "relu"),
                 "deep_tanh": (98, 128, 256, "tanh"),
                 "deep_sigmoid": (98, 128, 256, "sigmoid"),
                 "ragged": (3, 20, 96, "tanh"),
                 "narrow": (2, 5, 32, "sigmoid"),
                 "mid": (4, 17, 3520, "relu"),
                 "wide": (1, 3, 3648, "linear")}
# a 98-layer chain of f32 sums in two orders: the error grows with depth (up
# to 1.5e-5 on values of order 1 seen on an H100 at the deep MLP's shape)
STREAM_TOL = dict(rtol=1e-4, atol=1e-4)
# K3b's outputs differ in size by orders of magnitude (Adam's v is 1e-3 g^2,
# a weight's step 1e-3 of the weight): each is held at rtol 1e-4 and an atol
# of 1e-4 of its own largest plain value (and 1e-30, for a sigmoid stack's
# gradients that vanish to 0 or to subnormals)
SCALED_RTOL = 1e-4
SCALED_ATOL = 1e-4


def _stream_inputs(dev, n_layers, batch, width, act, seed=0):
    """h0, w, b and the loss gradient at the body's output, from numpy. The
    weights of a ReLU stack carry gain sqrt(2) over Xavier, so every layer
    holds values of order 1 (at Xavier gain they shrink ~0.7x a layer). A
    tanh stack keeps Xavier's: at sqrt(2) it is chaotic, and its 98-layer
    chain would grow a rounding-level difference past the tolerance."""
    rng = np.random.RandomState(seed)
    gain = 1.0 if act == "tanh" else np.sqrt(2.0)
    bound = gain * np.sqrt(6.0 / (2 * width))
    arrays = (rng.randn(batch, width),
              rng.uniform(-bound, bound, (n_layers, width, width)),
              0.1 * rng.randn(n_layers, 1, width),
              rng.randn(batch, width) / batch)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def _close(got, want, what):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               err_msg=what, **STREAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(STREAM_SHAPES))
def test_cuda_stream_forward_matches_reference(shape):
    from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    n_layers, batch, width, act = STREAM_SHAPES[shape]
    h0, w, b, _ = _stream_inputs(dev, n_layers, batch, width, act)
    before = se.cuda_stream_forward.launches
    got = se.cuda_stream_forward(h0, w, b, act)
    torch.cuda.synchronize()
    assert se.cuda_stream_forward.launches == before + 1
    _close(got, se.stream_forward_reference(h0, w, b, act), "acts")
    assert torch.equal(got, se.cuda_stream_forward(h0, w, b, act))


def _close_scaled(got, want, what, ulp_of=None):
    """``got`` within rtol SCALED_RTOL and an atol of SCALED_ATOL of
    max|want| of ``want``; plus, where ``ulp_of`` is given, one unit in the
    last place of it: a step read back as new w - w carries the rounding of
    the new w."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    allowed = (SCALED_ATOL * float(np.max(np.abs(want), initial=0.0)) + 1e-30
               + SCALED_RTOL * np.abs(want))
    if ulp_of is not None:
        allowed = allowed + np.spacing(np.abs(ulp_of.cpu().numpy()))
    over = np.abs(got - want) > allowed
    assert not over.any(), "%s: %d of %d elements outside, largest " \
        "difference %.3g" % (what, over.sum(), over.size,
                             np.max(np.abs(got - want)))


def _backward_both(dev, shape, opt_name, steps=1, kernel_only=False):
    """The starting w, the optimizer, and the kernel's (and unless
    ``kernel_only`` the plain version's) results of ``steps`` K3b calls
    from one state: the new w, each slot, db and dh0."""
    from tinynn_autograd_tpu_torch.nn import optimizer
    from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

    torch.backends.cuda.matmul.allow_tf32 = False
    n_layers, batch, width, act = STREAM_SHAPES[shape]
    h0, w, b, dlast = _stream_inputs(dev, n_layers, batch, width,
                                      act)
    opt = getattr(optimizer, opt_name)(lr=1e-3, weight_decay=1e-4)
    acts = se.stream_forward_reference(h0, w, b, act)
    runs = []
    fns = [se.cuda_stream_backward]
    if not kernel_only:
        fns.append(se.stream_backward_reference)
    for fn in fns:
        wk = w.clone()
        slots = {n: torch.zeros_like(w) for n in opt.slot_names}
        for t in range(1, steps + 1):
            db, dh0 = fn(act, opt, h0, dlast, acts, wk, slots,
                         opt.scalars(1e-3, t))
        torch.cuda.synchronize()
        runs.append([wk] + [slots[n] for n in opt.slot_names] + [db, dh0])
    return w, opt, runs


def _hold_outputs(w0, got, want):
    """The kernel's outputs against ``want``, each at its own scale: the
    step w took (not w itself, whose size would hide an error of the
    step), each slot, db and dh0."""
    _close_scaled(got[0] - w0, want[0] - w0, "the step of w", ulp_of=want[0])
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        _close_scaled(a, b, "output %d" % (i + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["Adam", "SGD"])
@pytest.mark.parametrize("shape", ["deep_mlp", "deep_tanh", "deep_sigmoid",
                                   "ragged", "mid", "wide"])
def test_cuda_stream_backward_matches_reference(shape, opt_name):
    from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

    dev = _cuda()
    before = se.cuda_stream_backward.launches
    w0, opt, (got, want) = _backward_both(dev, shape, opt_name)
    assert se.cuda_stream_backward.launches == before + 1
    if opt_name == "Adam":
        # Adam turns a gradient within rounding of 0 into a step of up to
        # lr whose sign the order of the sum decides: the kernel's step is
        # held to Adam's rule on its own new m and v, which are held to the
        # plain version's
        scale, rsqrt_c2 = opt.scalars(1e-3, 1)
        m, v = got[1], got[2]
        want[0] = w0 + (scale * m / (torch.sqrt(v) * rsqrt_c2 + opt._eps)
                        - opt.weight_decay * w0)
    _hold_outputs(w0, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["Momentum", "Lion", "RMSProp",
                                      "Adagrad", "Adadelta"])
def test_cuda_stream_backward_applies_every_rule(opt_name):
    _cuda()
    w0, _, (got, want) = _backward_both(torch.device("cuda"), "ragged",
                                        opt_name, steps=3)
    _hold_outputs(w0, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["deep_mlp", "deep_tanh", "deep_sigmoid"])
def test_cuda_stream_backward_reruns_are_bit_identical(shape):
    # five runs from one state; with tanh and sigmoid a block that read a
    # neighbour's slice of the dh panel while the neighbour changed it would
    # show here as a run that differs
    _cuda()
    first = _backward_both(torch.device("cuda"), shape, "Adam",
                           kernel_only=True)[2][0]
    for _ in range(4):
        again = _backward_both(torch.device("cuda"), shape, "Adam",
                               kernel_only=True)[2][0]
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_auto_deep_mlp_epoch_takes_the_stream_tier():
    from tinynn_autograd_tpu_torch.models import build_deep_mlp
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

    dev = _cuda()
    model = Model(build_deep_mlp(num_in=64, depth=10, width=128, num_out=10,
                                 stacked=True),
                  SoftmaxCrossEntropyLoss(), Adam(1e-3), device=dev)
    rng = np.random.RandomState(0)
    x = rng.randn(4 * 32, 64).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4 * 32)]
    counts = (kernels.cuda_matmul.launches,
              fused_epoch.cuda_fused_epoch.launches,
              se.cuda_stream_forward.launches, se.cuda_stream_backward.launches)
    losses = model.train_epoch(x, y, batch_size=32)
    torch.cuda.synchronize()
    assert (kernels.cuda_matmul.launches - counts[0],
            fused_epoch.cuda_fused_epoch.launches - counts[1],
            se.cuda_stream_forward.launches - counts[2],
            se.cuda_stream_backward.launches - counts[3]) == (20, 0, 4, 4)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert model.optimizer.state_dict()["t"] == 4


# the attention kernels: (B, H, Hkv, Tq, Tk, d, causal, window, dropout) at
# the shapes of chip_smoke.py: config 6b's (the shape that takes K4 and K4d
# on the TPU), the shapes that take K4b (T=512) and K4c (non-causal T=2048)
# there, config 6's, a 512 window (config 6d), a window narrower than a tile
# over a ragged T, GQA 8q/2kv, cross attention, dropout 0.1, and head dims
# 128 and 40 (zero-padded to 64)
ATTN_SHAPES = {"config6b": (4, 8, 8, 2048, 2048, 64, True, None, 0.0),
               "k4b_t512": (4, 8, 8, 512, 512, 64, True, None, 0.0),
               "k4c_noncausal": (4, 8, 8, 2048, 2048, 64, False, None, 0.0),
               "config6": (32, 8, 8, 128, 128, 32, False, None, 0.0),
               "window512": (4, 8, 8, 2048, 2048, 64, True, 512, 0.0),
               "window40_ragged": (2, 4, 4, 300, 300, 64, True, 40, 0.0),
               "gqa_8q_2kv": (2, 8, 2, 256, 256, 64, True, None, 0.0),
               "cross_256_384": (2, 4, 4, 256, 384, 64, False, None, 0.0),
               "dropout": (1, 4, 4, 2048, 2048, 64, True, None, 0.1),
               "d128_gqa_dropout": (1, 4, 2, 200, 200, 128, True, None, 0.1),
               "d40": (1, 2, 1, 100, 100, 40, False, None, 0.0)}
# O and lse are sums of 2048 f32 terms in another order: rtol 1e-4, atol
# 1e-5; dq, dk and dv each at rtol 1e-4 and an atol of 1e-4 of their own
# largest plain value (their size varies with the shape)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)


def _attn_inputs(dev, name, seed=0, shapes=ATTN_SHAPES):
    """q, k, v, dO of ``name``'s shape (in ``shapes``) on ``dev`` (q and dO
    as the strided views that split heads makes of a [B, T, H, d] tensor),
    and the call's keyword arguments."""
    b, h, hkv, tq, tk, d, causal, window, rate = shapes[name]
    rng = np.random.RandomState(seed)

    def heads(n, t):
        x = rng.randn(b, t, n, d).astype(np.float32)
        return torch.from_numpy(x).to(dev).permute(0, 2, 1, 3)

    q, k, v, do = heads(h, tq), heads(hkv, tk), heads(hkv, tk), heads(h, tq)
    kw = dict(causal=causal, scale=1.0 / np.sqrt(d), window=window,
              dropout_rate=rate, seed=1234 if rate else None)
    return q, k, v, do, kw


def _attn_forward_both(dev, name):
    from tinynn_autograd_tpu_torch.ops import attention

    q, k, v, do, kw = _attn_inputs(dev, name)
    got = attention.cuda_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention.attention_forward_reference(q, k, v, **kw)
    return (q, k, v, do, kw), got, want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ATTN_SHAPES))
def test_cuda_attention_forward_matches_reference(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    before = attention.cuda_attention_forward.launches
    (q, k, v, _, kw), got, want = _attn_forward_both(dev, name)
    assert attention.cuda_attention_forward.launches == before + 1
    for what, a, b in zip(("o", "lse"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   err_msg=what, **ATTN_TOL)
    again = attention.cuda_attention_forward(q, k, v, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ATTN_SHAPES))
def test_cuda_attention_backward_matches_reference(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    (q, k, v, do, kw), _, (o, lse) = _attn_forward_both(dev, name)
    delta = (do * o).sum(dim=-1)
    counts = (attention.cuda_attention_backward_dq.launches,
              attention.cuda_attention_backward_dkv.launches)
    runs = []
    for _ in range(2):
        dq = attention.cuda_attention_backward_dq(q, k, v, do, lse, delta,
                                                  **kw)
        dk, dv = attention.cuda_attention_backward_dkv(q, k, v, do, lse,
                                                       delta, **kw)
        torch.cuda.synchronize()
        runs.append((dq, dk, dv))
    assert (attention.cuda_attention_backward_dq.launches,
            attention.cuda_attention_backward_dkv.launches) == (
                counts[0] + 2, counts[1] + 2)
    want = attention.attention_backward_reference(q, k, v, do, lse, delta,
                                                  **kw)
    for what, a, b in zip(("dq", "dk", "dv"), runs[0], want):
        b = b.cpu().numpy()
        np.testing.assert_allclose(
            a.cpu().numpy(), b, rtol=1e-4,
            atol=1e-4 * float(np.abs(b).max()), err_msg=what)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# the dk/dv kernel of head dims 65-128 (wgmma, `dkv_design`): head dims 128,
# 96, 80 and 66 (zero-padded; 66 ends rows mid-float4), GQA groups 1, 2 and
# 8, windows of 40, 50, 100 and
# 1,024 (off and on the 32- and 64-row tile edges) over ragged T (200, 300,
# 1,100), cross attention with Tq above and below Tk, dropout; q, k, v and dO
# as the strided views of split heads, read in place
DKV_WGMMA_SHAPES = {
    "d128_causal": (2, 4, 4, 256, 256, 128, True, None, 0.0),
    "d96_gqa2_window40_t300": (2, 4, 2, 300, 300, 96, True, 40, 0.0),
    "d80_gqa8_window100_t200": (1, 8, 1, 200, 200, 80, True, 100, 0.0),
    "d128_gqa8_window1024_t1100": (1, 16, 2, 1100, 1100, 128, True, 1024,
                                   0.0),
    "d128_gqa2_cross_384_256": (2, 4, 2, 384, 256, 128, False, None, 0.0),
    "d96_cross_200_300": (1, 2, 1, 200, 300, 96, False, None, 0.0),
    "d128_gqa2_dropout_t300": (1, 4, 2, 300, 300, 128, True, None, 0.1),
    "d80_noncausal_dropout": (2, 2, 2, 160, 160, 80, False, None, 0.2),
    "d66_gqa2_window50_t130": (1, 4, 2, 130, 130, 66, True, 50, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DKV_WGMMA_SHAPES))
def test_cuda_dkv_wgmma_matches_reference(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    fn = attention.cuda_attention_backward_dkv
    q, k, v, do, kw = _attn_inputs(dev, name, shapes=DKV_WGMMA_SHAPES)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    o, lse = attention.attention_forward_reference(q, k, v, **kw)
    bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
    counts = (fn.launches, fn.wgmma_launches)
    runs = [fn(*bwd, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (counts[0] + 2, counts[1] + 2)
    _, *want = attention.attention_backward_reference(*bwd, **kw)
    for what, a, b in zip(("dk", "dv"), runs[0], want):
        b = b.cpu().numpy()
        np.testing.assert_allclose(
            a.cpu().numpy(), b, rtol=1e-4,
            atol=1e-4 * float(np.abs(b).max()), err_msg=what)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# the dq kernel of head dims 65-128 (wgmma, `dq_design`): the dk/dv kernel's
# shapes, and a Tq of 40 against 300 keys (one block whose second consumer
# owns no query)
DQ_WGMMA_SHAPES = dict(DKV_WGMMA_SHAPES, d128_cross_40_300=(
    1, 2, 1, 40, 300, 128, False, None, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DQ_WGMMA_SHAPES))
def test_cuda_dq_wgmma_matches_reference(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    fn = attention.cuda_attention_backward_dq
    q, k, v, do, kw = _attn_inputs(dev, name, shapes=DQ_WGMMA_SHAPES)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    o, lse = attention.attention_forward_reference(q, k, v, **kw)
    bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
    counts = (fn.launches, fn.wgmma_launches)
    runs = [fn(*bwd, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (counts[0] + 2, counts[1] + 2)
    want = attention.attention_backward_reference(*bwd, **kw)[0].cpu().numpy()
    np.testing.assert_allclose(
        runs[0].cpu().numpy(), want, rtol=1e-4,
        atol=1e-4 * float(np.abs(want).max()), err_msg="dq")
    assert torch.equal(*runs)


# each backward kernel's wrapper, its design and its outputs' indices in
# attention_backward_reference's (dq, dk, dv)
BACKWARD_KERNELS = {"dq": ("cuda_attention_backward_dq", "dq_design", (0,)),
                    "dkv": ("cuda_attention_backward_dkv", "dkv_design",
                            (1, 2))}


def _backward_kernel(kernel):
    from tinynn_autograd_tpu_torch.ops import attention

    wrapper, design, outs = BACKWARD_KERNELS[kernel]

    def run(*args, **kw):
        got = getattr(attention, wrapper)(*args, **kw)
        return (got,) if kernel == "dq" else got

    return getattr(attention, wrapper), getattr(attention, design), run, outs


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(BACKWARD_KERNELS))
@pytest.mark.parametrize("d", [32, 40, 64, 65, 96, 128])
def test_cuda_wgmma_launches_counted_by_head_dim(kernel, d):
    # one launch a call; `wgmma_launches` grows with it at d in 65-128 only
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    fn, design, run, _ = _backward_kernel(kernel)
    gen = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn((1, 2, 96, d), generator=gen).to(dev)
                   for _ in range(4))
    o, lse = attention.attention_forward_reference(q, k, v, True, 0.125)
    before = (fn.launches, fn.wgmma_launches)
    got = run(q, k, v, do, lse, (do * o).sum(dim=-1), True, 0.125)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (
        before[0] + 1, before[1] + (1 if d > 64 else 0))
    assert design(d) == ("wgmma" if d > 64 else "mma")
    assert all(torch.isfinite(x).all() for x in got)


# the split head dims of multi-head latent attention (the forward's and
# dq's <192, 128> templates, dk/dv's split wgmma kernel): (B, H, Hkv, Tq,
# Tk, (d_qk, d_v), causal, window, dropout): Moonlight's 192/128 causal over
# a ragged T, GQA with a window of 40 and dropout, cross attention with Tq
# above and below Tk, and dims inside 192/128 (160/96, 136/64:
# zero-padded); q, k, v and dO as the strided
# views of split heads. The tolerances are ATTN_TOL's and the gradients'
# above: the sums run over at most 192 dims and 300 keys.
SPLIT_SHAPES = {
    "causal_t1100": (2, 4, 4, 1100, 1100, (192, 128), True, None, 0.0),
    "gqa2_window40_dropout": (1, 4, 2, 300, 300, (192, 128), True, 40, 0.1),
    "cross_200_300": (1, 2, 2, 200, 300, (192, 128), False, None, 0.0),
    "cross_300_130": (2, 2, 1, 300, 130, (160, 96), False, None, 0.0),
    "d136_64_causal": (1, 3, 3, 257, 257, (136, 64), True, None, 0.0),
}


def _split_inputs(dev, name, shapes=SPLIT_SHAPES):
    b, h, hkv, tq, tk, (d, dv), causal, window, rate = shapes[name]
    rng = np.random.RandomState(tq)

    def heads(n, t, width):
        x = rng.randn(b, t, n, width).astype(np.float32)
        return torch.from_numpy(x).to(dev).permute(0, 2, 1, 3)

    kw = dict(causal=causal, scale=1.0 / np.sqrt(d), window=window,
              dropout_rate=rate, seed=1234 if rate else None)
    return (heads(h, tq, d), heads(hkv, tk, d), heads(hkv, tk, dv),
            heads(h, tq, dv), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPLIT_SHAPES))
def test_cuda_attention_at_split_head_dims(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    q, k, v, do, kw = _split_inputs(dev, name)
    fns = (attention.cuda_attention_forward,
           attention.cuda_attention_backward_dq,
           attention.cuda_attention_backward_dkv)
    before = [(fn.launches, fn.split_launches) for fn in fns]
    wgmma = [fn.wgmma_launches for fn in fns[1:]]
    o, lse = attention.cuda_attention_forward(q, k, v, **kw)
    want_o, want_lse = attention.attention_forward_reference(q, k, v, **kw)
    assert o.shape == q.shape[:3] + (v.shape[-1],)
    for what, a, b in (("o", o, want_o), ("lse", lse, want_lse)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   err_msg=what, **ATTN_TOL)
    bwd = (q, k, v, do, want_lse, (do * want_o).sum(dim=-1))
    runs = [(attention.cuda_attention_backward_dq(*bwd, **kw),)
            + attention.cuda_attention_backward_dkv(*bwd, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    want = attention.attention_backward_reference(*bwd, **kw)
    for what, a, b in zip(("dq", "dk", "dv"), runs[0], want):
        assert a.shape == b.shape, what
        b = b.cpu().numpy()
        np.testing.assert_allclose(
            a.cpu().numpy(), b, rtol=1e-4,
            atol=1e-4 * float(np.abs(b).max()), err_msg=what)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(o, attention.cuda_attention_forward(q, k, v, **kw)[0])
    assert [(fn.launches - n, fn.split_launches - s) for fn, (n, s)
            in zip(fns, before)] == [(2, 2), (2, 2), (2, 2)]
    # dq on its template, dk/dv on the split wgmma kernel
    assert [fn.wgmma_launches for fn in fns[1:]] == [wgmma[0], wgmma[1] + 2]


# the dk/dv kernel at the split dims (wgmma, `dkv_design(d_qk, d_v)`):
# Moonlight's 16 heads of 192/128 over a short ragged T, d_qk 129, 160 and
# 192 (zero-padded; 129 ends rows mid-float4) against d_v 1, 64, 96 and 128
# under GQA 2 over a ragged T, GQA 4 with a window of 40 and dropout, cross
# attention with Tq above and below Tk (with dropout); q, k, v and dO as the
# strided views of split heads, read in place
SPLIT_DKV_SHAPES = dict(
    {"d%d_%d_gqa2" % (d, dv): (1, 4, 2, 200, 200, (d, dv), True, None, 0.0)
     for d in (129, 160, 192) for dv in (1, 64, 96, 128)},
    moonlight_t1100=(2, 16, 16, 1100, 1100, (192, 128), True, None, 0.0),
    gqa4_window40_dropout=(1, 8, 2, 300, 300, (192, 128), True, 40, 0.1),
    cross_100_260=(1, 2, 2, 100, 260, (192, 96), False, None, 0.0),
    cross_260_100_dropout=(1, 2, 1, 260, 100, (160, 128), False, None, 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPLIT_DKV_SHAPES))
def test_cuda_dkv_wgmma_at_split_head_dims_matches_reference(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    fn = attention.cuda_attention_backward_dkv
    q, k, v, do, kw = _split_inputs(dev, name, shapes=SPLIT_DKV_SHAPES)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    o, lse = attention.attention_forward_reference(q, k, v, **kw)
    bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
    counts = (fn.launches, fn.wgmma_launches, fn.split_launches)
    runs = [fn(*bwd, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches, fn.split_launches) == tuple(
        n + 2 for n in counts)
    _, *want = attention.attention_backward_reference(*bwd, **kw)
    for what, a, b in zip(("dk", "dv"), runs[0], want):
        assert a.shape == b.shape, what
        b = b.cpu().numpy()
        np.testing.assert_allclose(
            a.cpu().numpy(), b, rtol=1e-4,
            atol=1e-4 * float(np.abs(b).max()), err_msg=what)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(128, 64), (200, 128), (192, 160),
                                  (256, 256)])
def test_cuda_attention_refuses_other_head_dims(dims):
    # the kernels take one head dim up to 128, or the split dims; any other
    # pair raises naming the rule, and nothing is launched
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    d, dv = dims
    q, k = (torch.zeros(1, 2, 64, d, device=dev) for _ in range(2))
    v = torch.zeros(1, 2, 64, dv, device=dev)
    before = attention.cuda_attention_forward.launches
    with pytest.raises(ValueError, match="head dim"):
        attention.mha_fwd(q, k, v, causal=True)
    assert attention.cuda_attention_forward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [("dkv", "d128"), ("dq", "d128"),
                                          ("dkv", "split")],
                         ids=["dkv", "dq", "dkv-split"])
def test_cuda_wgmma_float64_hold(kernel, shape):
    # the wgmma kernels' 3xTF32 products: dq, dk and dv within
    # ATTN_F64_FACTOR times the f32 plain version's float64 error at T
    # 2,048, GQA 4, d 128 or (dk/dv) the split dims 192/128, which the
    # plain version with TF32 allowed must miss
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    fn, design, run, outs = _backward_kernel(kernel)
    if shape == "split":
        shapes = {"split": (1, 8, 2, 2048, 2048, (192, 128), True, None,
                            0.0)}
        q, k, v, do, kw = _split_inputs(dev, "split", shapes=shapes)
    else:
        shapes = {"d128": (1, 8, 2, 2048, 2048, 128, True, None, 0.0)}
        q, k, v, do, kw = _attn_inputs(dev, "d128", shapes=shapes)
    assert design(q.shape[-1], v.shape[-1]) == "wgmma"
    o, lse = attention.attention_forward_reference(q, k, v, **kw)
    bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
    got = run(*bwd, **kw)

    def plain(args):
        full = attention.attention_backward_reference(*args, **kw)
        return [full[i] for i in outs]

    f32 = plain(bwd)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain(bwd)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    exact = plain([x.double() for x in bwd])
    for i, what in enumerate(["dq", "dk", "dv"][j] for j in outs):
        errs = [float((x[i].double() - exact[i]).abs().max())
                for x in (got, f32, tf32)]
        assert errs[0] <= ATTN_F64_FACTOR * errs[1], (what, errs)
        assert errs[2] > ATTN_F64_FACTOR * errs[1], (what, errs)


# the attention kernels' products run in 3xTF32 on the tensor cores: at the
# long-context shapes each of dq, dk and dv (and the forward's o and lse,
# below) is held against a float64 plain version within ATTN_F64_FACTOR
# times the f32 plain version's own max error (TF32 off), as K1's long-K
# products are; the plain version with TF32 allowed must miss that limit
ATTN_F64_FACTOR = 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config6b", "k4c_noncausal"])
def test_cuda_attention_backward_float64_hold(name):
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    (q, k, v, do, kw), _, (o, lse) = _attn_forward_both(dev, name)
    bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
    got = ((attention.cuda_attention_backward_dq(*bwd, **kw),)
           + attention.cuda_attention_backward_dkv(*bwd, **kw))
    f32 = attention.attention_backward_reference(*bwd, **kw)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = attention.attention_backward_reference(*bwd, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    exact = attention.attention_backward_reference(
        *(x.double() for x in bwd), **kw)
    for i, what in enumerate(("dq", "dk", "dv")):
        errs = [float((x[i].double() - exact[i]).abs().max())
                for x in (got, f32, tf32)]
        assert errs[0] <= ATTN_F64_FACTOR * errs[1], (what, errs)
        assert errs[2] > ATTN_F64_FACTOR * errs[1], (what, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config6b", "k4c_noncausal"])
def test_cuda_attention_forward_float64_hold(name):
    # the forward multiplies in 3xTF32 too: o and lse each within
    # ATTN_F64_FACTOR times the f32 plain version's float64 error, which the
    # plain version with TF32 allowed must miss
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    (q, k, v, _, kw), got, f32 = _attn_forward_both(dev, name)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = attention.attention_forward_reference(q, k, v, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    exact = attention.attention_forward_reference(q.double(), k.double(),
                                                  v.double(), **kw)
    for i, what in enumerate(("o", "lse")):
        errs = [float((x[i].double() - exact[i]).abs().max())
                for x in (got, f32, tf32)]
        assert errs[0] <= ATTN_F64_FACTOR * errs[1], (what, errs)
        assert errs[2] > ATTN_F64_FACTOR * errs[1], (what, errs)


@pytest.mark.cuda
def test_cuda_attention_dropout_mask_is_the_hash():
    # with dropout 0.5, one keep decision that differs from the plain hash
    # moves o by ~p v / (1 - rate), far past the tolerance; and a different
    # seed must change o
    from tinynn_autograd_tpu_torch.ops import attention

    dev = _cuda()
    q, k, v, _, kw = _attn_inputs(dev, "d128_gqa_dropout")
    kw["dropout_rate"] = 0.5
    got, _ = attention.cuda_attention_forward(q, k, v, **kw)
    want, _ = attention.attention_forward_reference(q, k, v, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)
    other, _ = attention.cuda_attention_forward(q, k, v, **dict(kw, seed=7))
    assert not torch.allclose(got, other)


@pytest.mark.cuda
def test_cuda_transformer_step_launches_the_attention_kernels():
    from tinynn_autograd_tpu_torch.models import build_tiny_transformer
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import attention, fused_epoch
    from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

    dev = _cuda()
    model = Model(build_tiny_transformer(vocab=256, seq_len=2048, dim=512,
                                         heads=8, depth=2, num_out=16,
                                         causal=True),
                  SoftmaxCrossEntropyLoss(), Adam(1e-3), device=dev)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2 * 4, 2048))
    y = np.eye(16, dtype=np.float32)[rng.randint(0, 16, 2 * 4)]
    fns = (attention.cuda_attention_forward,
           attention.cuda_attention_backward_dq,
           attention.cuda_attention_backward_dkv, kernels.cuda_matmul,
           fused_epoch.cuda_fused_epoch, se.cuda_stream_forward,
           se.cuda_stream_backward)
    before = [f.launches for f in fns]
    tc = kernels.cuda_matmul.tc_launches
    losses = model.train_epoch(x, y, batch_size=4)
    torch.cuda.synchronize()
    # per step: two blocks, so two of each attention kernel; on K1 each
    # block's six Dense products forward, dW and dx (36, on the tensor-core
    # tile) and the head Dense's three
    assert [f.launches - n for f, n in zip(fns, before)] == [4, 4, 4, 78, 0,
                                                             0, 0]
    assert kernels.cuda_matmul.tc_launches - tc == 72
    assert losses.shape == (2,) and torch.isfinite(losses).all()


# the recurrent kernels: (B, T, H) at config 8's widths (K5/K5b's main
# path, and the GRU's at the same widths), the example's (B=128, H=64), a
# ragged B and H, an H that splits unevenly over a cluster of 2, and each
# cell's widest H
RNN_SHAPES = {"config8": (64, 128, 256), "example": (128, 32, 64),
              "ragged": (3, 7, 100), "uneven_units": (5, 9, 129),
              "widest": (2, 5, None)}
# the forward's outputs at rtol 1e-4/atol 1e-5 (128 steps of sums in another
# order); the backward's each at rtol 1e-4 and an atol of 1e-4 of its own
# largest plain value
RNN_TOL = dict(rtol=1e-4, atol=1e-5)


def _rnn_inputs(dev, cell, name, states, seed=0):
    """The forward's inputs (projected inputs, wh, initial states) and an
    output cotangent, from numpy; wh scaled by 1/sqrt(H), so the gates stay
    out of saturation."""
    from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk

    b, t, h = RNN_SHAPES[name]
    h = h or rk.max_hidden(cell)
    g = rk.GATES[cell]
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dev)

    xp = arr(t, b, g * h, scale=0.5)
    wh = arr(h, g * h, scale=1.0 / np.sqrt(h))
    zeros = torch.zeros((b, h), device=dev)
    h0 = arr(b, h, scale=0.5) if states else zeros
    c0 = arr(b, h, scale=0.5) if states else zeros
    return xp, wh, h0, c0, arr(t, b, h)


def _rnn_forward(cell, fn_kind, xp, wh, h0, c0, reverse):
    from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk

    if cell == "lstm":
        fn = (rk.cuda_lstm_forward if fn_kind == "kernel"
              else rk.lstm_forward_reference)
        return fn(xp, wh, h0, c0, reverse=reverse)
    fn = (rk.cuda_gru_forward if fn_kind == "kernel"
          else rk.gru_forward_reference)
    return fn(xp, wh, h0, reverse=reverse)


def _rnn_backward(cell, fn_kind, fwd, h0, c0, gt, wh, reverse):
    from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk

    def shifted(seq, first):
        if reverse:
            return torch.cat([seq[1:], first[None]])
        return torch.cat([first[None], seq[:-1]])

    if cell == "lstm":
        hs, cs, gates = fwd
        fn = (rk.cuda_lstm_backward if fn_kind == "kernel"
              else rk.lstm_backward_reference)
        return fn(gt, gates, cs, shifted(cs, c0), wh.T, reverse=reverse)
    hs, gates, un = fwd
    fn = (rk.cuda_gru_backward if fn_kind == "kernel"
          else rk.gru_backward_reference)
    return fn(gt, shifted(hs, h0), gates, un, wh.T, reverse=reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", sorted(RNN_SHAPES))
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_recurrent_kernels_match_reference(cell, name, reverse, states):
    from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    xp, wh, h0, c0, gt = _rnn_inputs(dev, cell, name, states)
    fwd_fn = getattr(rk, "cuda_%s_forward" % cell)
    bwd_fn = getattr(rk, "cuda_%s_backward" % cell)
    before = (fwd_fn.launches, bwd_fn.launches)
    runs = [_rnn_forward(cell, "kernel", xp, wh, h0, c0, reverse)
            for _ in range(2)]
    torch.cuda.synchronize()
    want = _rnn_forward(cell, "plain", xp, wh, h0, c0, reverse)
    for i, (a, b) in enumerate(zip(runs[0], want)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   err_msg="forward output %d" % i,
                                   **RNN_TOL)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    # both backwards from the plain forward's outputs
    runs = [_rnn_backward(cell, "kernel", want, h0, c0, gt, wh, reverse)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (fwd_fn.launches, bwd_fn.launches) == (before[0] + 2,
                                                  before[1] + 2)
    plain = _rnn_backward(cell, "plain", want, h0, c0, gt, wh, reverse)
    for i, (a, b) in enumerate(zip(runs[0], plain)):
        b = b.cpu().numpy()
        np.testing.assert_allclose(
            a.cpu().numpy(), b, rtol=1e-4,
            atol=1e-4 * float(np.abs(b).max()),
            err_msg="backward output %d" % i)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_cuda_recurrent_kernels_refuse_an_h_beyond_the_rule():
    from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk

    dev = _cuda()
    h = rk.max_hidden("lstm") + 1
    xp = torch.zeros((2, 2, 4 * h), device=dev)
    states = torch.zeros((2, h), device=dev)
    with pytest.raises(ValueError, match="H <= %d" % (h - 1)):
        rk.cuda_lstm_forward(xp, torch.zeros((h, 4 * h), device=dev),
                             states, states)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_rnn_step_launches_the_recurrent_kernels(cell):
    from tinynn_autograd_tpu_torch.models import build_rnn_classifier
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk
    from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

    dev = _cuda()
    model = Model(build_rnn_classifier(num_in=64, num_out=16,
                                       hidden=(256, 256), cell=cell, seed=77),
                  SoftmaxCrossEntropyLoss(), Adam(1e-3), device=dev)
    rng = np.random.RandomState(0)
    x = rng.randn(2 * 64, 128, 64).astype(np.float32)
    y = np.eye(16, dtype=np.float32)[rng.randint(0, 16, 2 * 64)]
    fns = (getattr(rk, "cuda_%s_forward" % cell),
           getattr(rk, "cuda_%s_backward" % cell), kernels.cuda_matmul,
           fused_epoch.cuda_fused_epoch, se.cuda_stream_forward,
           se.cuda_stream_backward)
    before = [f.launches for f in fns]
    losses = model.train_epoch(x, y, batch_size=64)
    torch.cuda.synchronize()
    # per step: each of the two layers' forward and backward kernels; on K1
    # the two input projections, dWx and dWh of both layers, dx of the
    # second (the first layer's input needs no gradient), and the head
    # Dense's forward, dW and dx
    assert [f.launches - n for f, n in zip(fns, before)] == [4, 4, 20, 0, 0,
                                                             0]
    assert losses.shape == (2,) and torch.isfinite(losses).all()


# --------------------------------------------------------------------------
# P1 (the dropout pass), K2 with Dropout and the seven rules, P2 (the
# optimizer-only probe)
# --------------------------------------------------------------------------

# (shape, seed): tpu_check's tile for seeds 1 and 2, the flagship's first
# Dropout, a 6b residual site with a seed past the int32 wrap, a ragged one
DROPOUT_SHAPES = {"tile_seed1": ((256, 256), 1), "tile_seed2": ((256, 256), 2),
                  "flagship": ((128, 200), 7),
                  "config6b": ((4, 2048, 512), 3000 * 1000003 + 1),
                  "ragged": ((3, 7, 5), -7)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DROPOUT_SHAPES))
def test_cuda_dropout_matches_reference_bit_for_bit(name):
    from tinynn_autograd_tpu_torch.ops import dropout

    dev = _cuda()
    shape, seed = DROPOUT_SHAPES[name]
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(
        np.float32)).to(dev)
    before = dropout.cuda_dropout.launches
    out, mask = dropout.cuda_dropout(x, 0.3, seed)
    torch.cuda.synchronize()
    assert dropout.cuda_dropout.launches == before + 1
    ref, ref_mask = dropout.dropout_reference(x, 0.3, seed)
    assert mask.dtype == torch.uint8
    assert torch.equal(mask.bool(), ref_mask)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cuda_dropout_meets_the_tpu_check_statistics():
    from tinynn_autograd_tpu_torch.ops import dropout

    dev = _cuda()
    masks = {}
    for seed in (1, 2):
        out = dropout.cuda_dropout(torch.ones(256, 256, device=dev), 0.5,
                                   seed)[0].cpu().numpy()
        assert abs(float((out == 0.0).mean()) - 0.5) < 0.02
        assert np.all(out[out != 0.0] == 2.0)
        masks[seed] = out != 0.0
    assert float((masks[1] != masks[2]).mean()) > 0.3


def _dropout_flagship(rate=0.3):
    """The flagship widths with Dropout(rate) after the two first ReLUs."""
    from tinynn_autograd_tpu_torch.nn.layers import Dense, Dropout, ReLU
    from tinynn_autograd_tpu_torch.nn.net import Net

    widths = [784, 200, 100, 70, 30, 10]
    layer_list = []
    for i, (d_in, d_out) in enumerate(zip(widths, widths[1:])):
        layer_list.append(Dense(d_out, num_in=d_in))
        if i < 4:
            layer_list.append(ReLU())
        if i < 2:
            layer_list.append(Dropout(rate))
    return Net(layer_list)


# the sweep's rules (examples/mnist/optimizer_sweep.py's lrs at 1e-3), a
# schedule, clip_norm, and SGD and Adam from step 3000, where the Dropout
# seeds pass the int32 wrap
RULE_CASES = {
    "sgd": lambda o, s: o.SGD(lr=0.03),
    "momentum": lambda o, s: o.Momentum(lr=0.01, momentum=0.9),
    "adam": lambda o, s: o.Adam(lr=1e-3),
    "rmsprop": lambda o, s: o.RMSProp(lr=1e-3),
    "adagrad": lambda o, s: o.Adagrad(lr=3e-3),
    "adadelta": lambda o, s: o.Adadelta(lr=1.0),
    "lion": lambda o, s: o.Lion(lr=1e-4, weight_decay=1e-2),
    "adam_schedule": lambda o, s: o.Adam(lr=s.WarmupCosineLR(
        1e-3, warmup_steps=3, decay_steps=10)),
    "adam_clip_norm": lambda o, s: o.Adam(lr=1e-3, clip_norm=0.5),
    "sgd_t0_3000": lambda o, s: o.SGD(lr=0.03),
    "adam_t0_3000": lambda o, s: o.Adam(lr=1e-3)}
# Lion's step is lr sign(u) whatever |u| is, and Adam's from zero slots at
# t = 3000 ~3 lr sign(g) until sqrt(v) nears eps: where u (or sqrt(v)) is
# within rounding of 0, the kernel's and cuBLAS's summation orders give steps
# 2 lr apart. Their state is held but at the elements whose plain-version u
# (or sqrt(v) s1) came, at some step, under this share of its leaf's largest
# (chip_smoke.py's SIGN_MARGIN and sign_margins).
SIGN_MARGIN = 2.0 ** -16
SIGN_MARKED = ("lion", "adam_t0_3000")


def _sign_marked(monkeypatch, spec, run):
    """``run()`` (a run of the plain version) and, for each Dense's w and b
    in order, the elements whose step its rule decided by a sign within
    rounding (see SIGN_MARGIN)."""
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    rule, name = fused_epoch.apply_rule, fused_epoch.OPTIMIZERS[spec.optimizer]
    c0, c1 = spec.consts[:2]
    marked = []

    def apply(spec_, p, g, slots, s0, s1):
        size = (torch.abs(c0 * slots[0] + c1 * g) if name == "Lion" else
                torch.sqrt(slots[1] + c1 * (g * g - slots[1])) * s1)
        marked.append((size > 0) & (size < SIGN_MARGIN * size.max()))
        rule(spec_, p, g, slots, s0, s1)

    with monkeypatch.context() as m:
        m.setattr(fused_epoch, "apply_rule", apply)
        out = run()
    n = 2 * len(spec.layers)
    return out, [torch.stack(marked[j::n]).any(0).cpu().numpy()
                 for j in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_cuda_fused_epoch_dropout_and_rules_match_reference(case,
                                                            monkeypatch):
    from tinynn_autograd_tpu_torch.nn import optimizer, scheduler
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.utils import datasets, seeder

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    with seeder.scope(1):
        net = _dropout_flagship()
    net.to(dev)
    opt = RULE_CASES[case](optimizer, scheduler)
    t0 = 3000 if case.endswith("t0_3000") else 0
    n_steps = 10
    # Lion runs on data seed 4 (chip_smoke.py's LION_DATA_SEED: no ReLU
    # input within rounding of 0 over the 10 steps)
    (x, y), _ = datasets.synthetic_mnist(n_steps * 128, 10,
                                         seed=4 if case == "lion" else 5)
    xb = torch.from_numpy(x).to(dev).reshape(n_steps, 128, 784)
    yb = torch.from_numpy(datasets.one_hot(y)).to(dev).reshape(n_steps, 128,
                                                               10)
    spec = fused_epoch.epoch_spec(net, opt)
    scalars = torch.from_numpy(opt.step_scalars(t0, n_steps)).to(dev)

    def fresh():
        params = [{k: v.clone() for k, v in d.items()}
                  for d in net.params_tree()]
        return params, opt.init_state(params)["slots"]

    def run(fn, state=None, step=None):
        """fn over the 10 steps from fresh state, or over one step from
        ``state`` (updated in place)"""
        params, slots = fresh() if state is None else state
        pairs = (fused_epoch.dense_leaves(net, params),
                 {k: fused_epoch.dense_leaves(net, v)
                  for k, v in slots.items()})
        span = slice(None) if step is None else slice(step, step + 1)
        losses = fn(spec, *pairs, xb[span], yb[span], scalars[span],
                    t0=t0 + (step or 0))
        torch.cuda.synchronize()
        leaves = [t for pair in pairs[0] for t in pair] + [
            t for k in sorted(pairs[1]) for pair in pairs[1][k] for t in pair]
        return losses.cpu().numpy(), [t.cpu().numpy() for t in leaves]

    def copy(state):
        params, slots = state
        return ([{k: v.clone() for k, v in d.items()} for d in params],
                {n: [{k: v.clone() for k, v in d.items()} for d in tree]
                 for n, tree in slots.items()})

    before = fused_epoch.cuda_fused_epoch.launches
    got, got_state = run(fused_epoch.cuda_fused_epoch)
    assert fused_epoch.cuda_fused_epoch.launches == before + 1
    if case == "lion":
        # a weight moved 2 lr changes every later gradient and the losses
        # part after a few steps: each step is held on its own, from the
        # plain version's state after the step before
        plain = fresh()
        spans = []
        for step in range(n_steps):
            kernel_out = run(fused_epoch.cuda_fused_epoch, copy(plain), step)
            plain_out, masks = _sign_marked(monkeypatch, spec, lambda: run(
                fused_epoch.fused_epoch_reference, plain, step))
            spans.append((kernel_out, plain_out, masks))
    elif case in SIGN_MARKED:
        plain_out, masks = _sign_marked(
            monkeypatch, spec, lambda: run(fused_epoch.fused_epoch_reference))
        spans = [((got, got_state), plain_out, masks)]
    else:
        spans = [((got, got_state), run(fused_epoch.fused_epoch_reference),
                  [np.zeros(a.shape, bool) for a in got_state])]
    n_params = sum(a.size for a in got_state[:2 * len(spec.layers)])
    n_left = 0
    for step, ((k_loss, k_state), (p_loss, p_state), masks) in enumerate(
            spans):
        np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5, atol=1e-6)
        if len(masks) < len(k_state):  # a mask for each Dense's w and b
            n_left += sum(int(m.sum()) for m in masks)
            masks = masks * (1 + len(opt.slot_names))
        for i, (a, b, mask) in enumerate(zip(k_state, p_state, masks)):
            np.testing.assert_allclose(a[~mask], b[~mask], rtol=1e-4,
                                       atol=1e-5, err_msg="state leaf %d, "
                                       "span %d" % (i, step))
    # the left-out elements are few: under 1% of the parameters a span
    assert n_left < 0.01 * len(spans) * n_params
    again, again_state = run(fused_epoch.cuda_fused_epoch)
    assert np.array_equal(got, again)
    assert all(np.array_equal(a, b) for a, b in zip(got_state, again_state))


@pytest.mark.cuda
def test_cuda_dropout_mlp_launches_per_path():
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import dropout, fused_epoch

    dev = _cuda()
    rng = np.random.RandomState(0)
    x = rng.rand(4 * 128, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4 * 128)]
    fns = (kernels.cuda_matmul, dropout.cuda_dropout,
           fused_epoch.cuda_fused_epoch)
    for fused, per_epoch in (("auto", [0, 0, 1]), (False, [4 * 14, 4 * 2, 0])):
        model = Model(_dropout_flagship(), SoftmaxCrossEntropyLoss(),
                      Adam(1e-3), device=dev)
        before = [f.launches for f in fns]
        losses = model.train_epoch(x, y, batch_size=128, fused=fused)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(fns, before)] == per_epoch
        assert losses.shape == (4,) and torch.isfinite(losses).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SGD", "Momentum", "RMSProp", "Adam",
                                  "Adagrad", "Adadelta", "Lion"])
def test_cuda_mega_probe_matches_reference(name):
    from tinynn_autograd_tpu_torch.nn import optimizer
    from tinynn_autograd_tpu_torch.ops import mega_probe

    dev = _cuda()
    opt = getattr(optimizer, name)(lr=1e-3)
    rng = np.random.RandomState(0)
    start = [rng.randn(*s).astype(np.float32) * 0.05
             for s in mega_probe.LEAF_SHAPES]

    def state():
        params = [torch.from_numpy(p).to(dev) for p in start]
        return params, {n: [torch.zeros_like(p) for p in params]
                        for n in opt.slot_names}

    (kp, ks), (rp, rs) = state(), state()
    before = mega_probe.cuda_mega_probe.launches
    mega_probe.cuda_mega_probe(opt, kp, ks, 1, 100)
    torch.cuda.synchronize()
    assert mega_probe.cuda_mega_probe.launches == before + 1
    mega_probe.mega_probe_reference(opt, rp, rs, 1, 100)
    pairs = list(zip(kp, rp)) + [pair for n in opt.slot_names
                                 for pair in zip(ks[n], rs[n])]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg="leaf %d" % i)


# K7 at bench_block_probe_torch.py's shapes: (B, T, D, heads, causal)
BLOCK_SHAPES = {"config6": (32, 128, 256, 8, False),
                "config6_causal": (32, 128, 256, 8, True),
                "t512_causal": (8, 512, 256, 8, True),
                "config6b": (4, 2048, 512, 8, True)}


def _block_inputs(b, t, d, heads, causal, dev):
    from tinynn_autograd_tpu_torch.nn.layers import TransformerBlock
    from tinynn_autograd_tpu_torch.ops import block_kernel

    blk = TransformerBlock(dim=d, num_heads=heads, causal=causal, seed=3)
    params = {k: v.to(dev) for k, v in block_kernel.block_params(blk).items()}
    x = np.random.RandomState(0).randn(b, t, d).astype(np.float32) * 0.5
    return params, torch.from_numpy(x).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BLOCK_SHAPES))
def test_cuda_block_fwd_matches_reference(name):
    """rtol 1e-4 and an atol of 1e-4 of the plain output's largest value:
    f32 sums of depth up to 4D = 2048 in another order."""
    from tinynn_autograd_tpu_torch.ops import block_kernel

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, t, d, heads, causal = BLOCK_SHAPES[name]
    params, x = _block_inputs(b, t, d, heads, causal, dev)
    before = block_kernel.cuda_block_fwd.launches
    got = block_kernel.cuda_block_fwd(x, params, heads, causal=causal)
    again = block_kernel.block_fwd(x, params, heads, causal=causal)
    torch.cuda.synchronize()
    assert block_kernel.cuda_block_fwd.launches == before + 2
    assert torch.equal(got, again)
    want = block_kernel.block_fwd_reference(x, params, heads, causal=causal)
    np.testing.assert_allclose(
        got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
        atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case, match", [
    ("f64", "takes float32"), ("non_contiguous", "contiguous"),
    ("heads", "not a multiple of heads"), ("head_dim", "exceeds"),
    ("param_device", "is on cpu")])
def test_cuda_block_fwd_refuses(case, match):
    from tinynn_autograd_tpu_torch.ops import block_kernel

    dev = _cuda()
    d, heads = (264, 2) if case == "head_dim" else (32, 4)
    params, x = _block_inputs(2, 8, d, heads, False, dev)
    if case == "f64":
        x = x.double()
    elif case == "non_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "heads":
        heads = 3
    elif case == "param_device":
        params["wo"] = params["wo"].cpu()
    before = block_kernel.cuda_block_fwd.launches
    with pytest.raises(ValueError, match=match):
        block_kernel.cuda_block_fwd(x, params, heads)
    assert block_kernel.cuda_block_fwd.launches == before


@pytest.mark.cuda
def test_cuda_block_fwd_phase_clock():
    """Block 0's clock adds a positive time to each of the seven phases and
    changes nothing in the output."""
    from tinynn_autograd_tpu_torch.ops import block_kernel

    dev = _cuda()
    b, t, d, heads, causal = BLOCK_SHAPES["config6_causal"]
    params, x = _block_inputs(b, t, d, heads, causal, dev)
    phase_ns = torch.zeros(len(block_kernel.PHASES), dtype=torch.int64,
                           device=dev)
    timed = block_kernel.cuda_block_fwd(x, params, heads, causal=causal,
                                        phase_ns=phase_ns)
    plain = block_kernel.cuda_block_fwd(x, params, heads, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(timed, plain)
    assert (phase_ns.cpu() > 0).all()


# the ring (P3): tests/test_dp_megakernel.py's 8 ranks of [8, 128], the
# flagship's 4 ranks of its 186,610 gradient floats, 3 ranks of a ragged
# length (1/3 is not exact in f32) and one rank
RING_SHAPES = {"jax_test": (8, (8, 128)), "flagship_grads": (4, (186610,)),
               "ragged": (3, (1001,)), "one_rank": (1, (64,))}


def _ring_inputs(name, dev):
    n, shape = RING_SHAPES[name]
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=gen).to(dev) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RING_SHAPES))
def test_cuda_ring_all_reduce_matches_reference_bit_for_bit(name):
    from tinynn_autograd_tpu_torch.ops import ring_allreduce

    dev = _cuda()
    xs = _ring_inputs(name, dev)
    before = ring_allreduce.cuda_ring_all_reduce.launches
    got = ring_allreduce.cuda_ring_all_reduce(xs)
    torch.cuda.synchronize()
    assert ring_allreduce.cuda_ring_all_reduce.launches == before + 1
    want = ring_allreduce.ring_all_reduce_reference(xs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    np.testing.assert_allclose(got[0].cpu().numpy(),
                               torch.stack(xs).sum(0).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("skew_rank", [0, 2])
def test_cuda_ring_all_reduce_skew_rerun_is_bit_identical(skew_rank):
    from tinynn_autograd_tpu_torch.ops import ring_allreduce

    dev = _cuda()
    xs = _ring_inputs("flagship_grads", dev)
    plain = ring_allreduce.cuda_ring_all_reduce(xs)
    held = ring_allreduce.cuda_ring_all_reduce(xs, skew=(skew_rank, 500.0))
    torch.cuda.synchronize()
    for a, b in zip(plain, held):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
def test_cuda_ring_all_reduce_bit_for_bit_at_every_rank_count(n):
    # a ragged length (no whole float4s), one the float4 pass takes, and
    # each with the last rank held back
    from tinynn_autograd_tpu_torch.ops import ring_allreduce

    dev = _cuda()
    gen = torch.Generator().manual_seed(n)
    for length in (1001, 4096):
        xs = [torch.randn(length, generator=gen).to(dev) for _ in range(n)]
        want = ring_allreduce.ring_all_reduce_reference(xs)
        got = ring_allreduce.cuda_ring_all_reduce(xs)
        held = ring_allreduce.cuda_ring_all_reduce(xs, skew=(n - 1, 100.0))
        torch.cuda.synchronize()
        for g, h, w in zip(got, held, want):
            assert torch.equal(g, w) and torch.equal(h, w)


@pytest.mark.cuda
def test_cuda_ring_all_reduce_counts_carry_across_calls():
    # the arrival counts stay on the card from call to call: calls of other
    # lengths (so other blocks a rank) and rank counts, back to back
    from tinynn_autograd_tpu_torch.ops import ring_allreduce

    dev = _cuda()
    gen = torch.Generator().manual_seed(0)
    cases = [[torch.randn(length, generator=gen).to(dev) for _ in range(n)]
             for n, length in ((4, 186610), (2, 7), (16, 50000), (3, 1))]
    outs = [ring_allreduce.cuda_ring_all_reduce(xs)
            for _ in range(20) for xs in cases]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        want = ring_allreduce.ring_all_reduce_reference(cases[i % 4])
        assert all(torch.equal(o, w) for o, w in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case, error, match", [
    ("cpu_rank", ValueError, "CUDA tensors"),
    ("shapes", ValueError, "shape"),
    ("dtype", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
    ("too_many", ValueError, "1 to 16")])
def test_cuda_ring_all_reduce_refuses(case, error, match):
    from tinynn_autograd_tpu_torch.ops import ring_allreduce

    dev = _cuda()
    xs = _ring_inputs("ragged", dev)
    if case == "cpu_rank":
        xs[1] = xs[1].cpu()
    elif case == "shapes":
        xs[2] = xs[2][:-1].contiguous()
    elif case == "dtype":
        xs[0] = xs[0].double()
    elif case == "strided":
        xs[1] = torch.zeros(2002, device=dev)[::2]
    else:
        xs = xs * 6
    before = ring_allreduce.cuda_ring_all_reduce.launches
    with pytest.raises(error, match=match):
        ring_allreduce.cuda_ring_all_reduce(xs)
    assert ring_allreduce.cuda_ring_all_reduce.launches == before


def _rank_inputs(dev, net, opt, n_ranks, n_steps=10, data_seed=5):
    """``n_steps`` pinned global batches of 128 (their first rows where
    ``n_ranks`` does not divide 128) split into ``n_ranks`` shards, and a fresh copy of the net's weights and zero slots a rank."""
    from tinynn_autograd_tpu_torch.ops.fused_epoch import dense_leaves
    from tinynn_autograd_tpu_torch.utils import datasets

    (x, y), _ = datasets.synthetic_mnist(n_steps * 128, 10, seed=data_seed)
    local = 128 // n_ranks

    def split(a, width):
        a = torch.from_numpy(a).to(dev).reshape(n_steps, 128, width)
        a = a[:, :n_ranks * local].reshape(n_steps, n_ranks, local, width)
        return a.transpose(0, 1).contiguous()

    states = []
    for _ in range(n_ranks):
        params = [{k: v.clone() for k, v in d.items()}
                  for d in net.params_tree()]
        slots = opt.init_state(params)["slots"]
        states.append((dense_leaves(net, params),
                       {k: dense_leaves(net, v) for k, v in slots.items()}))
    scalars = torch.from_numpy(opt.step_scalars(0, n_steps)).to(dev)
    return (split(x, 784), split(datasets.one_hot(y), 10), scalars,
            [p for p, _ in states], [s for _, s in states])


def _flat(params, slots):
    return [t for ranks in (params, [s[k] for s in slots for k in sorted(s)])
            for pairs in ranks for pair in pairs for t in pair]


# K2 with the K6 ring: the flagship (pinned seed-1 weights, data seed 5)
# over 4 and 2 ranks, the Dropout flagship over 4 on data seed 15 (seed 5
# puts a ReLU input within rounding of 0 there), SGD over 3 ranks (1/3 is
# not exact in f32)
K6_CASES = {"flagship_4": (4, "adam", False, 5),
            "flagship_2": (2, "adam", False, 5),
            "dropout_4": (4, "adam", True, 15),
            "sgd_3": (3, "sgd", False, 5)}


def _k6_case(dev, name):
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.optimizer import SGD, Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.utils import seeder

    n_ranks, opt_name, drop, data_seed = K6_CASES[name]
    with seeder.scope(1):
        net = _dropout_flagship() if drop else build_mnist_mlp()
    net.to(dev)
    opt = Adam(1e-3) if opt_name == "adam" else SGD(0.05)
    data = _rank_inputs(dev, net, opt, n_ranks, data_seed=data_seed)
    return net, opt, fused_epoch.epoch_spec(net, opt), data


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_cuda_k6_matches_reference(name):
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    net, opt, spec, (xs, ys, scalars, kp, ks) = _k6_case(dev, name)
    _, _, _, (_, _, _, rp, rs) = _k6_case(dev, name)
    before = fused_epoch.cuda_fused_epoch_ranks.launches
    got = fused_epoch.cuda_fused_epoch_ranks(spec, kp, ks, xs, ys, scalars)
    torch.cuda.synchronize()
    assert fused_epoch.cuda_fused_epoch_ranks.launches == before + 1
    want = fused_epoch.fused_epoch_reference(spec, rp, rs, xs, ys, scalars)
    assert got.shape == want.shape == (xs.shape[0], 10)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    for i, (a, b) in enumerate(zip(_flat(kp, ks), _flat(rp, rs))):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg="leaf %d" % i)


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [None, (0, 100.0), (3, 100.0)])
def test_cuda_k6_reruns_are_bit_identical(skew):
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    runs = []
    for hold in (None, skew):
        net, opt, spec, (xs, ys, scalars, p, s) = _k6_case(dev, "dropout_4")
        losses = fused_epoch.cuda_fused_epoch_ranks(spec, p, s, xs, ys,
                                                    scalars, skew=hold)
        torch.cuda.synchronize()
        runs.append([losses] + _flat(p, s))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_one_rank_through_the_ranked_wrapper_is_k2():
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    net, opt, spec, xb, yb, scalars = _flagship_epoch(dev, 10)
    (kp, ks), (rp, rs) = _state(net, opt), _state(net, opt)
    single = fused_epoch.cuda_fused_epoch(spec, kp, ks, xb, yb, scalars)
    ranked = fused_epoch.cuda_fused_epoch_ranks(spec, [rp], [rs], xb[None],
                                                yb[None], scalars)
    torch.cuda.synchronize()
    assert torch.equal(single, ranked[0])
    for a, b in zip(_flat([kp], [ks]), _flat([rp], [rs])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_k6_phase_clock_has_the_ring():
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    net, opt, spec, (xs, ys, scalars, p, s) = _k6_case(dev, "flagship_4")
    names = fused_epoch.phase_names(spec, 4)
    assert "ring all-reduce" in names
    phase_ns = torch.zeros(len(names), dtype=torch.int64, device=dev)
    fused_epoch.cuda_fused_epoch_ranks(spec, p, s, xs, ys, scalars,
                                       phase_ns=phase_ns)
    torch.cuda.synchronize()
    assert (phase_ns.cpu() > 0).all()
    with pytest.raises(ValueError, match="phase_ns must be an int64 \\[13\\]"):
        fused_epoch.cuda_fused_epoch_ranks(
            spec, p, s, xs, ys, scalars,
            phase_ns=torch.zeros(12, dtype=torch.int64, device=dev))


@pytest.mark.cuda
def test_cuda_k6_refuses_cpu_tensors_and_a_bad_skew():
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    dev = _cuda()
    net, opt, spec, (xs, ys, scalars, p, s) = _k6_case(dev, "flagship_2")
    before = fused_epoch.cuda_fused_epoch_ranks.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_epoch.cuda_fused_epoch_ranks(spec, p, s, xs.cpu(), ys.cpu(),
                                           scalars.cpu())
    p[1][0] = (p[1][0][0].cpu(), p[1][0][1])
    with pytest.raises(ValueError, match="rank 1 w0 is on cpu"):
        fused_epoch.cuda_fused_epoch_ranks(spec, p, s, xs, ys, scalars)
    with pytest.raises(ValueError, match="skew rank 2 of 2"):
        fused_epoch.cuda_fused_epoch_ranks(spec, p, s, xs, ys, scalars,
                                           skew=(2, 10.0))
    with pytest.raises(ValueError, match="n_ranks, n_steps"):
        fused_epoch.cuda_fused_epoch_ranks(spec, p, s, xs[0], ys[0], scalars)
    assert fused_epoch.cuda_fused_epoch_ranks.launches == before


@pytest.mark.cuda
def test_cuda_dp_auto_epoch_is_one_ranked_launch():
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam
    from tinynn_autograd_tpu_torch.ops import fused_epoch
    from tinynn_autograd_tpu_torch.parallel import DataParallel, make_mesh

    dev = _cuda()
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=dev)
    dp = DataParallel(model, mesh=make_mesh(devices=[dev] * 4))
    rng = np.random.RandomState(0)
    x = rng.rand(4 * 128, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4 * 128)]
    counts = (kernels.cuda_matmul.launches,
              fused_epoch.cuda_fused_epoch.launches,
              fused_epoch.cuda_fused_epoch_ranks.launches)
    losses = dp.train_epochs(x, y, 2, batch_size=128, fused="auto")
    torch.cuda.synchronize()
    assert (kernels.cuda_matmul.launches,
            fused_epoch.cuda_fused_epoch.launches,
            fused_epoch.cuda_fused_epoch_ranks.launches) == (
        counts[0], counts[1], counts[2] + 2)
    assert losses.shape == (2, 4) and torch.isfinite(losses).all()
    assert model.optimizer.state_dict()["t"] == 8
    assert dp._replicas is not None and dp.replica_spread() < 1e-5
    # the step tier: 14 K1 launches a rank a step
    dp.train_step(x[:128], y[:128])
    assert kernels.cuda_matmul.launches == counts[0] + 56
    assert dp.replica_spread() == 0.0
