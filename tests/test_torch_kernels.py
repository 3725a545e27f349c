"""The matmul kernel's dispatch and plain version against the JAX package's
Pallas matmul (run in interpret mode), and the rules around the CUDA kernel
that hold without a GPU: it builds lazily, counts its launches, and raises
instead of falling back.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py compares
it with ``matmul_reference`` there."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinynn_autograd_tpu.ops.kernels import pallas_matmul
from tinynn_autograd_tpu_torch.ops import kernels

torch.set_num_threads(1)

# the shapes of the JAX package's Pallas matmul test
SHAPES = [
    (128, 128, 128),
    (256, 512, 256),
    (128, 784, 200),
    (100, 30, 10),
    (1, 784, 200),
    (130, 129, 131),
]

def _operands(m, k, n, ta, tb, seed=0, dtype=np.float32):
    """numpy operands and their torch counterparts; a transposed operand is
    a transposed VIEW of a contiguous tensor, as the tape's VJPs pass it."""
    rng = np.random.RandomState(seed)
    a = rng.randn(*((k, m) if ta else (m, k))).astype(dtype)
    b = rng.randn(*((n, k) if tb else (k, n))).astype(dtype)
    ta_t, tb_t = torch.from_numpy(a), torch.from_numpy(b)
    if ta:
        a, ta_t = a.T, ta_t.T
    if tb:
        b, tb_t = b.T, tb_t.T
    return a, b, ta_t, tb_t


@pytest.mark.parametrize("transpose", [(False, False), (True, False),
                                       (False, True), (True, True)],
                         ids=["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_cpu_matmul_matches_pallas_interpret(m, k, n, transpose):
    a, b, ta, tb = _operands(m, k, n, *transpose)
    expected = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = kernels.matmul(ta, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-4)


# a long-K product (config 8's post-scan products, K = 8,192, at a small
# width) and a narrow one: the shapes the plan splits on the card
@pytest.mark.parametrize("m,k,n", [(24, 2048, 40), (33, 517, 9)])
def test_cpu_long_k_matmul_matches_pallas_interpret(m, k, n):
    a, b, ta, tb = _operands(m, k, n, True, False, seed=3)
    expected = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = kernels.matmul(ta, tb)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-4)


# the products of the main paths, as (m, k, n): the flagship's train step
# (forward, weight gradients, input gradients) and eval product, config 8's
# ten a step (two LSTM layers of 256 over T = 128 at batch 64: the input
# projections, the head, dx, dWx and dWh), 6b's three (its head) and the
# ragged check shapes
FLAGSHIP = [(784, 200), (200, 100), (100, 70), (70, 30), (30, 10)]
STEP_PRODUCTS = ([(128, i, o) for i, o in FLAGSHIP]
                 + [(i, 128, o) for i, o in FLAGSHIP]
                 + [(128, o, i) for i, o in FLAGSHIP[1:]])
EVAL_PRODUCT = (10000, 784, 200)
CONFIG8_PRODUCTS = [(8192, 64, 1024), (8192, 256, 1024), (64, 256, 16),
                    (256, 64, 16), (64, 16, 256), (8192, 1024, 256),
                    (256, 8192, 1024), (256, 8192, 1024), (64, 8192, 1024),
                    (256, 8192, 1024)]
CONFIG6B_PRODUCTS = [(4, 512, 16), (512, 4, 16), (4, 16, 512)]
RAGGED_PRODUCTS = [(130, 129, 131), (1, 784, 200), (1, 1, 1), (3, 1001, 7),
                   (200, 16, 10000), (9999, 17, 3)]
ALL_PRODUCTS = (STEP_PRODUCTS + [EVAL_PRODUCT] + CONFIG8_PRODUCTS
                + CONFIG6B_PRODUCTS + RAGGED_PRODUCTS)


def test_plan_splits_config8_long_k_products_and_not_the_eval_product():
    for m, k, n in [(64, 8192, 1024), (256, 8192, 1024)]:  # dWx, dWh
        assert kernels.plan_matmul(m, n, k).split > 1
    m, k, n = EVAL_PRODUCT
    assert kernels.plan_matmul(m, n, k).split == 1
    # config 8's forward and dx products fill the card with 128-row tiles
    for m, k, n in [(8192, 256, 1024), (8192, 1024, 256)]:
        plan = kernels.plan_matmul(m, n, k)
        assert plan.split == 1 and plan.bm == 128


@pytest.mark.parametrize("m,k,n", ALL_PRODUCTS)
def test_plan_is_a_valid_launch(m, k, n):
    plan = kernels.plan_matmul(m, n, k)
    assert 0 <= plan.config < len(kernels.MATMUL_TILES)
    bm, bn, per_sm, _ = kernels.MATMUL_TILES[plan.config]
    assert (plan.bm, plan.bn) == (bm, bn)
    assert 1 <= plan.split <= kernels.MATMUL_MAX_SPLIT
    # every slice of K holds part of it, and the slices cover it once
    assert plan.k_chunk % kernels.MATMUL_BK == 0
    starts = [z * plan.k_chunk for z in range(plan.split)]
    ends = [min(k, s + plan.k_chunk) for s in starts]
    assert all(s < e for s, e in zip(starts, ends))
    assert starts[0] == 0 and ends[-1] == k
    assert all(e == s for e, s in zip(ends, starts[1:]))
    # a split only where the tiles leave room on the SMs
    tiles = -(-m // bm) * -(-n // bn)
    assert plan.split == 1 or tiles * (plan.split - 1) < (
        kernels.H100_SMS * per_sm)


# config 6b's 36 block products a step, as (m, k, n): each block's six
# forward products, their input gradients (through the weights' transposed
# views) and their weight gradients over all 8,192 tokens (K = 8,192)
CONFIG6B_BLOCK_PRODUCTS = [
    (8192, 512, 512), (8192, 512, 2048), (8192, 2048, 512),
    (8192, 512, 512), (8192, 2048, 512), (8192, 512, 2048),
    (512, 8192, 512), (512, 8192, 2048), (2048, 8192, 512)]


@pytest.mark.parametrize("m,k,n", CONFIG6B_BLOCK_PRODUCTS)
def test_plan_puts_6b_block_products_on_the_tensor_cores(m, k, n):
    plan = kernels.plan_matmul(m, n, k, aligned=True)
    assert plan.config == kernels.MATMUL_TC
    # unaligned operands keep the CUDA-core tiles
    assert kernels.plan_matmul(m, n, k).config != kernels.MATMUL_TC


@pytest.mark.parametrize("m,k,n", STEP_PRODUCTS + CONFIG6B_PRODUCTS)
def test_plan_keeps_latency_bound_products_on_the_cuda_cores(m, k, n):
    # the flagship's train-step products and 6b's head, even where their
    # operands would fit the tensor-core tile
    assert kernels.plan_matmul(m, n, k, aligned=True).config \
        != kernels.MATMUL_TC


@pytest.mark.parametrize("m,k,n", ALL_PRODUCTS + CONFIG6B_BLOCK_PRODUCTS)
def test_tensor_core_plan_is_a_valid_launch(m, k, n):
    plan = kernels.plan_matmul(m, n, k, aligned=True)
    bm, bn, per_sm, _ = kernels.MATMUL_TILES[plan.config]
    assert (plan.bm, plan.bn) == (bm, bn)
    assert 1 <= plan.split <= kernels.MATMUL_MAX_SPLIT
    stage = (kernels.MATMUL_TC_BK if plan.config == kernels.MATMUL_TC
             else kernels.MATMUL_BK)
    assert plan.k_chunk % stage == 0
    assert (plan.split - 1) * plan.k_chunk < k <= plan.split * plan.k_chunk
    tiles = -(-m // bm) * -(-n // bn)
    assert plan.split == 1 or tiles * (plan.split - 1) < (
        kernels.H100_SMS * per_sm)


def test_tc_aligned_reads_the_operands_layout():
    a = torch.randn(64, 32)
    b = torch.randn(32, 48)
    assert kernels.tc_aligned(a, b)
    # transposed views: the unit stride along the rows (A^T, W^T)
    assert kernels.tc_aligned(torch.randn(32, 64).T, torch.randn(48, 32).T)
    # rows off 16-byte alignment, a stride that is no multiple of 4, no
    # unit stride, other dtypes
    off = torch.randn(64 * 32 + 1)[1:].view(64, 32)
    assert not kernels.tc_aligned(off, b)
    assert not kernels.tc_aligned(a, torch.randn(32, 50)[:, :48])
    assert not kernels.tc_aligned(torch.randn(64, 64)[:, ::2], b)
    assert not kernels.tc_aligned(a.to(torch.bfloat16), b)
    assert not kernels.tc_aligned(a, b.double())


@pytest.mark.parametrize("rows", [
    64 * 65536,                        # a Dense on 64 x 65,536 tokens
    kernels.MATMUL_MAX_ROWS,           # one launch's most rows
    kernels.MATMUL_MAX_ROWS + 1,
    3 * kernels.MATMUL_MAX_ROWS + 100])
def test_folded_rows_past_the_grid_launch_in_runs(rows):
    # a folded product's rows past the grid's 65535 row tiles are launched
    # in runs that cover them in order, each a valid launch of any tile,
    # each starting on a multiple of 64 rows (as aligned as the whole)
    runs = kernels.matmul_row_runs(rows)
    assert runs[0][0] == 0 and runs[-1][1] == rows
    assert all(end == start for (_, end), (start, _) in zip(runs, runs[1:]))
    assert len(runs) == -(-rows // kernels.MATMUL_MAX_ROWS)
    for r0, r1 in runs:
        assert r0 % 64 == 0 and 0 < r1 - r0 <= kernels.MATMUL_MAX_ROWS
        for aligned in (False, True):
            plan = kernels.plan_matmul(r1 - r0, 512, 512, aligned=aligned)
            assert -(-(r1 - r0) // plan.bm) <= 65535
    assert kernels.MATMUL_MAX_ROWS == 65535 * min(
        t[0] for t in kernels.MATMUL_TILES)


def test_plan_refuses_empty_products():
    with pytest.raises(ValueError, match="positive"):
        kernels.plan_matmul(0, 4, 4)


def test_cpu_matmul_bf16_inputs_match_pallas_interpret():
    rng = np.random.RandomState(1)
    a = rng.randn(128, 256).astype(np.float32)
    b = rng.randn(256, 128).astype(np.float32)
    expected = np.asarray(pallas_matmul(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        interpret=True)).astype(np.float32)
    got = kernels.matmul(torch.from_numpy(a).to(torch.bfloat16),
                         torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16  # promote(a, b), as the kernel
    np.testing.assert_allclose(got.float().numpy(), expected,
                               rtol=2e-2, atol=2e-1)
    np.testing.assert_allclose(got.float().numpy(), a @ b,
                               rtol=2e-2, atol=2e-1)


def test_bf16_precision_mode_returns_f32():
    rng = np.random.RandomState(2)
    a = rng.randn(64, 96).astype(np.float32)
    b = rng.randn(96, 32).astype(np.float32)
    expected = np.asarray(pallas_matmul(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        interpret=True)).astype(np.float32)
    kernels.set_matmul_precision("bf16")
    try:
        assert kernels.matmul_precision() == "bf16"
        got = kernels.matmul(torch.from_numpy(a), torch.from_numpy(b))
    finally:
        kernels.set_matmul_precision("f32")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=2e-2, atol=2e-1)
    with pytest.raises(ValueError):
        kernels.set_matmul_precision("tf32")


def test_non_2d_products_stay_torch_matmul(monkeypatch):
    # an N-D operand times a 2-D weight is one 2-D product over its folded
    # rows (a view of them); two N-D operands stay torch.matmul
    seen, reference = [], kernels.matmul_reference

    def record(a, b):
        seen.append((tuple(a.shape), tuple(b.shape), a.data_ptr()))
        return reference(a, b)

    monkeypatch.setattr(kernels, "matmul_reference", record)
    a = torch.randn(2, 5, 7)
    b = torch.randn(7, 3)
    before = kernels.cuda_matmul.launches
    got = kernels.matmul(a, b)
    assert tuple(got.shape) == (2, 5, 3)
    np.testing.assert_allclose(got.numpy(), torch.matmul(a, b).numpy(),
                               rtol=1e-6)
    assert seen == [((10, 7), (7, 3), a.data_ptr())]
    batched = torch.randn(2, 7, 3)
    np.testing.assert_allclose(kernels.matmul(a, batched).numpy(),
                               torch.matmul(a, batched).numpy(), rtol=1e-6)
    assert len(seen) == 1
    assert kernels.cuda_matmul.launches == before


def test_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(kernels)
    assert mod._loaded == {}
    assert "ctypes" not in vars(mod)
    assert mod.cuda_matmul.launches == 0


def test_launch_counter_stays_zero_on_cpu():
    from tinynn_autograd_tpu_torch.models import build_mnist_mlp
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu_torch.nn.model import Model
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam

    before = kernels.cuda_matmul.launches
    model = Model(build_mnist_mlp(hidden=(16, 8)), SoftmaxCrossEntropyLoss(),
                  Adam(1e-3), device="cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(32, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)]
    model.train_step(x, y)
    model.predict(x)
    assert kernels.cuda_matmul.launches == before


def test_nvcc_command_targets_sm_90a():
    cmd = kernels.nvcc_command("nvcc", kernels.MATMUL_SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert "--use_fast_math" not in cmd
    assert cmd[-1].endswith("csrc/matmul.cu")


def test_cuda_entry_without_a_cuda_device_raises():
    before = kernels.cuda_matmul.launches
    a = torch.randn(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.cuda_matmul(a, a.T)
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.cuda_matmul(meta, meta.T)
    assert kernels.cuda_matmul.launches == before


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_matmul()
    assert list(tmp_path.iterdir()) == []


def test_bench_matmul_plans_prints_the_plans_and_needs_a_card():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "bench_matmul_plans.py")
    plans = subprocess.run([sys.executable, script, "--plans-only"],
                           capture_output=True, text=True, cwd=repo,
                           timeout=300)
    assert plans.returncode == 0, plans.stderr
    assert "config8 dWx 1" in plans.stdout and "split=6" in plans.stdout
    if not torch.cuda.is_available():
        timed = subprocess.run([sys.executable, script], capture_output=True,
                               text=True, cwd=repo, timeout=300)
        assert timed.returncode == 1
        assert "no CUDA device" in timed.stderr
