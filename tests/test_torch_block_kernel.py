"""K7, the fused transformer-block forward, of the PyTorch package against
the JAX package's: ``block_fwd_reference`` against ``block_fwd_pallas`` in
interpret mode and against the JAX ``TransformerBlock`` forward, and against
the port's own ``TransformerBlock`` (``attn="fused"`` and ``"tape"``); the
dispatch ``block_fwd`` on the CPU; what ``cuda_block_fwd`` refuses;
``block_costs``; and ``bench_block_probe_torch.py --device cpu``.

Inputs come from numpy with a seed; the JAX block's parameters are carried
across with ``params_from_jax``. Tolerance: tests/test_pallas.py's for the
block kernel, rtol 2e-4 / atol 2e-5 (f32 sums in other orders). Every shape
is small: the JAX interpret call is slow at larger ones.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.ops import block_kernel as jblock

from tinynn_autograd_tpu_torch import Tensor
from tinynn_autograd_tpu_torch.nn import layers
from tinynn_autograd_tpu_torch.ops import block_kernel, kernels
from tinynn_autograd_tpu_torch.utils.convert import params_from_jax

import bench_block_probe_torch as probe

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(b, t, d, heads, causal, seed=9):
    """(JAX block, its params as torch tensors, x as numpy) for one shape."""
    jblk = jlayers.TransformerBlock(dim=d, num_heads=heads, causal=causal,
                                    seed=seed)
    params = params_from_jax([{k: v.data for k, v in jblk.params.items()}],
                             "cpu")[0]
    x = np.random.RandomState(0).randn(b, t, d).astype(np.float32) * 0.5
    return jblk, params, x


def _port_block(params, d, heads, causal, attn):
    blk = layers.TransformerBlock(dim=d, num_heads=heads, causal=causal,
                                  attn=attn)
    blk.params = {k: Tensor(v) for k, v in params.items()}
    return blk


def _plain(params, x, heads, causal):
    return block_kernel.block_fwd_reference(
        torch.from_numpy(x), params, heads, causal=causal).numpy()


# --------------------------------------------------------------------------
# the plain version against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_block_kernel_interpret(causal):
    # tests/test_pallas.py's block-kernel size: D 32, 4 heads, T 16, B 8
    jblk, params, x = _both(8, 16, 32, 4, causal)
    jparams = {k: v.data for k, v in jblk.params.items()}
    want = np.asarray(jblock.block_fwd_pallas(
        x, jparams, heads=4, causal=causal, batch_block=2, interpret=True))
    np.testing.assert_allclose(_plain(params, x, 4, causal), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_transformer_block(causal):
    jblk, params, x = _both(8, 16, 32, 4, causal)
    want = np.asarray(jblk.forward(JTensor(x)).data)
    np.testing.assert_allclose(_plain(params, x, 4, causal), want, **TOL)


@pytest.mark.parametrize("attn", ["fused", "tape"])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_port_transformer_block(causal, attn):
    _, params, x = _both(8, 16, 32, 4, causal)
    blk = _port_block(params, 32, 4, causal, attn)
    want = blk.forward(Tensor(x)).numpy()
    np.testing.assert_allclose(_plain(params, x, 4, causal), want, **TOL)


# (B, T, D, heads): head dims 8 to 32, T past one 64-key tile and ragged
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 16, 2), (3, 20, 24, 3),
                                   (2, 33, 64, 2), (1, 70, 32, 4)])
def test_reference_sweep_matches_jax(shape, causal):
    b, t, d, heads = shape
    jblk, params, x = _both(b, t, d, heads, causal, seed=4)
    jparams = {k: v.data for k, v in jblk.params.items()}
    got = _plain(params, x, heads, causal)
    np.testing.assert_allclose(got, np.asarray(jblock.block_fwd_pallas(
        x, jparams, heads=heads, causal=causal, batch_block=1,
        interpret=True)), err_msg="pallas", **TOL)
    np.testing.assert_allclose(got, np.asarray(jblk.forward(JTensor(x)).data),
                               err_msg="TransformerBlock", **TOL)


def test_block_params_are_the_kernels_twelve():
    blk = layers.TransformerBlock(dim=32, num_heads=4, seed=3)
    params = block_kernel.block_params(blk)
    assert set(params) == set(block_kernel.PARAM_NAMES)
    assert all(params[k] is blk.params[k].data for k in params)


# --------------------------------------------------------------------------
# dispatch and the wrapper's refusals
# --------------------------------------------------------------------------

def test_block_fwd_on_cpu_runs_the_plain_version():
    _, params, x = _both(2, 16, 32, 4, True)
    before = block_kernel.cuda_block_fwd.launches
    got = block_kernel.block_fwd(torch.from_numpy(x), params, 4, causal=True)
    assert block_kernel.cuda_block_fwd.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(params, x, 4, True))


def _refused(case):
    _, params, x = _both(2, 8, 32, 4, False)
    x = torch.from_numpy(x)
    heads = 4
    if case == "f64":
        x = x.double()
    elif case == "non_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "heads":
        heads = 3
    elif case == "param_shape":
        params = dict(params, b1=params["b1"][0])
    phase_ns = torch.zeros(len(block_kernel.PHASES),
                           dtype=torch.int32 if case == "phase_ns"
                           else torch.int64)
    return x, params, heads, phase_ns


@pytest.mark.parametrize("case, match", [
    ("cpu", "needs CUDA tensors"), ("f64", "takes float32"),
    ("non_contiguous", "contiguous"), ("heads", "not a multiple of heads"),
    ("param_shape", "b1 has shape"), ("phase_ns", "phase_ns must be")])
def test_cuda_block_fwd_refuses(case, match):
    x, params, heads, phase_ns = _refused(case)
    before = block_kernel.cuda_block_fwd.launches
    with pytest.raises(ValueError, match=match):
        block_kernel.cuda_block_fwd(x, params, heads, phase_ns=phase_ns)
    assert block_kernel.cuda_block_fwd.launches == before


def test_block_kernel_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(block_kernel)
    assert "ctypes" not in vars(mod)
    assert "block_fwd" not in kernels._loaded
    assert mod.cuda_block_fwd.launches == 0
    assert mod.SOURCE.exists()
    cmd = kernels.nvcc_command("nvcc", mod.SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


# --------------------------------------------------------------------------
# costs and the probe script
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape, flops, n_bytes, bound_us", [
    # 2 B T (4 D^2 + 8 D^2) + 4 B heads pairs hd; 4 (2 B T D + 12 D^2 + 9 D)
    ((32, 128, 256, 8, False), 6979321856, 11543552, 104.169),
    ((32, 128, 256, 8, True), 6712983552, 11543552, 100.194),
    ((8, 512, 256, 8, True), 7518289920, 11543552, 112.213),
    ((4, 2048, 512, 8, True), 68727865344, 46155776, 1025.789)])
def test_block_costs_at_the_probe_shapes(shape, flops, n_bytes, bound_us):
    got = block_kernel.block_costs(*shape)
    assert got == (flops, n_bytes)
    us, by = probe.bound_us(*shape)
    assert by == "operations" and us == pytest.approx(bound_us, abs=1e-3)


def test_probe_script_on_cpu_prints_its_lines():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_block_probe_torch.py"),
         "--device", "cpu", "--tiny", "--reps", "1"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    lines = [json.loads(line) for line in out.splitlines()]
    assert lines[0] == {"device": "cpu", "card": None, "reps": 1}
    (row,) = lines[1:]
    assert row["shape"] == "b2t16d32h4c" and row["device"] == "cpu"
    assert row["max_abs_err_vs_plain"] == 0.0
    assert row["max_abs_err_vs_tape"] <= row["atol"]
    assert row["library_max_abs_err_vs_plain"] <= row["atol"]
    for key in ("kernel", "tape", "library", "plain"):
        assert row[key + "_cpu_us"] > 0 and key + "_us" not in row
    assert row["vs_tape"] == row["tape_cpu_us"] / row["kernel_cpu_us"]
