"""Dropout in the PyTorch package against the JAX package's: the counter
hash and ``dropout_`` (P1's plain version, ``ops/dropout.py``), the
``Dropout`` layer and the seeds ``Net.forward`` hands out, the Dropout MLP
through the port's K2 plain version and its step loop against the JAX
megakernel in interpret mode, ``TransformerBlock``'s dropout sites, and the
Dropout positions K2 refuses.

The JAX megakernel in interpret mode draws its masks from the counter hash
``_hash_bits_u32`` seeded with ``(t0 + i) * 1000003 + idx``; the port draws
the same masks by construction, so the Dropout MLP is held at K2's gates
(losses rtol 1e-5/atol 1e-6, parameters rtol 1e-4/atol 1e-5), and any larger
gap is a fault. The JAX package's step tiers draw threefry masks, which the
port does not reproduce: the TransformerBlock is compared with masks
injected into both packages' ``dropout_``.

The CUDA kernel (csrc/dropout.cu) runs only on a card:
tests/test_torch_cuda.py compares it with ``dropout_reference`` there.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu import ops as jops
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.net import Net as JNet
from tinynn_autograd_tpu.ops.primitives import dropout_ as jax_dropout
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.models import build_tiny_transformer
from tinynn_autograd_tpu_torch.nn import layers, optimizer
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.ops import dropout, fused_epoch, kernels
from tinynn_autograd_tpu_torch.utils import seeder
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
# the transformer block's gates (tests/test_torch_transformer.py)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# a seed past the int32 wrap: step 3000's first layer, 3000 * 1000003,
# wraps to a negative int32 in the JAX megakernel
WRAPPED = 3000 * 1000003
SEEDS = {"1": 1, "2": 2, "negative": -7, "past_wrap": WRAPPED}
SHAPES = {"tile": (256, 256), "ragged": (3, 7, 5)}


def _int32(seed):
    """The JAX megakernel's traced int32 seed of ``seed``."""
    return jnp.int32(np.int64(seed % 2 ** 32).astype(np.uint32).view(np.int32))


def _jax_drop(x, rate, seed):
    return jax_dropout(JTensor(x), rate, ("pltpu_seed", _int32(seed), True))


# --------------------------------------------------------------------------
# the hash and dropout_
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_dropout_matches_jax_element_for_element(seed, rate, shape):
    x = np.random.RandomState(0).randn(*SHAPES[shape]).astype(np.float32)
    want = np.asarray(_jax_drop(x, rate, SEEDS[seed]).data)
    got = ops.dropout_(Tensor(x), rate, SEEDS[seed]).numpy()
    np.testing.assert_array_equal(got, want)
    # the plain version itself, with its mask
    out, mask = dropout.dropout_reference(torch.from_numpy(x), rate,
                                          SEEDS[seed])
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(mask.numpy(), want != 0)


def test_seed_is_taken_mod_2_32():
    x = torch.ones(4, 9)
    a = dropout.dropout_reference(x, 0.5, WRAPPED)[0]
    b = dropout.dropout_reference(x, 0.5, WRAPPED - 2 ** 32)[0]
    assert torch.equal(a, b)
    assert dropout.layer_seed(3000, 1) == (WRAPPED + 1) % 2 ** 32


@pytest.mark.parametrize("seed", [2, WRAPPED])
def test_dropout_vjp_matches_jax(seed):
    rng = np.random.RandomState(1)
    x = rng.randn(6, 10).astype(np.float32)
    g = rng.randn(6, 10).astype(np.float32)
    jx = JTensor(x, requires_grad=True)
    jout = jax_dropout(jx, 0.3, ("pltpu_seed", _int32(seed), True))
    jout.backward(JTensor(g))
    tx = Tensor(x, requires_grad=True)
    tout = ops.dropout_(tx, 0.3, seed)
    tout.backward(g)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout.data))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jx.grad))


def test_tpu_check_statistics_on_the_plain_version():
    # tpu_check.py's check_pltpu_dropout_stats: a 256x256 tile of ones at
    # rate 0.5, seeds 1 and 2
    masks = {}
    for seed in (1, 2):
        out = ops.dropout_(Tensor(torch.ones(256, 256)), 0.5, seed).numpy()
        assert abs(float((out == 0.0).mean()) - 0.5) < 0.02
        assert np.all(out[out != 0.0] == 2.0)
        masks[seed] = out != 0.0
    assert float((masks[1] != masks[2]).mean()) > 0.3


def test_dropout_rates_out_of_range_raise():
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            ops.dropout_(Tensor(torch.ones(3)), rate, 1)
    with pytest.raises(TypeError, match="seed"):
        ops.dropout_(Tensor(torch.ones(3)), 0.5, "key")


# --------------------------------------------------------------------------
# the layer and the seeds
# --------------------------------------------------------------------------

def test_dropout_layer_phases_and_rate_zero():
    x = Tensor(np.random.RandomState(0).randn(8, 6).astype(np.float32))
    layer = layers.Dropout(0.5)
    layer.set_phase("TEST")
    assert layer.forward(x) is x
    layer.set_phase("TRAIN")
    assert layers.Dropout(0.0).forward(x) is x
    layer.set_rng(5)
    np.testing.assert_array_equal(layer.forward(x).numpy(),
                                  ops.dropout_(x, 0.5, 5).numpy())
    # without a seed it draws from the seeder's generator
    seeder.random_seed(3)
    a = layer.forward(x).numpy()
    seeder.random_seed(3)
    np.testing.assert_array_equal(layer.forward(x).numpy(), a)
    assert not np.array_equal(layer.forward(x).numpy(), a)


def test_net_seeds_each_seeded_layer_by_the_megakernel_rule():
    seen = []

    class Spy(layers.Dropout):
        def set_rng(self, rng):
            seen.append(rng)
            super().set_rng(rng)

    net = Net([layers.Dense(4, num_in=3), Spy(0.5), layers.ReLU(),
               Spy(0.0), layers.TransformerBlock(4, 2, dropout=0.1)])
    net.layers[-1].set_rng = lambda rng: seen.append(("block", rng))
    net.forward(Tensor(torch.ones(2, 1, 3)), rng=3000)
    assert seen == [dropout.layer_seed(3000, 0), dropout.layer_seed(3000, 1),
                    ("block", dropout.layer_seed(3000, 2))]


# --------------------------------------------------------------------------
# the Dropout MLP: the port's K2 plain version and step loop against the
# JAX megakernel in interpret mode
# --------------------------------------------------------------------------

def _mlp_layers(pkg, rate=0.3):
    return [pkg.Dense(32, num_in=16), pkg.ReLU(), pkg.Dropout(rate),
            pkg.Dense(32, num_in=32), pkg.ReLU(), pkg.Dropout(rate),
            pkg.Dense(10, num_in=32)]


def _mlp_data(n=128):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 16).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]


def _mlp_models(t0=0, n_ports=2):
    """The JAX model and ``n_ports`` port models with its parameters, Adam
    1e-2, each optimizer's step count set to ``t0``."""
    jax_seeder.random_seed(5)
    jm = JModel(JNet(_mlp_layers(jlayers)), JCE(), jopt.Adam(1e-2))
    tree = jm.net.params_tree()
    if t0:
        jm.optimizer.load_state_dict(dict(jm.optimizer.init_state(tree),
                                          t=jnp.int32(t0)))
    ports = []
    for _ in range(n_ports):
        tm = Model(Net(_mlp_layers(layers)), SoftmaxCrossEntropyLoss(),
                   optimizer.Adam(1e-2), device="cpu")
        tm.net.set_parameters(params_from_jax(tree, "cpu"))
        if t0:
            tm.optimizer.load_state_dict(dict(
                tm.optimizer.init_state(tm.net.params_tree()), t=t0))
        ports.append(tm)
    return jm, ports


def _assert_trees_close(jtree, ttree, tol, what):
    jtree = jax.tree.map(np.asarray, jtree)
    for i, (a, b) in enumerate(zip(jtree, params_to_numpy(ttree))):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="%s layer %d %s"
                                       % (what, i, k), **tol)


@pytest.mark.parametrize("t0", [0, 3000])
def test_dropout_mlp_matches_the_jax_megakernel(t0):
    x, y = _mlp_data()
    jm, (fused, loop) = _mlp_models(t0)
    lj = np.asarray(jm.train_epoch(x, y, batch_size=16, shuffle=False,
                                   fused=True))
    lf = fused.train_epoch(x, y, batch_size=16, shuffle=False, fused=True)
    ll = loop.train_epoch(x, y, batch_size=16, shuffle=False, fused=False)
    for what, losses, model in (("K2 plain", lf, fused),
                                ("step loop", ll, loop)):
        np.testing.assert_allclose(losses.numpy(), lj, err_msg=what,
                                   **LOSS_TOL)
        _assert_trees_close(jm.net.params_tree(), model.net.params_tree(),
                            STATE_TOL, what)
        assert model.optimizer.state_dict()["t"] == t0 + 8
    for name in ("m", "v"):
        _assert_trees_close(jm._opt_state["slots"][name],
                            fused.optimizer.state_dict()["slots"][name],
                            STATE_TOL, name)


def test_dropout_changes_the_training():
    x, y = _mlp_data()
    models = []
    for rate in (0.0, 0.3):
        with seeder.scope(0):
            models.append(Model(Net(_mlp_layers(layers, rate)),
                                SoftmaxCrossEntropyLoss(), optimizer.Adam(1e-2),
                                device="cpu"))
    a, b = (m.train_epoch(x, y, batch_size=16, fused=True, shuffle=False)
            for m in models)
    assert torch.isfinite(b).all() and not torch.allclose(a, b)
    # TEST-phase predictions do not drop
    models[1].set_phase("TEST")
    p1, p2 = (models[1].predict(x).numpy() for _ in range(2))
    np.testing.assert_array_equal(p1, p2)


# --------------------------------------------------------------------------
# the positions K2 refuses
# --------------------------------------------------------------------------

REFUSED = {
    "inputs": ([layers.Flatten(), layers.Dropout(0.2), layers.Dense(4)],
               "on the inputs"),
    "after_last": ([layers.Dense(4), layers.ReLU(), layers.Dropout(0.2)],
                   "follows the last Dense"),
    "between_dense_and_activation": (
        [layers.Dense(4), layers.Dropout(0.2), layers.ReLU(),
         layers.Dense(3)], "between a Dense layer and its activation"),
    "two_in_a_row": ([layers.Dense(4), layers.Dropout(0.2),
                      layers.Dropout(0.2), layers.Dense(3)],
                     "another Dropout"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_dropout_positions_are_named(case):
    layer_list, reason = REFUSED[case]
    net = Net(layer_list)
    net.init((16, 8))
    args = (net, net.params_tree(), optimizer.Adam(),
            SoftmaxCrossEntropyLoss())
    assert reason in fused_epoch.unsupported_reason(*args)
    assert fused_epoch.supports(*args) is False


def test_accepted_dropout_positions():
    for layer_list in ([layers.Dense(4), layers.Sigmoid(), layers.Dropout(0.2),
                        layers.Dense(3)],
                       [layers.Dense(4), layers.Dropout(0.2), layers.Dense(3)]):
        net = Net(layer_list)
        net.init((16, 8))
        assert fused_epoch.unsupported_reason(
            net, net.params_tree(), optimizer.Adam(),
            SoftmaxCrossEntropyLoss(), (16, 8)) is None


# --------------------------------------------------------------------------
# TransformerBlock
# --------------------------------------------------------------------------

def _inject(monkeypatch, keep=0.7):
    """Replace both packages' ``dropout_`` with a select from one table of
    masks, in call order, so that each package's k-th call drops the same
    cells. Returns the list of (shape, rate) of the port's calls."""
    masks, calls = {}, []

    def table(kind, shape, rate):
        n = sum(1 for c in calls if c[0] == kind)
        calls.append((kind, tuple(shape), rate))
        if n not in masks:
            masks[n] = (np.random.RandomState(100 + n).rand(*shape)
                        < keep).astype(np.float32) / keep
        return masks[n]

    monkeypatch.setattr(jops, "dropout_", lambda ts, rate, rng: ts * JTensor(
        table("jax", ts.shape, rate)))
    monkeypatch.setattr(ops, "dropout_", lambda ts, rate, rng: ts * Tensor(
        table("torch", ts.shape, rate)))
    return calls


@pytest.mark.parametrize("attn", ["fused", "tape"])
def test_transformer_block_dropout_matches_jax_with_injected_masks(
        monkeypatch, attn):
    calls = _inject(monkeypatch)
    # under "fused" the attention probabilities drop inside the flash
    # kernels, from their own hash: the residual sites alone here
    kw = dict(dim=16, num_heads=4, causal=True, attn=attn, dropout=0.2,
              attn_dropout=0.2 if attn == "tape" else 0.0)
    jb = jlayers.TransformerBlock(seed=3, **kw)
    tb = layers.TransformerBlock(**kw)
    for k, v in jb.params.items():
        tb.params[k] = Tensor(np.asarray(v.data), requires_grad=True)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 16).astype(np.float32)
    g = rng.randn(2, 8, 16).astype(np.float32)
    jx, tx = JTensor(x, requires_grad=True), Tensor(x, requires_grad=True)
    jout, tout = jb.forward(jx), tb.forward(tx)
    jout.backward(JTensor(g))
    tout.backward(g)
    sites = [c[1:] for c in calls if c[0] == "torch"]
    assert sites == ([((2, 4, 8, 8), 0.2)] if attn == "tape" else []) + [
        ((2, 8, 16), 0.2)] * 2
    assert [c[1:] for c in calls if c[0] == "jax"] == sites
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout.data), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                               **GRAD_TOL)
    for k in jb.params:
        np.testing.assert_allclose(tb.params[k].grad.numpy(),
                                   np.asarray(jb.params[k].grad), err_msg=k,
                                   **GRAD_TOL)


def test_transformer_block_derives_three_seeds(monkeypatch):
    seen = []
    real = ops.dropout_

    def spy(ts, rate, rng):
        seen.append(rng)
        return real(ts, rate, rng)

    monkeypatch.setattr(ops, "dropout_", spy)
    blk = layers.TransformerBlock(8, 2, attn="tape", dropout=0.1,
                                  attn_dropout=0.1, seed=1)
    blk.set_rng(2 ** 32 - 1)
    blk.forward(Tensor(np.ones((1, 4, 8), np.float32)))
    assert seen == [((2 ** 32 - 1) * 7919 + k) % 2 ** 32 for k in range(3)]


@pytest.mark.parametrize("attn", ["fused", "tape"])
def test_transformer_with_dropout_trains(attn):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 16, (32, 16))
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 32)]
    with seeder.scope(0):
        net = build_tiny_transformer(vocab=16, seq_len=16, dim=16, heads=2,
                                     depth=1, num_out=4, causal=True,
                                     dropout=0.1, attn_dropout=0.1)
    for layer in net.layers:
        if hasattr(layer, "attn"):
            layer.attn = attn
    model = Model(net, SoftmaxCrossEntropyLoss(), optimizer.Adam(3e-3),
                  device="cpu")
    losses = model.train_epochs(x, y, n_epochs=6, batch_size=8,
                                shuffle=False).numpy()
    assert np.isfinite(losses).all()
    assert losses[-1].mean() < losses[0].mean()
    model.set_phase("TEST")
    a, b = model.predict(x[:4]).numpy(), model.predict(x[:4]).numpy()
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the module and the kernel's wrapper without a GPU
# --------------------------------------------------------------------------

def test_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(dropout)
    assert "ctypes" not in vars(mod)
    assert "dropout" not in kernels._loaded
    assert mod.cuda_dropout.launches == 0


def test_cuda_wrapper_raises_on_cpu_tensors():
    before = dropout.cuda_dropout.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        dropout.cuda_dropout(torch.ones(4, 4), 0.5, 1)
    assert dropout.cuda_dropout.launches == before


def test_nvcc_command_targets_sm_90a():
    cmd = kernels.nvcc_command("nvcc", dropout.SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/dropout.cu")
