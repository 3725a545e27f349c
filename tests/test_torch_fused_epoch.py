"""The whole-epoch kernel's module (K2, ``ops/fused_epoch.py``) against the
JAX package's fused epoch, and the rules around the CUDA kernel that hold
without a GPU.

On the CPU ``train_epoch(fused=True)`` runs K2's plain version,
``fused_epoch_reference``; the JAX side runs its Pallas megakernel in
interpret mode, as ``tests/test_fused_epoch.py`` does. Both start from the
same parameters (copied with ``params_from_jax``) and see the same numpy
batches. The flagship-width cases pin their initial parameters
(``seeder.scope(0)``): where a hidden unit's pre-activation lies within
rounding of 0, ReLU passes it in one package and not in the other, and Adam
turns that into a full lr-sized step (ROADMAP queue 3).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py
compares it with ``fused_epoch_reference`` there.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.models import build_mnist_mlp as jax_mlp
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.net import Net as JNet
from tinynn_autograd_tpu.ops import kernels as jkernels
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch.models import build_mnist_mlp
from tinynn_autograd_tpu_torch.nn import layers, optimizer
from tinynn_autograd_tpu_torch.nn.losses import BaseLoss, SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.ops import fused_epoch, kernels
from tinynn_autograd_tpu_torch.utils import datasets
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
TOY_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_fused_epoch.py
ACTS = {"relu": (jlayers.ReLU, layers.ReLU),
        "sigmoid": (jlayers.Sigmoid, layers.Sigmoid)}
OPTS = {"sgd": dict(cls="SGD", lr=0.05),
        "adam": dict(cls="Adam", lr=1e-2),
        "adam_weight_decay": dict(cls="Adam", lr=1e-2, weight_decay=1e-2)}


def _opts(kwargs):
    kw = dict(kwargs)
    cls = kw.pop("cls")
    return getattr(jopt, cls)(**kw), getattr(optimizer, cls)(**kw)


def _toy_pair(act="relu", opt=OPTS["adam"], weight=None, seed=1):
    """The JAX test's toy net, Dense(16, num_in=8), act, Dense(4), in both
    packages with equal parameters."""
    jact, tact = ACTS[act]
    jax_opt, torch_opt = _opts(opt)
    jax_seeder.random_seed(seed)
    jnet = JNet([jlayers.Dense(16, num_in=8), jact(),
                 jlayers.Dense(4, num_in=16)])
    jm = JModel(jnet, JCE(weight=weight), jax_opt)
    tm = Model(Net([layers.Dense(16, num_in=8), tact(),
                    layers.Dense(4, num_in=16)]),
               SoftmaxCrossEntropyLoss(weight=weight), torch_opt,
               device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    return jm, tm


def _toy_data(n=64):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]
    return x, y


def _flagship_pair():
    """Flagship MLPs with the pinned JAX initial parameters, Adam 1e-3."""
    with jax_seeder.scope(0):
        jnet = jax_mlp()
    jm = JModel(jnet, JCE(), jopt.Adam(1e-3))
    tm = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
               optimizer.Adam(1e-3), device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    return jm, tm


def _flagship_data(n_steps=4):
    (x, y), _ = datasets.synthetic_mnist(n_steps * 128, 10, seed=31)
    return x, datasets.one_hot(y)


def _assert_trees_close(jtree, ttree, tol, what):
    jtree = jax.tree.map(np.asarray, jtree)
    ttree = params_to_numpy(ttree)
    assert len(jtree) == len(ttree)
    for i, (a, b) in enumerate(zip(jtree, ttree)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="%s layer %d %s"
                                       % (what, i, k), **tol)


# --------------------------------------------------------------------------
# the port's plain K2 against the JAX package's megakernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_fused_epoch_matches_jax_fused_epoch(opt, act):
    x, y = _toy_data()
    jm, tm = _toy_pair(act, OPTS[opt])
    for _ in range(2):
        lj = np.asarray(jm.train_epoch(x, y, batch_size=16, shuffle=False,
                                       fused=True))
        lt = tm.train_epoch(x, y, batch_size=16, shuffle=False, fused=True)
        assert lt.shape == (4,)
        np.testing.assert_allclose(lt.numpy(), lj, **TOY_TOL)
    _assert_trees_close(jm.net.params_tree(), tm.net.params_tree(), TOY_TOL,
                        "params")
    assert int(jm._opt_state["t"]) == tm.optimizer.state_dict()["t"] == 8


def test_class_weighted_fused_epoch_matches_jax():
    # the JAX megakernel cannot take class weights (Pallas refuses the
    # captured weight vector), so the JAX side is its scanned tier
    weight = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    x, y = _toy_data()
    jm, tm = _toy_pair(weight=weight)
    lj = np.asarray(jm.train_epoch(x, y, batch_size=16, shuffle=False,
                                   fused=False))
    lt = tm.train_epoch(x, y, batch_size=16, shuffle=False, fused=True)
    np.testing.assert_allclose(lt.numpy(), lj, **TOY_TOL)
    _assert_trees_close(jm.net.params_tree(), tm.net.params_tree(), TOY_TOL,
                        "params")


def test_flagship_fused_epoch_matches_jax():
    x, y = _flagship_data()
    jm, tm = _flagship_pair()
    lj = np.asarray(jm.train_epoch(x, y, batch_size=128, shuffle=False,
                                   fused=True))
    lt = tm.train_epoch(x, y, batch_size=128, shuffle=False, fused=True)
    assert lt.shape == (4,)
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_trees_close(jm.net.params_tree(), tm.net.params_tree(),
                        STATE_TOL, "params")
    state = tm.optimizer.state_dict()
    assert int(jm._opt_state["t"]) == state["t"] == 4
    for name in ("m", "v"):
        _assert_trees_close(jm._opt_state["slots"][name],
                            state["slots"][name], STATE_TOL, name)


def test_fused_epoch_matches_the_step_loop():
    x, y = _flagship_data()
    _, a = _flagship_pair()
    _, b = _flagship_pair()
    la = a.train_epoch(x, y, batch_size=128, shuffle=False, fused=True)
    lb = b.train_epoch(x, y, batch_size=128, shuffle=False, fused=False)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), **LOSS_TOL)
    for pa, pb in zip(params_to_numpy(a.net.params_tree()),
                      params_to_numpy(b.net.params_tree())):
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], **STATE_TOL)


def test_bf16_matmul_precision_matches_jax_and_changes_the_losses():
    x, y = _toy_data()
    _, f32_model = _toy_pair()
    f32 = f32_model.train_epoch(x, y, batch_size=16, shuffle=False,
                                fused=True).numpy()
    jm, tm = _toy_pair()
    jkernels.set_matmul_precision("bf16")
    kernels.set_matmul_precision("bf16")
    try:
        lj = np.asarray(jm.train_epoch(x, y, batch_size=16, shuffle=False,
                                       fused=True))
        lt = tm.train_epoch(x, y, batch_size=16, shuffle=False,
                            fused=True).numpy()
    finally:
        jkernels.set_matmul_precision("f32")
        kernels.set_matmul_precision("f32")
    np.testing.assert_allclose(lt, lj, rtol=1e-3, atol=1e-4)
    assert np.max(np.abs(lt - f32)) > 1e-5


def test_fused_then_step_loop_keeps_the_optimizer_state_coherent():
    x, y = _toy_data()
    _, mixed = _toy_pair()
    _, loop = _toy_pair()
    mixed.train_epoch(x, y, batch_size=16, shuffle=False, fused=True)
    state = mixed.optimizer.state_dict()
    slot = state["slots"]["m"][0]["w"]
    assert state["t"] == 4 and float(slot.abs().sum()) > 0
    lm = mixed.train_epoch(x, y, batch_size=16, shuffle=False, fused=False)
    assert mixed.optimizer.state_dict()["t"] == 8
    assert mixed.optimizer.state_dict()["slots"]["m"][0]["w"] is slot
    loop.train_epochs(x, y, n_epochs=1, batch_size=16, shuffle=False,
                      fused=False)
    ll = loop.train_epoch(x, y, batch_size=16, shuffle=False, fused=False)
    np.testing.assert_allclose(lm.numpy(), ll.numpy(), **LOSS_TOL)


def test_shuffled_fused_epochs_train():
    x, y = _toy_data(128)
    _, tm = _toy_pair()
    losses = tm.train_epochs(x, y, n_epochs=4, batch_size=16, fused=True)
    assert losses.shape == (4, 8) and torch.isfinite(losses).all()
    assert losses[-1].mean() < losses[0].mean()
    assert tm.optimizer.state_dict()["t"] == 32


def test_flatten_input_runs_through_the_plain_kernel():
    rng = np.random.RandomState(3)
    x = rng.randn(48, 4, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 48)]
    models = []
    for _ in range(2):
        net = Net([layers.Flatten(), layers.Dense(6, num_in=12, seed=4),
                   layers.Tanh(), layers.Dense(3, num_in=6, seed=5)])
        models.append(Model(net, SoftmaxCrossEntropyLoss(),
                            optimizer.SGD(0.1), device="cpu"))
    lf = models[0].train_epoch(x, y, batch_size=16, shuffle=False, fused=True)
    ls = models[1].train_epoch(x, y, batch_size=16, shuffle=False,
                               fused=False)
    np.testing.assert_allclose(lf.numpy(), ls.numpy(), **LOSS_TOL)


# --------------------------------------------------------------------------
# gating
# --------------------------------------------------------------------------

def _net(*layer_list):
    net = Net(list(layer_list))
    return net, net.params_tree()


def test_supports_dense_sigmoid_with_adam():
    net, tree = _net(layers.Dense(4, num_in=8), layers.Sigmoid())
    assert fused_epoch.supports(net, tree, optimizer.Adam(),
                                SoftmaxCrossEntropyLoss())
    assert fused_epoch.supports(net, tree, optimizer.SGD(0.1),
                                SoftmaxCrossEntropyLoss(weight=np.ones(4)))


class _OtherLoss(BaseLoss):
    pass


class _OtherLayer(layers.Layer):
    def __init__(self):
        super().__init__("Other")


def _mixed_precision_dense():
    layer = layers.Dense(4, num_in=8)
    layer.compute_dtype = torch.bfloat16  # the port's Dense refuses the arg
    return layer


UNSUPPORTED = {
    "budget": (lambda: [layers.Dense(4096, num_in=4096)],
               lambda: optimizer.Adam(), SoftmaxCrossEntropyLoss, "budget"),
    "lr_not_a_number": (lambda: [layers.Dense(4, num_in=8)],
                        lambda: optimizer.Adam(lr="1e-3"),
                        SoftmaxCrossEntropyLoss, "learning rate"),
    "clip_norm_not_positive": (lambda: [layers.Dense(4, num_in=8)],
                               lambda: optimizer.Adam(clip_norm=0.0),
                               SoftmaxCrossEntropyLoss, "clip_norm"),
    "loss": (lambda: [layers.Dense(4, num_in=8)], lambda: optimizer.Adam(),
             _OtherLoss, "loss"),
    "layer": (lambda: [layers.Dense(4, num_in=8), _OtherLayer()],
              lambda: optimizer.Adam(), SoftmaxCrossEntropyLoss, "layer"),
    "two_activations": (lambda: [layers.Dense(4, num_in=8), layers.ReLU(),
                                 layers.Tanh()],
                        lambda: optimizer.Adam(), SoftmaxCrossEntropyLoss,
                        "activation"),
    "activation_first": (lambda: [layers.ReLU(), layers.Dense(4, num_in=8)],
                         lambda: optimizer.Adam(), SoftmaxCrossEntropyLoss,
                         "activation"),
    "no_dense": (lambda: [layers.Flatten()], lambda: optimizer.Adam(),
                 SoftmaxCrossEntropyLoss, "no Dense"),
    "compute_dtype": (lambda: [_mixed_precision_dense()],
                      lambda: optimizer.Adam(), SoftmaxCrossEntropyLoss,
                      "compute_dtype"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_supports_rejects(case):
    make_layers, make_opt, loss_cls, reason = UNSUPPORTED[case]
    net, tree = _net(*make_layers())
    opt, loss = make_opt(), loss_cls()
    assert not fused_epoch.supports(net, tree, opt, loss)
    assert reason in fused_epoch.unsupported_reason(net, tree, opt, loss)


def test_unflattened_image_input_is_rejected():
    net, tree = _net(layers.Dense(4, num_in=8))
    args = (net, tree, optimizer.Adam(), SoftmaxCrossEntropyLoss())
    assert fused_epoch.supports(*args, batch_shape=(16, 8))
    assert not fused_epoch.supports(*args, batch_shape=(16, 2, 4))


def test_forced_fused_epoch_on_an_unsupported_model_raises():
    x, y = _toy_data()
    model = Model(Net([layers.Dropout(0.1), layers.Dense(4, num_in=8)]),
                  SoftmaxCrossEntropyLoss(), optimizer.Adam(), device="cpu")
    with pytest.raises(ValueError, match="Dropout 0 is on the inputs"):
        model.train_epoch(x, y, batch_size=16, fused=True)
    with pytest.raises(ValueError, match="fused must be"):
        model.train_epoch(x, y, batch_size=16, fused="always")


def test_auto_on_the_cpu_takes_the_step_loop(monkeypatch):
    calls = []
    plain = fused_epoch.fused_epoch_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fused_epoch, "fused_epoch_reference", counted)
    x, y = _toy_data()
    _, tm = _toy_pair()
    tm.train_epoch(x, y, batch_size=16)
    tm.train_epoch(x, y, batch_size=16, fused="auto")
    assert calls == []
    tm.train_epoch(x, y, batch_size=16, fused=True)
    assert calls == [1]
    assert tm.optimizer.state_dict()["t"] == 12


# --------------------------------------------------------------------------
# the module and the kernel's wrapper without a GPU
# --------------------------------------------------------------------------

def test_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(fused_epoch)
    assert "ctypes" not in vars(mod)
    assert "fused_epoch" not in kernels._loaded
    assert mod.cuda_fused_epoch.launches == 0


def test_cuda_wrapper_raises_on_cpu_tensors():
    _, tm = _toy_pair()
    spec = fused_epoch.epoch_spec(tm.net, tm.optimizer)
    params = fused_epoch.dense_leaves(tm.net, tm.net.params_tree())
    slots = tm.optimizer.init_state(tm.net.params_tree())["slots"]
    slots = {k: fused_epoch.dense_leaves(tm.net, v) for k, v in slots.items()}
    xb, yb = torch.zeros(2, 16, 8), torch.zeros(2, 16, 4)
    before = fused_epoch.cuda_fused_epoch.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_epoch.cuda_fused_epoch(spec, params, slots, xb, yb,
                                     torch.zeros(2, 2))
    assert fused_epoch.cuda_fused_epoch.launches == before


def test_nvcc_command_targets_sm_90a():
    cmd = kernels.nvcc_command("nvcc", fused_epoch.SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert cmd[-1].endswith("csrc/fused_epoch.cu")


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library("fused_epoch")
    assert list(tmp_path.iterdir()) == []


def test_layer_descriptor():
    relu, none = fused_epoch.ACT_RELU, fused_epoch.ACT_NONE
    assert fused_epoch.layer_descriptor(build_mnist_mlp()) == [
        (784, 200, relu, 0.0, -1), (200, 100, relu, 0.0, -1),
        (100, 70, relu, 0.0, -1), (70, 30, relu, 0.0, -1),
        (30, 10, none, 0.0, -1)]
    net = Net([layers.Flatten(), layers.Dense(6, num_in=12),
               layers.Sigmoid(), layers.Dense(5, num_in=6), layers.Tanh(),
               layers.Dense(3, num_in=5)])
    assert fused_epoch.layer_descriptor(net) == [
        (12, 6, fused_epoch.ACT_SIGMOID, 0.0, -1),
        (6, 5, fused_epoch.ACT_TANH, 0.0, -1), (5, 3, none, 0.0, -1)]
    # a Dropout after an activation or after a Dense without one; its seed
    # index counts every Dropout before it, rate 0 included
    net = Net([layers.Dense(6, num_in=12), layers.ReLU(), layers.Dropout(0.0),
               layers.Dense(5, num_in=6), layers.Dropout(0.25),
               layers.Dense(3, num_in=5)])
    assert fused_epoch.layer_descriptor(net) == [
        (12, 6, relu, 0.0, 0), (6, 5, none, 0.25, 1), (5, 3, none, 0.0, -1)]


def test_step_scalars_match_the_jax_optimizers():
    got = optimizer.Adam(lr=2e-3, beta1=0.8, beta2=0.99).step_scalars(3, 4)
    assert got.dtype == np.float32 and got.shape == (4, 2)
    for row, t in zip(got, range(4, 8)):
        tf = jnp.float32(t)
        c1 = 1.0 - jnp.exp(tf * jnp.log(jnp.float32(0.8)))
        c2 = 1.0 - jnp.exp(tf * jnp.log(jnp.float32(0.99)))
        np.testing.assert_allclose(row, [float(-(2e-3 / c1)),
                                         float(jax.lax.rsqrt(c2))],
                                   rtol=1e-6)
    sgd = optimizer.SGD(0.05).step_scalars(0, 3)
    np.testing.assert_array_equal(sgd[:, 0], np.float32(-0.05))
