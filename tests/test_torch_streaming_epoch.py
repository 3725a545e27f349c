"""The weight-streaming tier (K3, K3b; ``ops/streaming_epoch.py``) against
the JAX package's, and the rules around its CUDA kernels that hold without a
GPU.

On the CPU ``train_epoch(fused="stream")`` runs the kernels' plain versions,
``stream_forward_reference`` and ``stream_backward_reference``; the JAX side
runs its Pallas streaming kernels in interpret mode, as
``tests/test_streaming_epoch.py`` does. Both start from the same parameters
(copied with ``params_from_jax``) and see the same numpy batches. Losses
agree within rtol 2e-4/atol 1e-6 (the JAX test's own tolerance), parameters
and slots at the end within rtol 1e-4/atol 1e-5. The initial parameters are
pinned (``seeder.scope(1)``): where a hidden unit's pre-activation lies
within rounding of 0, ReLU passes it in one package and not in the other,
and Adam (or Adagrad) turns that into a full lr-sized step (ROADMAP queue
3); the schedule case peaks at lr 1e-3 for the same reason.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
compares them with the plain versions there.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from tinynn_autograd_tpu.models import build_deep_mlp as jax_deep_mlp
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn import scheduler as jsched
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.net import Net as JNet
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch.models import build_deep_mlp, build_mnist_mlp
from tinynn_autograd_tpu_torch.nn import layers, optimizer, scheduler
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.ops import kernels, streaming_epoch
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
PARITY_SEED = 1
OPTS = {"sgd": ("SGD", dict(lr=0.05)),
        "momentum": ("Momentum", dict(lr=0.01)),
        "adam": ("Adam", dict(lr=1e-3)),
        "adam_weight_decay": ("Adam", dict(lr=1e-3, weight_decay=1e-4)),
        "rmsprop": ("RMSProp", dict(lr=1e-3)),
        "adagrad": ("Adagrad", dict(lr=0.05)),
        "adadelta": ("Adadelta", dict(lr=1.0)),
        "lion": ("Lion", dict(lr=1e-4))}


def _data(n=128, feat=64, classes=10):
    rng = np.random.RandomState(0)
    x = rng.randn(n, feat).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]
    return x, y


def _pair(opt=("Adam", dict(lr=1e-3)), depth=6, width=128, act="relu",
          jax_lr=None, torch_lr=None):
    """The JAX test's net, Dense(width, 64), ReLU, DenseStack, Dense(10), in
    both packages with the pinned JAX initial parameters."""
    cls, kw = opt
    with jax_seeder.scope(PARITY_SEED):
        jnet = JNet([jlayers.Dense(width, num_in=64), jlayers.ReLU(),
                     jlayers.DenseStack(depth, width=width, activation=act),
                     jlayers.Dense(10, num_in=width)])
    jkw, tkw = dict(kw), dict(kw)
    if jax_lr is not None:
        jkw["lr"], tkw["lr"] = jax_lr, torch_lr
    jm = JModel(jnet, JCE(), getattr(jopt, cls)(**jkw))
    tm = Model(Net([layers.Dense(width, num_in=64), layers.ReLU(),
                    layers.DenseStack(depth, width=width, activation=act),
                    layers.Dense(10, num_in=width)]),
               SoftmaxCrossEntropyLoss(), getattr(optimizer, cls)(**tkw),
               device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    return jm, tm


def _assert_trees_close(jtree, ttree, tol, what):
    jtree = jax.tree.map(np.asarray, jtree)
    ttree = params_to_numpy(ttree)
    assert len(jtree) == len(ttree)
    for i, (a, b) in enumerate(zip(jtree, ttree)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="%s layer %d %s"
                                       % (what, i, k), **tol)


def _assert_state_close(jm, tm):
    _assert_trees_close(jm.net.params_tree(), tm.net.params_tree(),
                        STATE_TOL, "params")
    state = tm.optimizer.state_dict()
    assert int(jm._opt_state["t"]) == state["t"]
    for name in tm.optimizer.slot_names:
        _assert_trees_close(jm._opt_state["slots"][name],
                            state["slots"][name], STATE_TOL, name)


# --------------------------------------------------------------------------
# the port's plain streaming tier against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opt", sorted(OPTS))
def test_stream_matches_jax_stream(opt):
    x, y = _data()
    jm, tm = _pair(OPTS[opt])
    for _ in range(3):
        lj = np.asarray(jm.train_epoch(x, y, batch_size=32, shuffle=False,
                                       fused="stream"))
        lt = tm.train_epoch(x, y, batch_size=32, shuffle=False,
                            fused="stream")
        assert lt.shape == (4,)
        np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_state_close(jm, tm)
    assert tm.optimizer.state_dict()["t"] == 12


def test_stream_tanh_body_over_three_epochs_matches_jax():
    x, y = _data()
    jm, tm = _pair(act="tanh")
    lj = np.asarray(jm.train_epochs(x, y, n_epochs=3, batch_size=32,
                                    shuffle=False, fused="stream"))
    lt = tm.train_epochs(x, y, n_epochs=3, batch_size=32, shuffle=False,
                         fused="stream").numpy()
    assert lt.shape == (3, 4)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    _assert_state_close(jm, tm)
    assert lt[-1].mean() < lt[0].mean()


def test_stream_depth_five_at_batch_64_matches_jax():
    x, y = _data()
    jm, tm = _pair(depth=5)
    lj = np.asarray(jm.train_epoch(x, y, batch_size=64, shuffle=False,
                                   fused="stream"))
    lt = tm.train_epoch(x, y, batch_size=64, shuffle=False, fused="stream")
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_state_close(jm, tm)


def test_stream_with_a_warmup_cosine_schedule_matches_jax():
    x, y = _data()
    kw = dict(lr=1e-3, warmup_steps=4, decay_steps=24)
    jm, tm = _pair(jax_lr=jsched.WarmupCosineLR(**kw),
                   torch_lr=scheduler.WarmupCosineLR(**kw))
    for _ in range(3):
        lj = np.asarray(jm.train_epoch(x, y, batch_size=32, shuffle=False,
                                       fused="stream"))
        lt = tm.train_epoch(x, y, batch_size=32, shuffle=False,
                            fused="stream")
        np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_state_close(jm, tm)


def test_stream_via_the_deep_mlp_builder_matches_jax():
    x, y = _data()
    with jax_seeder.scope(PARITY_SEED):
        jnet = jax_deep_mlp(num_in=64, depth=8, width=128, num_out=10,
                            stacked=True)
    jm = JModel(jnet, JCE(), jopt.SGD(0.05))
    tm = Model(build_deep_mlp(num_in=64, depth=8, width=128, num_out=10,
                              stacked=True),
               SoftmaxCrossEntropyLoss(), optimizer.SGD(0.05), device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    lj = np.asarray(jm.train_epoch(x, y, batch_size=32, shuffle=False,
                                   fused="stream"))
    lt = tm.train_epoch(x, y, batch_size=32, shuffle=False, fused="stream")
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_state_close(jm, tm)


def _dead_unit_pair(opt=("SGD", dict(lr=0.05))):
    """Unit 5 of the stack's first layer has a zero weight column and bias:
    its output is exactly 0 for every sample."""
    jm, tm = _pair(opt)
    params = jax.tree.map(np.array, jm.net.params_tree())
    params[2]["w"][0][:, 5] = 0.0
    params[2]["b"][0][:, 5] = 0.0
    jm.net.set_parameters(jax.tree.map(jax.numpy.asarray, params))
    tm.net.set_parameters(params_from_jax(params, "cpu"))
    return jm, tm


def test_stream_relu_derivative_is_taken_from_the_output():
    # a unit whose output is exactly 0 gets derivative 0 (a > 0): no
    # gradient reaches its bias or its weight column, in both packages'
    # streaming tiers; the step loop's tape passes at z == 0 (z >= 0)
    x, y = _data()
    jm, tm = _dead_unit_pair()
    lj = np.asarray(jm.train_epoch(x, y, batch_size=32, shuffle=False,
                                   fused="stream"))
    lt = tm.train_epoch(x, y, batch_size=32, shuffle=False, fused="stream")
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_state_close(jm, tm)
    stack = tm.net.params_tree()[2]
    assert torch.all(stack["w"][0][:, 5] == 0.0)
    assert float(stack["b"][0, 0, 5]) == 0.0

    _, loop = _dead_unit_pair()
    loop.train_epoch(x, y, batch_size=32, shuffle=False, fused=False)
    assert float(loop.net.params_tree()[2]["b"][0, 0, 5]) != 0.0


# --------------------------------------------------------------------------
# the streaming tier against the port's own step loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_stream_matches_the_step_loop(opt):
    x, y = _data()
    _, stream = _pair(OPTS[opt])
    _, loop = _pair(OPTS[opt])
    ls = stream.train_epochs(x, y, n_epochs=2, batch_size=32, shuffle=False,
                             fused="stream")
    ll = loop.train_epochs(x, y, n_epochs=2, batch_size=32, shuffle=False,
                           fused=False)
    np.testing.assert_allclose(ls.numpy(), ll.numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(params_to_numpy(stream.net.params_tree()),
                    params_to_numpy(loop.net.params_tree())):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **STATE_TOL)
    assert stream.optimizer.state_dict()["t"] == 8


def test_stream_then_step_loop_keeps_the_optimizer_state_coherent():
    x, y = _data()
    _, mixed = _pair()
    _, loop = _pair()
    mixed.train_epoch(x, y, batch_size=32, shuffle=False, fused="stream")
    slot = mixed.optimizer.state_dict()["slots"]["m"][2]["w"]
    assert float(slot.abs().sum()) > 0
    lm = mixed.train_epoch(x, y, batch_size=32, shuffle=False, fused=False)
    assert mixed.optimizer.state_dict()["t"] == 8
    assert mixed.optimizer.state_dict()["slots"]["m"][2]["w"] is slot
    loop.train_epoch(x, y, batch_size=32, shuffle=False, fused=False)
    ll = loop.train_epoch(x, y, batch_size=32, shuffle=False, fused=False)
    np.testing.assert_allclose(lm.numpy(), ll.numpy(), rtol=1e-5, atol=1e-6)


def test_shuffled_stream_epochs_train():
    x, y = _data(256)
    _, tm = _pair(("Adam", dict(lr=1e-3)), depth=3, width=64)
    losses = tm.train_epochs(x, y, n_epochs=4, batch_size=32, fused="stream")
    assert losses.shape == (4, 8) and torch.isfinite(losses).all()
    assert losses[-1].mean() < losses[0].mean()


def test_stream_with_a_flatten_prefix_and_no_dense_before_the_stack():
    rng = np.random.RandomState(3)
    x = rng.randn(64, 4, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 64)]
    models = []
    for _ in range(2):
        net = Net([layers.Flatten(),
                   layers.DenseStack(2, width=32, activation="sigmoid",
                                     seed=4),
                   layers.Dense(3, num_in=32, seed=5)])
        models.append(Model(net, SoftmaxCrossEntropyLoss(),
                            optimizer.RMSProp(1e-2), device="cpu"))
    ls = models[0].train_epoch(x, y, batch_size=16, shuffle=False,
                               fused="stream")
    ll = models[1].train_epoch(x, y, batch_size=16, shuffle=False,
                               fused=False)
    np.testing.assert_allclose(ls.numpy(), ll.numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# eligibility and tier choice
# --------------------------------------------------------------------------

class _OtherLayer(layers.Layer):
    def __init__(self):
        super().__init__("Other")


def _mixed_precision_dense():
    layer = layers.Dense(128, num_in=64)
    layer.compute_dtype = torch.bfloat16  # the port's Dense refuses the arg
    return layer


def _stack_net(width=128, act="relu"):
    return [layers.Dense(width, num_in=64), layers.ReLU(),
            layers.DenseStack(4, width=width, activation=act),
            layers.Dense(10, num_in=width)]


# (layers, optimizer, a word of the reason); the first five are the cases
# of the JAX package's test_streaming_supports_eligibility, the width case
# under the port's rule (a multiple of 32 up to streaming_epoch.MAX_WIDTH)
UNSUPPORTED = {
    "no_dense_stack": (lambda: [layers.Dense(128, num_in=64), layers.ReLU(),
                                layers.Dense(10, num_in=128)],
                       optimizer.Adam, "0 DenseStack"),
    "two_stacks": (lambda: [layers.DenseStack(2, width=128),
                            layers.DenseStack(2, width=128)],
                   optimizer.Adam, "2 DenseStack"),
    "width_100": (lambda: [layers.Dense(100, num_in=64),
                           layers.DenseStack(4, width=100),
                           layers.Dense(10, num_in=100)],
                  optimizer.Adam, "multiple of 32"),
    "other_layer": (lambda: [layers.Dense(128, num_in=64), _OtherLayer(),
                             layers.DenseStack(4, width=128),
                             layers.Dense(10, num_in=128)],
                    optimizer.Adam, "Other"),
    "width_too_large": (lambda: [layers.DenseStack(1)], optimizer.Adam,
                        "multiple of 32"),
    "activation": (lambda: _stack_net(act="gelu"), optimizer.Adam,
                   "activation"),
    "clip_norm": (_stack_net, lambda: optimizer.Adam(clip_norm=1.0),
                  "clip_norm"),
    "compute_dtype": (lambda: [_mixed_precision_dense(),
                               layers.DenseStack(4, width=128)],
                      optimizer.Adam, "compute_dtype"),
    "lazy": (lambda: [layers.DenseStack(4)], optimizer.Adam,
             "no parameters"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_reason(case):
    make_layers, make_opt, reason = UNSUPPORTED[case]
    net_layers = make_layers()
    if case == "width_too_large":
        # the first multiple of 32 past the cap, without drawing its weights
        width = streaming_epoch.MAX_WIDTH + streaming_epoch.CHUNK
        net_layers[0].shapes["w"] = [1, width, width]
        net_layers[0]._is_init = True
    net = Net(net_layers)
    opt = make_opt()
    assert not streaming_epoch.supports(net, opt)
    assert reason in streaming_epoch.unsupported_reason(net, opt)


@pytest.mark.parametrize("width", [32, 96, 128, 256])
def test_supports_widths_of_the_kernels_rule(width):
    # every width the JAX rule takes (a multiple of 128), and the narrower
    # multiples of 32 the kernels take as well
    net = Net(_stack_net(width))
    assert streaming_epoch.supports(net, optimizer.Adam(lr=lambda t: 1e-3))
    assert streaming_epoch.supports(net, optimizer.Lion(),
                                    batch_shape=(16, 64))


def test_prefix_must_hand_the_stack_its_rows():
    net = Net([layers.DenseStack(2, width=32), layers.Dense(3, num_in=32)])
    assert streaming_epoch.supports(net, optimizer.SGD(0.1), (8, 32))
    assert "[batch, 32]" in streaming_epoch.unsupported_reason(
        net, optimizer.SGD(0.1), (8, 4, 8))
    net = Net([layers.Flatten(), layers.DenseStack(2, width=32)])
    assert streaming_epoch.supports(net, optimizer.SGD(0.1), (8, 4, 8))


def test_forced_stream_on_an_ineligible_model_raises():
    x, y = _data()
    model = Model(Net([layers.Dense(10, num_in=64)]),
                  SoftmaxCrossEntropyLoss(), optimizer.Adam(), device="cpu")
    with pytest.raises(ValueError, match="fused='stream'.*DenseStack"):
        model.train_epoch(x, y, batch_size=32, fused="stream")
    _, tm = _pair(("Adam", dict(lr=1e-3, clip_norm=1.0)))
    with pytest.raises(ValueError, match="clip_norm"):
        tm.train_epoch(x, y, batch_size=32, fused="stream")


def test_auto_on_the_cpu_takes_the_step_loop(monkeypatch):
    calls = []
    plain = streaming_epoch.stream_backward_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(streaming_epoch, "stream_backward_reference", counted)
    x, y = _data()
    _, tm = _pair()
    tm.train_epoch(x, y, batch_size=32)
    tm.train_epoch(x, y, batch_size=32, fused="auto")
    assert calls == []
    tm.train_epoch(x, y, batch_size=32, fused="stream")
    assert calls == [1] * 4
    assert tm.optimizer.state_dict()["t"] == 12


def test_whole_epoch_kernel_refuses_a_dense_stack():
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    _, tm = _pair()
    reason = fused_epoch.unsupported_reason(
        tm.net, tm.net.params_tree(), tm.optimizer, tm.loss)
    assert "DenseStack" in reason


# --------------------------------------------------------------------------
# the module and the kernels' wrappers without a GPU
# --------------------------------------------------------------------------

def test_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(streaming_epoch)
    assert "ctypes" not in vars(mod)
    assert "streaming_epoch" not in kernels._loaded
    assert mod.cuda_stream_forward.launches == 0
    assert mod.cuda_stream_backward.launches == 0


def _body(L=2, B=4, W=32):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(B, W, generator=gen), torch.randn(L, W, W, generator=gen),
            torch.randn(L, 1, W, generator=gen))


def test_cuda_wrappers_raise_on_cpu_tensors():
    h0, w, b = _body()
    opt = optimizer.Adam()
    slots = {"m": torch.zeros_like(w), "v": torch.zeros_like(w)}
    acts = streaming_epoch.stream_forward_reference(h0, w, b, "relu")
    before = (streaming_epoch.cuda_stream_forward.launches,
              streaming_epoch.cuda_stream_backward.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        streaming_epoch.cuda_stream_forward(h0, w, b, "relu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        streaming_epoch.cuda_stream_backward("relu", opt, h0, h0, acts, w,
                                             slots, opt.scalars(1e-3, 1))
    assert (streaming_epoch.cuda_stream_forward.launches,
            streaming_epoch.cuda_stream_backward.launches) == before


def test_plain_versions_match_the_tape_primitive():
    # one body step: K3's plain version is dense_stack_'s forward, and
    # K3b's (SGD, lr 1) leaves w - dW and returns db and dx of the tape
    from tinynn_autograd_tpu_torch import Tensor, ops

    h0, w, b = _body(L=3, B=5, W=32)
    w = w * 0.2
    g = torch.randn(5, 32, generator=torch.Generator().manual_seed(1))
    tx, tw, tb = (Tensor(v.clone(), requires_grad=True) for v in (h0, w, b))
    out = ops.dense_stack_(tx, tw, tb, activation="tanh")
    out.backward(g)
    acts = streaming_epoch.stream_forward_reference(h0, w, b, "tanh")
    torch.testing.assert_close(acts[-1], out.data, rtol=1e-6, atol=1e-6)
    sgd = optimizer.SGD(1.0)
    w_new = w.clone()
    db, dh0 = streaming_epoch.stream_backward_reference(
        "tanh", sgd, h0, g, acts, w_new, {}, sgd.scalars(1.0, 1))
    torch.testing.assert_close(db, tb.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh0, tx.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(w - w_new, tw.grad, rtol=1e-5, atol=1e-6)


def test_optimizer_constants():
    from tinynn_autograd_tpu_torch.ops import fused_epoch

    code, consts = optimizer.Adam(beta1=0.8, beta2=0.99,
                                  epsilon=1e-7).kernel_rule()
    assert code == fused_epoch.OPTIMIZERS.index("Adam")
    assert consts == tuple(float(np.float32(c)) for c in
                           (1.0 - 0.8, 1.0 - 0.99, 1e-7, 0.0))
    for name in fused_epoch.OPTIMIZERS:
        code, consts = getattr(optimizer, name)(lr=0.1).kernel_rule()
        assert fused_epoch.OPTIMIZERS[code] == name and len(consts) == 4


def test_nvcc_command_targets_sm_90a():
    cmd = kernels.nvcc_command("nvcc", streaming_epoch.SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/streaming_epoch.cu")


def test_flagship_is_not_a_streaming_net():
    assert not streaming_epoch.supports(build_mnist_mlp(), optimizer.Adam())
