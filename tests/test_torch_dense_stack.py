"""The deep-MLP family of the PyTorch package against the JAX package:
``dense_stack_``, ``DenseStack``, ``build_deep_mlp``, checkpoints with 3-D
leaves, the seven optimizer rules and the five schedules.

Inputs come from numpy with a seed; parameters are copied from the JAX side
with ``params_from_jax``. The tolerances: rtol 1e-5/atol 1e-6 for one
primitive and for the optimizers' steps and slots (f32 sums in another
order, ``rsqrt`` in two libraries), rtol 1e-6 for the schedules' values (the
two libraries' f32 ``cos`` differ by an ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu import ops as jops
from tinynn_autograd_tpu.models import build_deep_mlp as jax_deep_mlp
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn import scheduler as jsched
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.models import build_deep_mlp
from tinynn_autograd_tpu_torch.nn import optimizer, scheduler
from tinynn_autograd_tpu_torch.nn.layers import Dense, DenseStack, ReLU
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.utils import seeder
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _stack_inputs(seed=0, L=4, B=8, W=16):
    rng = np.random.RandomState(seed)
    return ((rng.randn(L, W, W) * 0.2).astype(np.float32),
            (rng.randn(L, 1, W) * 0.1).astype(np.float32),
            rng.randn(B, W).astype(np.float32),
            rng.randn(B, W).astype(np.float32))


def _run_both(ws, bs, x, g, activation):
    """(out, dx, dw, db) of dense_stack_ in each package."""
    results = []
    for tensor, dense_stack in ((JTensor, jops.dense_stack_),
                                (Tensor, ops.dense_stack_)):
        tx, tw, tb = (tensor(a, requires_grad=True) for a in (x, ws, bs))
        out = dense_stack(tx, tw, tb, activation=activation)
        out.backward(g)
        results.append([np.asarray(v) for v in (
            out.numpy(), tx.grad, tw.grad, tb.grad)])
    return results


# --------------------------------------------------------------------------
# dense_stack_ and DenseStack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid", "linear"])
def test_dense_stack_matches_jax(activation):
    ws, bs, x, g = _stack_inputs()
    (jout, *jgrads), (tout, *tgrads) = _run_both(ws, bs, x, g, activation)
    assert tout.shape == (8, 16)
    np.testing.assert_allclose(tout, jout, **TOL)
    for name, a, b in zip(("dx", "dw", "db"), tgrads, jgrads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_dense_stack_relu_passes_at_zero():
    # unit 3 of layer 0 has a zero weight column and bias: its
    # pre-activation is exactly 0, where the tape's ReLU passes (z >= 0)
    ws, bs, x, g = _stack_inputs(seed=1)
    ws[0][:, 3] = 0.0
    bs[0][:, 3] = 0.0
    (jout, *jgrads), (tout, *tgrads) = _run_both(ws, bs, x, g, "relu")
    np.testing.assert_allclose(tout, jout, **TOL)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b, **TOL)
    assert tgrads[2][0, 0, 3] != 0.0  # db of layer 0, unit 3


def test_dense_stack_lazy_init_shapes_and_seed():
    stack = DenseStack(3)
    assert not stack.is_init and stack.width is None
    out = stack.forward(Tensor(np.ones((4, 8), np.float32)))
    assert stack.is_init and stack.width == 8
    assert stack.param_shapes == {"w": (3, 8, 8), "b": (3, 1, 8)}
    assert out.shape == (4, 8)
    assert stack.init_params((5, 8)) == (5, 8)
    a = DenseStack(2, width=6, seed=4).params["w"].numpy()
    b = DenseStack(2, width=6, seed=4).params["w"].numpy()
    assert a.tobytes() == b.tobytes()
    # per-layer Xavier draws with the 2-D fans: U(-sqrt(6/12), sqrt(6/12))
    assert np.abs(a).max() <= np.sqrt(0.5) and not np.array_equal(a[0], a[1])
    assert np.all(DenseStack(2, width=6).params["b"].numpy() == 0.0)


@pytest.mark.parametrize("stacked", [False, True])
def test_build_deep_mlp_matches_jax_structure(stacked):
    kw = dict(num_in=12, depth=6, width=16, num_out=3, stacked=stacked)
    jnet, tnet = jax_deep_mlp(**kw), build_deep_mlp(**kw)
    assert [l.name for l in tnet.layers] == [l.name for l in jnet.layers]
    assert [l.param_shapes for l in tnet.layers] == [
        {k: tuple(v.shape) for k, v in l.params.items()} for l in jnet.layers]
    n_params = sum(v.numel() for d in tnet.params_tree() for v in d.values())
    assert n_params == 12 * 16 + 16 + 4 * (16 * 16 + 16) + 16 * 3 + 3
    # same parameters, same function
    tnet.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    x = np.random.RandomState(2).randn(5, 12).astype(np.float32)
    np.testing.assert_allclose(tnet.forward(Tensor(x)).numpy(),
                               np.asarray(jnet.forward(JTensor(x)).numpy()),
                               **TOL)


# --------------------------------------------------------------------------
# checkpoints with 3-D leaves
# --------------------------------------------------------------------------

def _deep_pair():
    with jax_seeder.scope(2):
        jnet = jax_deep_mlp(num_in=12, depth=6, width=16, num_out=3,
                            stacked=True)
    jm = JModel(jnet, JCE(), jopt.Adam(1e-3))
    tm = Model(build_deep_mlp(num_in=12, depth=6, width=16, num_out=3,
                              stacked=True),
               SoftmaxCrossEntropyLoss(), optimizer.Adam(1e-3), device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    rng = np.random.RandomState(4)
    xs = rng.randn(3, 8, 12).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (3, 8))]
    return jm, tm, xs, ys


def _assert_params_close(jm, tm):
    jp = jax.tree.map(np.asarray, jm.net.params_tree())
    for a, b in zip(jp, params_to_numpy(tm.net.params_tree())):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], **STATE_TOL)


def test_jax_checkpoint_with_a_dense_stack_loads_in_torch(tmp_path):
    jm, _, xs, ys = _deep_pair()
    jm.train_step(xs[0], ys[0])
    jm.train_step(xs[1], ys[1])
    path = str(tmp_path / "jax.pkl")
    jm.save(path)
    # a lazy DenseStack takes its width from the checkpoint
    tm = Model(build_deep_mlp(num_in=12, depth=6, width=16, num_out=3,
                              stacked=True),
               SoftmaxCrossEntropyLoss(), optimizer.Adam(1e-3), device="cpu")
    tm.net.layers[2] = DenseStack(4)
    tm.load(path)
    assert tm.net.layers[2].width == 16
    assert tm.net.params_tree()[2]["w"].shape == (4, 16, 16)
    assert tm.optimizer.state_dict()["slots"]["v"][2]["w"].shape == (4, 16, 16)
    np.testing.assert_allclose(float(tm.train_step(xs[2], ys[2])),
                               float(jm.train_step(xs[2], ys[2])), **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_torch_checkpoint_with_a_dense_stack_loads_in_jax(tmp_path):
    jm, tm, xs, ys = _deep_pair()
    tm.train_step(xs[0], ys[0])
    tm.train_step(xs[1], ys[1])
    path = str(tmp_path / "torch.pkl")
    tm.save(path)
    jm.load(path)
    assert int(jm._opt_state["t"]) == 2
    np.testing.assert_allclose(float(jm.train_step(xs[2], ys[2])),
                               float(tm.train_step(xs[2], ys[2])), **LOSS_TOL)
    _assert_params_close(jm, tm)


# --------------------------------------------------------------------------
# the seven optimizer rules
# --------------------------------------------------------------------------

RULES = {"SGD": dict(lr=0.05), "Momentum": dict(lr=0.01),
         "Adam": dict(lr=1e-3), "Lion": dict(lr=1e-3),
         "RMSProp": dict(lr=1e-3, momentum=0.5), "Adagrad": dict(lr=0.05),
         "Adadelta": dict(lr=1.0)}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_optimizer_update_matches_jax(rule, weight_decay):
    kw = dict(RULES[rule], weight_decay=weight_decay)
    jo, to = getattr(jopt, rule)(**kw), getattr(optimizer, rule)(**kw)
    rng = np.random.RandomState(7)
    params = [{"w": rng.randn(2, 5, 4).astype(np.float32),
               "b": rng.randn(2, 1, 4).astype(np.float32)}, {},
              {"w": rng.randn(4, 3).astype(np.float32)}]
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_jax(params, "cpu")
    jstate, tstate = jo.init_state(jparams), to.init_state(tparams)
    for step in range(5):
        grads = [{k: rng.randn(*v.shape).astype(np.float32)
                  for k, v in d.items()} for d in params]
        jsteps, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jparams,
                                   jstate)
        tsteps, tstate = to.update(params_from_jax(grads, "cpu"), tparams,
                                   tstate)
        assert tstate["t"] == int(jstate["t"]) == step + 1
        for i, d in enumerate(params):
            for k in d:
                np.testing.assert_allclose(
                    tsteps[i][k].numpy(), np.asarray(jsteps[i][k]),
                    err_msg="step %d leaf %d%s" % (step, i, k), **TOL)
                for n in to.slot_names:
                    np.testing.assert_allclose(
                        tstate["slots"][n][i][k].numpy(),
                        np.asarray(jstate["slots"][n][i][k]),
                        err_msg="slot %s" % n, **TOL)
        jparams = jax.tree.map(lambda p, s: p + s, jparams, jsteps)
        for d, s in zip(tparams, tsteps):
            for k in d:
                d[k].add_(s[k])


def test_step_scalars_follow_a_schedule():
    sched = scheduler.StepDecayLR(0.1, step_size=2, gamma=0.5)
    got = optimizer.Momentum(sched).step_scalars(0, 4)
    np.testing.assert_array_equal(
        got, np.float32([[-0.1, 0], [-0.05, 0], [-0.05, 0], [-0.025, 0]]))
    assert optimizer.RMSProp(0.01).step_scalars(3, 1)[0, 0] == np.float32(0.01)


# --------------------------------------------------------------------------
# the schedules
# --------------------------------------------------------------------------

SCHEDULES = {
    "ConstantLR": dict(lr=0.1),
    "StepDecayLR": dict(lr=0.1, step_size=7, gamma=0.5),
    "ExponentialDecayLR": dict(lr=0.1, decay_steps=10, decay_rate=0.9),
    "CosineDecayLR": dict(lr=0.1, decay_steps=30, alpha=0.1),
    "WarmupCosineLR": dict(lr=0.01, warmup_steps=4, decay_steps=24,
                           alpha=0.05),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    js = getattr(jsched, name)(**SCHEDULES[name])
    ts = getattr(scheduler, name)(**SCHEDULES[name])
    ts_values = [ts(t) for t in range(1, 51)]
    assert all(type(v) is float for v in ts_values)
    np.testing.assert_allclose(
        np.float32(ts_values),
        np.float32([float(js(jnp.int32(t))) for t in range(1, 51)]),
        rtol=1e-6)


def test_lazy_deep_mlp_trains_on_the_step_loop():
    seeder.random_seed(3)
    net = build_deep_mlp(num_in=12, depth=5, width=16, num_out=3,
                         stacked=True)
    net.layers[0] = Dense(16)
    net.layers[1] = ReLU()
    model = Model(net, SoftmaxCrossEntropyLoss(), optimizer.Adam(1e-2),
                  device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(32, 12).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    losses = model.train_epochs(x, y, n_epochs=30, batch_size=32)
    assert losses.shape == (30, 1) and torch.isfinite(losses).all()
    assert float(losses[-1, 0]) < 0.5 * float(losses[0, 0])
