"""The MLP trainer slice of the PyTorch package against the JAX package.

A JAX ``Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3))`` and
the PyTorch one start from the same parameters (copied with
``params_from_jax``) and see the same numpy batches (synthetic MNIST). Then
per-step losses must agree to rtol 1e-5 / atol 1e-6 and the parameters after
five Adam steps to rtol 1e-4 / atol 1e-5. The f32 sums run in another order;
Adam's first steps move each parameter by about lr * sign(g), so the drift
stays at rounding scale. Not so where a hidden unit's pre-activation lies
within rounding of 0 for one sample: ReLU passes it in one package and not
in the other, and Adam turns that one sample's tiny gradient into a full
lr-sized step for the unit's whole weight column. About one initial draw in
six has such a unit at the flagship width on these batches, so the JAX
initial parameters are pinned (``seeder.scope(0)``), which has none.
"""

import numpy as np
import pytest
import torch

import jax

from tinynn_autograd_tpu.core.tensor import Tensor as JTensor
from tinynn_autograd_tpu.models import build_mnist_mlp as jax_mlp
from tinynn_autograd_tpu.nn.evaluator import AccEvaluator as JAcc
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.optimizer import Adam as JAdam
from tinynn_autograd_tpu.utils import datasets as jax_datasets
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch import initializer, optimizer
from tinynn_autograd_tpu_torch.core.tensor import Tensor
from tinynn_autograd_tpu_torch.models import build_mnist_mlp
from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator
from tinynn_autograd_tpu_torch.nn.layers import Dense
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.optimizer import SGD, Adam
from tinynn_autograd_tpu_torch.utils import datasets, seeder
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)
from tinynn_autograd_tpu_torch.utils.data_iterator import BatchIterator

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
FLAGSHIP = (200, 100, 70, 30)
NARROW = (32, 16)


def _batches(n_steps, batch=128, seed=31):
    (x, y), _ = datasets.synthetic_mnist(n_steps * batch, 10, seed=seed)
    y = datasets.one_hot(y)
    return x.reshape(n_steps, batch, 784), y.reshape(n_steps, batch, 10)


def _pair(hidden=FLAGSHIP, jax_opt=None, torch_opt=None, weight=None):
    """A JAX model and a PyTorch model on the CPU with equal parameters
    (Adam 1e-3 unless optimizers are given)."""
    with jax_seeder.scope(0):
        jnet = jax_mlp(hidden=hidden)
    jm = JModel(jnet, JCE(weight=weight), jax_opt or JAdam(1e-3))
    tm = Model(build_mnist_mlp(hidden=hidden),
               SoftmaxCrossEntropyLoss(weight=weight), torch_opt or Adam(1e-3),
               device="cpu")
    tm.net.set_parameters(params_from_jax(jm.net.params_tree(), "cpu"))
    return jm, tm


def _assert_params_close(jm, tm, tol=PARAM_TOL):
    jp = jax.tree.map(np.asarray, jm.net.params_tree())
    tp = params_to_numpy(tm.net.params_tree())
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="layer %d %s"
                                       % (i, k), **tol)


@pytest.mark.parametrize("hidden", [FLAGSHIP, NARROW],
                         ids=["flagship", "narrow"])
def test_train_step_matches_jax(hidden):
    jm, tm = _pair(hidden)
    xs, ys = _batches(5)
    for i in range(5):
        lj = float(jm.train_step(xs[i], ys[i]))
        lt = tm.train_step(xs[i], ys[i])
        assert lt.shape == () and lt.device.type == "cpu"
        np.testing.assert_allclose(float(lt), lj, err_msg="step %d" % i,
                                   **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_train_epoch_matches_jax_scanned_tier():
    jm, tm = _pair(NARROW)
    xs, ys = _batches(6, batch=64)
    x, y = xs.reshape(-1, 784)[:-20], ys.reshape(-1, 10)[:-20]  # ragged tail
    lj = np.asarray(jm.train_epoch(x, y, batch_size=64, shuffle=False,
                                   fused=False))
    x_dev, y_dev = tm.stage(x, y)
    lt = tm.train_epoch(x_dev, y_dev, batch_size=64, shuffle=False)
    assert lt.shape == (5,)
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_eager_loop_matches_jax():
    jm, tm = _pair(NARROW)
    xs, ys = _batches(3)
    for i in range(3):
        losses = []
        for model, tensor_cls in ((jm, JTensor), (tm, Tensor)):
            model.zero_grad()
            pred = model.forward(tensor_cls(xs[i]))
            loss = model.loss.loss(pred, tensor_cls(ys[i]))
            loss.backward()
            model.step()
            losses.append(float(loss.values))
        np.testing.assert_allclose(losses[1], losses[0], **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_predict_and_evaluate_match_jax():
    jm, tm = _pair(NARROW)
    xs, ys = _batches(4)
    for i in range(4):
        jm.train_step(xs[i], ys[i])
        tm.train_step(xs[i], ys[i])
    _, (x_test, y_test) = datasets.synthetic_mnist(10, 500)
    pj = np.asarray(jm.predict(x_test).numpy())
    pt = tm.predict(x_test)
    assert pt.requires_grad is False and pt.shape == (500, 10)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-4, atol=1e-5)
    rj = jm.evaluate_batch(x_test, y_test, JAcc)
    rt = tm.evaluate_batch(x_test, y_test, AccEvaluator)
    assert rt == rj
    assert tm.get_phase() == "TRAIN"


@pytest.mark.parametrize("kwargs", [dict(n_train=300, n_test=50),
                                    dict(n_train=64, n_test=8, seed=7)])
def test_synthetic_mnist_is_byte_identical(kwargs):
    ours = datasets.synthetic_mnist(**kwargs)
    theirs = jax_datasets.synthetic_mnist(**kwargs)
    for (a, b), (c, d) in zip(ours, theirs):
        assert a.dtype == c.dtype and b.dtype == d.dtype
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
    labels = ours[0][1][:20]
    assert datasets.one_hot(labels).tobytes() == \
        jax_datasets.one_hot(labels).tobytes()


def test_load_mnist_without_a_file_is_synthetic(tmp_path):
    (x, y), (xt, yt) = datasets.load_mnist(str(tmp_path))
    ref = datasets.synthetic_mnist()
    assert x.tobytes() == ref[0][0].tobytes()
    assert yt.tobytes() == ref[1][1].tobytes()
    with pytest.raises(FileNotFoundError):
        datasets.load_mnist(str(tmp_path), allow_synthetic=False)


def test_jax_checkpoint_loads_and_trains_on(tmp_path):
    jm, _ = _pair(NARROW)
    xs, ys = _batches(3)
    jm.train_step(xs[0], ys[0])
    jm.train_step(xs[1], ys[1])
    path = str(tmp_path / "jax.pkl")
    jm.save(path)
    tm = Model(build_mnist_mlp(hidden=NARROW), SoftmaxCrossEntropyLoss(),
               Adam(1e-3), device="cpu")
    tm.load(path)
    assert tm.optimizer.state_dict()["t"] == 2
    np.testing.assert_allclose(float(tm.train_step(xs[2], ys[2])),
                               float(jm.train_step(xs[2], ys[2])), **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_torch_checkpoint_loads_in_jax(tmp_path):
    jm, tm = _pair(NARROW)
    xs, ys = _batches(3)
    tm.train_step(xs[0], ys[0])
    tm.train_step(xs[1], ys[1])
    path = str(tmp_path / "torch.pkl")
    tm.save(path)
    jm.load(path)
    np.testing.assert_allclose(float(jm.train_step(xs[2], ys[2])),
                               float(tm.train_step(xs[2], ys[2])), **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_class_weighted_loss_matches_jax():
    weight = np.linspace(0.5, 1.5, 10).astype(np.float32)
    xs, ys = _batches(1)
    jm, tm = _pair(NARROW, weight=weight)
    np.testing.assert_allclose(float(tm.train_step(xs[0], ys[0])),
                               float(jm.train_step(xs[0], ys[0])), **LOSS_TOL)


@pytest.mark.parametrize("opt_kwargs", [
    dict(cls="SGD", lr=0.1, weight_decay=1e-3),
    dict(cls="Adam", lr=1e-3, clip_norm=0.05),
], ids=["sgd_weight_decay", "adam_clip_norm"])
def test_optimizer_options_match_jax(opt_kwargs):
    from tinynn_autograd_tpu.nn import optimizer as jopt

    kw = dict(opt_kwargs)
    cls = kw.pop("cls")
    jm, tm = _pair(NARROW, getattr(jopt, cls)(**kw),
                   getattr(optimizer, cls)(**kw))
    xs, ys = _batches(3)
    for i in range(3):
        np.testing.assert_allclose(float(tm.train_step(xs[i], ys[i])),
                                   float(jm.train_step(xs[i], ys[i])),
                                   **LOSS_TOL)
    _assert_params_close(jm, tm)


def test_shuffled_epochs_train_and_are_seeded():
    xs, ys = _batches(4, batch=32)
    x, y = xs.reshape(-1, 784), ys.reshape(-1, 10)
    traces = []
    for _ in range(2):
        seeder.random_seed(5)
        model = Model(build_mnist_mlp(hidden=NARROW),
                      SoftmaxCrossEntropyLoss(), Adam(1e-2), device="cpu")
        traces.append(model.train_epochs(x, y, n_epochs=3, batch_size=32))
    assert traces[0].shape == (3, 4)
    assert torch.isfinite(traces[0]).all()
    assert torch.equal(traces[0], traces[1])
    assert traces[0][-1].mean() < traces[0][0].mean()


def test_same_seed_same_initial_weights():
    seeder.random_seed(11)
    a = params_to_numpy(build_mnist_mlp().params_tree())
    seeder.random_seed(11)
    b = params_to_numpy(build_mnist_mlp().params_tree())
    with seeder.scope(11):
        c = params_to_numpy(build_mnist_mlp().params_tree())
    for la, lb, lc in zip(a, b, c):
        for k in la:
            assert la[k].tobytes() == lb[k].tobytes() == lc[k].tobytes()
    d1 = Dense(4, num_in=3, seed=2).params["w"].numpy()
    d2 = Dense(4, num_in=3, seed=2).params["w"].numpy()
    assert d1.tobytes() == d2.tobytes()


def test_unported_options_raise():
    model = Model(build_mnist_mlp(hidden=NARROW), SoftmaxCrossEntropyLoss(),
                  Adam(1e-3), device="cpu")
    xs, ys = _batches(1)
    with pytest.raises(ValueError, match="DenseStack"):
        model.train_epoch(xs[0], ys[0], fused="stream")
    with pytest.raises(NotImplementedError):
        model.train_step(xs[0], ys[0], accum_steps=2)
    with pytest.raises(NotImplementedError):
        Dense(4, num_in=3, compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        Adam(slot_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam())


def test_lazy_dense_initializes_on_the_model_device():
    from tinynn_autograd_tpu_torch.nn.layers import ReLU
    from tinynn_autograd_tpu_torch.nn.net import Net

    net = Net([Dense(8), ReLU(), Dense(10)])
    model = Model(net, SoftmaxCrossEntropyLoss(), SGD(0.1), device="cpu")
    xs, ys = _batches(1, batch=16)
    loss = model.train_step(xs[0], ys[0])
    assert np.isfinite(float(loss))
    assert net.layers[0].params["w"].shape == (784, 8)


def test_batch_iterator_covers_the_data():
    x = np.arange(10)[:, None].astype(np.float32)
    y = np.arange(10)
    np.random.seed(0)
    seen = [b.targets for b in BatchIterator(batch_size=4)(x, y)]
    assert [len(s) for s in seen] == [4, 4, 2]
    assert sorted(np.concatenate(seen)) == list(range(10))
    kept = list(BatchIterator(batch_size=4, shuffle=False, drop_last=True)(x, y))
    assert [list(b.targets) for b in kept] == [[0, 1, 2, 3], [4, 5, 6, 7]]


INITIALIZERS = {
    "NormalInit": (initializer.NormalInit(1.0, 2.0), 1.0, 2.0, None),
    "TruncatedNormalInit": (initializer.TruncatedNormalInit(0.5, 0.1), 0.5,
                            None, (0.3, 0.7)),
    "UniformInit": (initializer.UniformInit(-2.0, 1.0), -0.5, None,
                    (-2.0, 1.0)),
    "ConstantInit": (initializer.ConstantInit(0.25), 0.25, 0.0, None),
    "ZerosInit": (initializer.ZerosInit(), 0.0, 0.0, None),
    "OnesInit": (initializer.OnesInit(), 1.0, 0.0, None),
    "XavierUniformInit": (initializer.XavierUniformInit(), 0.0,
                          np.sqrt(6.0 / 500) / np.sqrt(3),
                          (-np.sqrt(6.0 / 500), np.sqrt(6.0 / 500))),
    "XavierNormalInit": (initializer.XavierNormalInit(), 0.0,
                         np.sqrt(2.0 / 500), None),
    "HeUniformInit": (initializer.HeUniformInit(), 0.0,
                      np.sqrt(6.0 / 300) / np.sqrt(3),
                      (-np.sqrt(6.0 / 300), np.sqrt(6.0 / 300))),
    "HeNormalInit": (initializer.HeNormalInit(), 0.0, np.sqrt(2.0 / 300),
                     None),
}


@pytest.mark.parametrize("name", sorted(INITIALIZERS))
def test_initializer_statistics(name):
    init, mean, std, bounds = INITIALIZERS[name]
    t = init((300, 200), generator=torch.Generator().manual_seed(0))
    v = t.numpy()
    assert t.requires_grad and v.dtype == np.float32 and v.shape == (300, 200)
    assert abs(v.mean() - mean) < 0.02 * max(1.0, abs(mean))
    if std is not None:
        assert abs(v.std() - std) <= 0.03 * max(std, 1e-3)
    if bounds is not None:
        assert v.min() >= bounds[0] and v.max() <= bounds[1]
