"""The recurrent sequence classifier of the PyTorch package against the JAX
package's: ``build_rnn_classifier`` (LSTM and GRU, hidden (8, 8)) and a
``Bidirectional`` net, each with its parameters copied by
``params_from_jax``: five Adam steps (losses within rtol 1e-5/atol 1e-6,
parameters within rtol 1e-4/atol 1e-5), checkpoints both ways, the tier
``train_epochs`` takes, ``MSELoss``, and ``examples/rnn/run_torch.py`` on
the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu.models import build_rnn_classifier as jax_rnn
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn.losses import MSELoss as JMSE
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.net import Net as JNet
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch import Tensor
from tinynn_autograd_tpu_torch.models import build_rnn_classifier
from tinynn_autograd_tpu_torch.nn import layers
from tinynn_autograd_tpu_torch.nn.losses import MSELoss, SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.nn.optimizer import Adam
from tinynn_autograd_tpu_torch.ops import fused_epoch, streaming_epoch
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
D, T, NOUT, BATCH = 4, 6, 5, 4


def _bi_net(mod, net_cls):
    return net_cls([mod.Bidirectional(mod.GRU(8, num_in=D, seed=4)),
                    mod.Dense(NOUT, num_in=16, seed=5)])


def _pair(kind):
    """The JAX net, the port's twin with its parameters, and 6 batches."""
    with jax_seeder.scope(2):
        if kind == "bi":
            jnet = _bi_net(jlayers, JNet)
        else:
            jnet = jax_rnn(D, NOUT, hidden=(8, 8), cell=kind, seed=7)
    tnet = (_bi_net(layers, Net) if kind == "bi"
            else build_rnn_classifier(D, NOUT, hidden=(8, 8), cell=kind,
                                      seed=7))
    tnet.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    rng = np.random.RandomState(5)
    xs = rng.randn(6, BATCH, T, D).astype(np.float32)
    ys = np.eye(NOUT, dtype=np.float32)[rng.randint(0, NOUT, (6, BATCH))]
    return jnet, tnet, xs, ys


def _models(kind):
    jnet, tnet, xs, ys = _pair(kind)
    jm = JModel(jnet, JCE(), jopt.Adam(1e-3))
    tm = Model(tnet, SoftmaxCrossEntropyLoss(), Adam(1e-3), device="cpu")
    return jm, tm, xs, ys


def _assert_params_close(jm, tm):
    jp = jax.tree.map(np.asarray, jm.net.params_tree())
    for a, b in zip(jp, params_to_numpy(tm.net.params_tree())):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["lstm", "gru", "bi"])
def test_structure_matches_jax(kind):
    jnet, tnet, _, _ = _pair(kind)
    assert [l.name for l in tnet.layers] == [l.name for l in jnet.layers]
    assert [dict(l.param_shapes) for l in tnet.layers] == [
        {k: tuple(v.shape) for k, v in l.params.items()} for l in jnet.layers]
    assert tnet.init((BATCH, T, D)) == (BATCH, NOUT)


@pytest.mark.parametrize("kind", ["lstm", "gru", "bi"])
def test_five_adam_steps_match_jax(kind):
    jm, tm, xs, ys = _models(kind)
    jl = [float(jm.train_step(xs[i], ys[i])) for i in range(5)]
    tl = [float(tm.train_step(xs[i], ys[i])) for i in range(5)]
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_params_close(jm, tm)


@pytest.mark.parametrize("kind", ["lstm", "bi"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_round_trip(tmp_path, kind, direction):
    jm, tm, xs, ys = _models(kind)
    src, dst = (jm, tm) if direction == "jax_to_torch" else (tm, jm)
    src.train_step(xs[0], ys[0])
    src.train_step(xs[1], ys[1])
    path = str(tmp_path / "ckpt.pkl")
    src.save(path)
    dst.load(path)
    np.testing.assert_allclose(float(dst.train_step(xs[2], ys[2])),
                               float(src.train_step(xs[2], ys[2])), rtol=1e-5)
    _assert_params_close(jm, tm)


def test_checkpoint_into_a_lazy_bidirectional_net(tmp_path):
    jm, tm, xs, ys = _models("bi")
    jm.train_step(xs[0], ys[0])
    path = str(tmp_path / "ckpt.pkl")
    jm.save(path)
    lazy = Model(Net([layers.Bidirectional(layers.GRU(8, seed=1)),
                      layers.Dense(NOUT, seed=2)]),
                 SoftmaxCrossEntropyLoss(), Adam(1e-3), device="cpu")
    lazy.load(path)
    assert lazy.net.is_init
    np.testing.assert_allclose(float(lazy.train_step(xs[1], ys[1])),
                               float(jm.train_step(xs[1], ys[1])), rtol=1e-5)


@pytest.mark.parametrize("kind", ["lstm", "bi"])
def test_auto_takes_the_step_loop_and_the_kernels_tiers_refuse(kind):
    _, tm, xs, ys = _models(kind)
    batch_shape = (BATCH, T, D)
    reason = fused_epoch.unsupported_reason(
        tm.net, tm.net.params_tree(), tm.optimizer, tm.loss, batch_shape)
    assert "is not Dense" in reason
    assert "DenseStack" in streaming_epoch.unsupported_reason(
        tm.net, tm.optimizer, batch_shape)
    x, y = xs.reshape(-1, T, D), ys.reshape(-1, NOUT)
    losses = tm.train_epochs(x, y, n_epochs=2, batch_size=BATCH)
    assert losses.shape == (2, 6) and torch.isfinite(losses).all()
    assert tm.optimizer.state_dict()["t"] == 12
    for fused, match in ((True, "whole-epoch"), ("stream", "streaming")):
        with pytest.raises(ValueError, match=match):
            tm.train_epoch(x, y, batch_size=BATCH, fused=fused)


def test_mse_loss_matches_jax():
    rng = np.random.RandomState(3)
    pred, target = rng.randn(6, 2).astype(np.float32), rng.randn(6, 2)
    results = []
    for tensor, loss in ((JTensor, JMSE()), (Tensor, MSELoss())):
        p = tensor(pred, requires_grad=True)
        out = loss.loss(p, target.astype(np.float32))
        out.backward()
        results.append((float(np.asarray(out.numpy())),
                        np.asarray(p.grad)))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--cell", "gru", "--bi"]])
def test_example_runs_on_the_cpu(extra):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "rnn", "run_torch.py"),
         "--device", "cpu", "--steps", "3", "--seq_len", "8", "--hidden",
         "8", "--batch", "16"] + extra,
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert "step    2" in out.stdout and "eval mse" in out.stdout
