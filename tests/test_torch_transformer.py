"""The transformer classifier of the PyTorch package against the JAX
package's: ``layer_norm_``, ``gelu_``, ``Embedding``, ``PositionalEmbedding``,
``GlobalAvgPool1D``, ``TransformerBlock`` (fused and tape, causal or not, with
a window), ``build_tiny_transformer`` (logits, one step's gradients, five Adam
steps), checkpoints both ways, and the tier ``train_epochs`` takes.

Inputs come from numpy with a seed; parameters are copied from the JAX side
with ``params_from_jax``. Tolerances: rtol 1e-5/atol 1e-6 for values, rtol
1e-5/atol 1e-5 for gradients (f32 sums in other orders), rtol 1e-5 for the
five steps' losses.
"""

import numpy as np
import pytest
import torch

import jax

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu import ops as jops
from tinynn_autograd_tpu.models import build_tiny_transformer as jax_tiny
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.models import build_tiny_transformer
from tinynn_autograd_tpu_torch.nn import layers
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.optimizer import Adam
from tinynn_autograd_tpu_torch.ops import fused_epoch, streaming_epoch
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab=16, seq_len=16, dim=32, heads=4, depth=2)


def _grads_of(tensors):
    return [np.asarray(t.grad) for t in tensors]


def _run_both(fn_jax, fn_torch, arrays, g):
    """(out, grads of the arrays) of fn applied to leaves in each package."""
    results = []
    for tensor, fn in ((JTensor, fn_jax), (Tensor, fn_torch)):
        leaves = [tensor(a, requires_grad=True) for a in arrays]
        out = fn(*leaves)
        out.backward(tensor(g))
        results.append((np.asarray(out.numpy()), _grads_of(leaves)))
    return results


# --------------------------------------------------------------------------
# primitives and small layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["layer_norm", "gelu"])
def test_primitive_matches_jax(op):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 8) * 2).astype(np.float32)
    g = rng.randn(3, 5, 8).astype(np.float32)
    if op == "layer_norm":
        arrays = [x, rng.randn(1, 8).astype(np.float32),
                  rng.randn(1, 8).astype(np.float32)]
        fns = (lambda *a: jops.layer_norm_(*a, eps=1e-5),
               lambda *a: ops.layer_norm_(*a, eps=1e-5))
    else:
        arrays = [x]
        fns = (jops.gelu_, ops.gelu_)
    (jout, jgrads), (tout, tgrads) = _run_both(*fns, arrays, g)
    np.testing.assert_allclose(tout, jout, **TOL)
    for a, b in zip(tgrads, jgrads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def _layer_pair(name):
    """The same layer in both packages, the torch one with the JAX one's
    parameters, and an input for it."""
    rng = np.random.RandomState(1)
    if name == "embedding":
        jl, tl = jlayers.Embedding(10, 6), layers.Embedding(10, 6)
        # repeated ids: their gradients must add up
        x = np.array([[1, 3, 3, 9], [3, 0, 1, 1]])
    elif name == "positional":
        jl, tl = (jlayers.PositionalEmbedding(4, 6),
                  layers.PositionalEmbedding(4, 6))
        x = rng.randn(2, 4, 6).astype(np.float32)
    elif name == "pool":
        jl, tl = jlayers.GlobalAvgPool1D(), layers.GlobalAvgPool1D()
        x = rng.randn(2, 4, 6).astype(np.float32)
    else:
        jl, tl = jlayers.LayerNorm(6), layers.LayerNorm(6)
        x = rng.randn(2, 4, 6).astype(np.float32)
    for k, v in jl.params.items():
        tl.params[k] = Tensor(np.asarray(v.data), requires_grad=True)
    return jl, tl, x


@pytest.mark.parametrize("name", ["embedding", "positional", "pool",
                                  "layer_norm"])
def test_layer_matches_jax(name):
    jl, tl, x = _layer_pair(name)
    assert tl.init_params(x.shape) == tuple(jl.init_params(x.shape))
    float_in = x.dtype == np.float32
    jx = JTensor(x, requires_grad=float_in)
    tx = Tensor(x, requires_grad=float_in)
    jout, tout = jl.forward(jx), tl.forward(tx)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout.numpy()), **TOL)
    g = np.random.RandomState(2).randn(*tout.shape).astype(np.float32)
    jout.backward(JTensor(g))
    tout.backward(g)
    for k in jl.params:
        np.testing.assert_allclose(tl.params[k].grad.numpy(),
                                   np.asarray(jl.params[k].grad),
                                   err_msg=k, **GRAD_TOL)
    if float_in:
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                                   **GRAD_TOL)
    else:  # the embedding: id 3 appears three times, id 1 three times
        grad = tl.params["w"].grad.numpy()
        np.testing.assert_allclose(grad[3], g[0, 1] + g[0, 2] + g[1, 0],
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# TransformerBlock
# --------------------------------------------------------------------------

@pytest.mark.parametrize("attn", ["fused", "tape"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 3)])
def test_transformer_block_matches_jax(attn, causal, window):
    kw = dict(dim=16, num_heads=4, causal=causal, attn=attn,
              attn_window=window)
    jb = jlayers.TransformerBlock(seed=3, **kw)
    tb = layers.TransformerBlock(**kw)
    assert list(tb.params) == list(jb.params)
    for k, v in jb.params.items():
        tb.params[k] = Tensor(np.asarray(v.data), requires_grad=True)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 16).astype(np.float32)
    g = rng.randn(2, 8, 16).astype(np.float32)
    (jout, (jdx,)), (tout, (tdx,)) = _run_both(jb.forward, tb.forward, [x], g)
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(tdx, jdx, **GRAD_TOL)
    for k in jb.params:
        np.testing.assert_allclose(tb.params[k].grad.numpy(),
                                   np.asarray(jb.params[k].grad), err_msg=k,
                                   **GRAD_TOL)


def test_transformer_block_fused_matches_tape():
    blocks = [layers.TransformerBlock(16, 4, causal=True, attn=a, seed=5)
              for a in ("fused", "tape")]
    x = np.random.RandomState(4).randn(2, 8, 16).astype(np.float32)
    outs = [b.forward(Tensor(x)).numpy() for b in blocks]
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


def test_transformer_block_options():
    with pytest.raises(ValueError, match="causal"):
        layers.TransformerBlock(16, 4, attn_window=4)
    with pytest.raises(ValueError, match="attn"):
        layers.TransformerBlock(16, 4, attn="flash")
    with pytest.raises(ValueError, match="multiple"):
        layers.TransformerBlock(18, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.TransformerBlock(16, 4, compute_dtype=torch.bfloat16)
    for kw in (dict(dropout=0.1), dict(attn="tape", attn_dropout=0.1)):
        assert hasattr(layers.TransformerBlock(16, 4, **kw), "set_rng")
    assert not hasattr(layers.TransformerBlock(16, 4), "set_rng")
    # attention dropout runs in TRAIN and is off in TEST
    blk = layers.TransformerBlock(16, 4, causal=True, attn_dropout=0.5,
                                  seed=1)
    x = Tensor(np.random.RandomState(0).randn(2, 8, 16).astype(np.float32))
    train = blk.forward(x).numpy()
    blk.set_phase("TEST")
    test = blk.forward(x).numpy()
    blk.attn_dropout = 0.0
    np.testing.assert_array_equal(blk.forward(x).numpy(), test)
    assert not np.allclose(train, test)


# --------------------------------------------------------------------------
# the classifier
# --------------------------------------------------------------------------

def _pair(causal=False):
    with jax_seeder.scope(2):
        jnet = jax_tiny(causal=causal, **TINY)
    tnet = build_tiny_transformer(causal=causal, **TINY)
    tnet.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    rng = np.random.RandomState(5)
    xs = rng.randint(0, TINY["vocab"], (6, 4, TINY["seq_len"]))
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, (6, 4))]
    return jnet, tnet, xs, ys


def test_build_tiny_transformer_matches_jax_structure():
    jnet, tnet, xs, _ = _pair()
    assert [l.name for l in tnet.layers] == [l.name for l in jnet.layers]
    assert [l.param_shapes for l in tnet.layers] == [
        {k: tuple(v.shape) for k, v in l.params.items()} for l in jnet.layers]
    assert tnet.init((4, 16)) == (4, 10)


@pytest.mark.parametrize("causal", [False, True])
def test_tiny_transformer_logits_and_gradients_match_jax(causal):
    jnet, tnet, xs, ys = _pair(causal)
    logits = []
    for net, tensor, loss in ((jnet, JTensor, JCE()),
                              (tnet, Tensor, SoftmaxCrossEntropyLoss())):
        out = net.forward(tensor(xs[0]))
        logits.append(np.asarray(out.numpy()))
        loss.loss(out, tensor(ys[0])).backward()
    np.testing.assert_allclose(logits[1], logits[0], **TOL)
    for i, (jl, tl) in enumerate(zip(jnet.layers, tnet.layers)):
        for k in jl.params:
            np.testing.assert_allclose(
                tl.params[k].grad.numpy(), np.asarray(jl.params[k].grad),
                err_msg="layer %d %s" % (i, k), **GRAD_TOL)


def _models(causal=True):
    jnet, tnet, xs, ys = _pair(causal)
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


def test_five_adam_steps_match_jax():
    jm, tm, xs, ys = _models()
    jl = [float(jm.train_step(xs[i], ys[i])) for i in range(5)]
    tl = [float(tm.train_step(xs[i], ys[i])) for i in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params_close(jm, tm)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_round_trip(tmp_path, direction):
    jm, tm, xs, ys = _models()
    src, dst = (jm, tm) if direction == "jax_to_torch" else (tm, jm)
    src.train_step(xs[0], ys[0])
    src.train_step(xs[1], ys[1])
    path = str(tmp_path / "ckpt.pkl")
    src.save(path)
    dst.load(path)
    np.testing.assert_allclose(float(dst.train_step(xs[2], ys[2])),
                               float(src.train_step(xs[2], ys[2])), rtol=1e-5)
    _assert_params_close(jm, tm)


def test_auto_takes_the_step_loop_and_the_kernels_tiers_refuse():
    _, tm, xs, ys = _models()
    batch_shape = (4, TINY["seq_len"])
    assert "Embedding" in fused_epoch.unsupported_reason(
        tm.net, tm.net.params_tree(), tm.optimizer, tm.loss, batch_shape)
    assert "DenseStack" in streaming_epoch.unsupported_reason(
        tm.net, tm.optimizer, batch_shape)
    x, y = xs.reshape(-1, TINY["seq_len"]), ys.reshape(-1, 10)
    losses = tm.train_epochs(x, y, n_epochs=2, batch_size=4)
    assert losses.shape == (2, 6) and torch.isfinite(losses).all()
    assert tm.optimizer.state_dict()["t"] == 12
    for fused, match in ((True, "whole-epoch"), ("stream", "streaming")):
        with pytest.raises(ValueError, match=match):
            tm.train_epoch(x, y, batch_size=4, fused=fused)
