"""The recurrent kernels' plain versions, ``lstm_scan_``/``gru_scan_`` and the
recurrent layers of the PyTorch package against the JAX package's.

- The plain versions of K5, K5b, K5c and K5d, both directions, against the
  JAX package's Pallas kernels in interpret mode (B=8, H=128, T=6, as its
  own tests run them), and against a multi-chunk Pallas grid (its VMEM
  budget monkeypatched down). Forward rtol 1e-6/atol 1e-6; gradients rtol
  1e-5/atol 5e-6 (f32 products summed in other orders).
- ``lstm_scan_``/``gru_scan_`` (values and the gradients of x, wx, wh, b, h0
  and c0) against the JAX ones through ``impl="xla"`` at B=3, T=5, D=4, H=6,
  both directions, at the same tolerances.
- The layers (shapes, the last-step slice, the forget bias, lazy init,
  ``Bidirectional``), ``concat_``, and the H100 shape rule (``plan``), which
  is plain Python.

Inputs come from numpy with a seed; parameters are copied from the JAX side.
"""

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu import ops as jops
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.ops import recurrent_kernel as jrk
from tinynn_autograd_tpu.ops.recurrent import gru_scan_ as jgru_scan
from tinynn_autograd_tpu.ops.recurrent import lstm_scan_ as jlstm_scan

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.nn import layers
from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=5e-6)
B, T, D, H = 3, 5, 4, 6
KB, KT, KH = 8, 6, 128  # the Pallas kernels' tiling: B % 8, H % 128


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _close(got, want, tol, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg="%s %d"
                                   % (what, i), **tol)


# --------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def _kernel_inputs(cell, seed, t=KT):
    """The forward's inputs, its Pallas outputs (interpret mode), and the
    backward's inputs derived from them, as numpy arrays."""
    g = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    xp = _rand(rng, t, KB, g * KH, scale=0.5)
    wh = _rand(rng, KH, g * KH, scale=0.3 / np.sqrt(KH) * 4)
    h0 = _rand(rng, KB, KH, scale=0.5)
    c0 = _rand(rng, KB, KH, scale=0.5)
    gt = _rand(rng, t, KB, KH)
    return g, xp, wh, h0, c0, gt


def _shift(seq, first, reverse):
    if reverse:
        return np.concatenate([seq[1:], first[None]], axis=0)
    return np.concatenate([first[None], seq[:-1]], axis=0)


def _check_lstm(seed, reverse, t=KT):
    _, xp, wh, h0, c0, gt = _kernel_inputs("lstm", seed, t)
    want = [np.array(a) for a in jrk.lstm_fwd_pallas(
        xp, wh, h0, c0, reverse=reverse, interpret=True)]
    got = rk.lstm_forward_reference(*map(torch.from_numpy, (xp, wh, h0, c0)),
                                    reverse=reverse)
    _close(got, want, FWD_TOL, "lstm forward")
    hs, cs, gates = want
    cprev = _shift(cs, c0, reverse)
    want = jrk.lstm_bwd_pallas(gt, gates, cs, cprev, wh.T, reverse=reverse,
                               interpret=True)
    got = rk.lstm_backward_reference(
        *map(torch.from_numpy, (gt, gates, cs, cprev)),
        torch.from_numpy(wh).T, reverse=reverse)
    _close(got, want, GRAD_TOL, "lstm backward")


def _check_gru(seed, reverse, t=KT):
    _, ap, wh, h0, _, gt = _kernel_inputs("gru", seed, t)
    want = [np.array(a) for a in jrk.gru_fwd_pallas(
        ap, wh, h0, reverse=reverse, interpret=True)]
    got = rk.gru_forward_reference(*map(torch.from_numpy, (ap, wh, h0)),
                                   reverse=reverse)
    _close(got, want, FWD_TOL, "gru forward")
    hs, gates, un = want
    hprev = _shift(hs, h0, reverse)
    want = jrk.gru_bwd_pallas(gt, hprev, gates, un, wh.T, reverse=reverse,
                              interpret=True)
    got = rk.gru_backward_reference(
        *map(torch.from_numpy, (gt, hprev, gates, un)),
        torch.from_numpy(wh).T, reverse=reverse)
    _close(got, want, GRAD_TOL, "gru backward")


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_plain_kernels_match_pallas(reverse):
    _check_lstm(21, reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_plain_kernels_match_pallas(reverse):
    _check_gru(23, reverse)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_kernels_match_a_multi_chunk_pallas_grid(cell, monkeypatch):
    t = 12
    # a budget that leaves room for a chunk of 3 steps of the widest stream
    monkeypatch.setattr(jrk, "_VMEM_BUDGET", 2 * 3 * 12 * KB * KH * 4
                        + KH * 4 * KH * 4 + 4 * KB * KH * 4)
    assert jrk._pick_chunk(t, KB, KH, n_streams=12) < t
    (_check_lstm if cell == "lstm" else _check_gru)(22, False, t)


# --------------------------------------------------------------------------
# the scan primitives against the JAX package's XLA scans
# --------------------------------------------------------------------------

def _scan_pair(cell, reverse, seed):
    g = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    arrays = [_rand(rng, B, T, D), _rand(rng, D, g * H, scale=0.4),
              _rand(rng, H, g * H, scale=0.4), _rand(rng, 1, g * H, scale=0.1),
              _rand(rng, B, H, scale=0.5)]
    if cell == "lstm":
        arrays.append(_rand(rng, B, H, scale=0.5))
    cot = _rand(rng, B, T, H)
    results = []
    for tensor, scan, kw in (
            (JTensor, jlstm_scan if cell == "lstm" else jgru_scan,
             dict(impl="xla")),
            (Tensor, ops.lstm_scan_ if cell == "lstm" else ops.gru_scan_,
             {})):
        leaves = [tensor(a, requires_grad=True) for a in arrays]
        states = dict(zip(("h0", "c0"), leaves[4:]))
        out = scan(*leaves[:4], reverse=reverse, **states, **kw)
        out.backward(tensor(cot))
        results.append((_np(out.numpy()), [_np(t.grad) for t in leaves]))
    return results


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scan_values_and_every_gradient_match_jax(cell, reverse):
    (jout, jgrads), (tout, tgrads) = _scan_pair(cell, reverse, 31)
    np.testing.assert_allclose(tout, jout, **FWD_TOL)
    names = ["x", "wx", "wh", "b", "h0", "c0"]
    for name, got, want in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_scan_without_states_and_without_input_gradient():
    rng = np.random.default_rng(5)
    x, wx = _rand(rng, B, T, D), _rand(rng, D, 4 * H, scale=0.4)
    wh, b = _rand(rng, H, 4 * H, scale=0.4), _rand(rng, 1, 4 * H)
    jt = [JTensor(a, requires_grad=True) for a in (wx, wh, b)]
    tt = [Tensor(a, requires_grad=True) for a in (wx, wh, b)]
    jout = jlstm_scan(JTensor(x), *jt, impl="xla")
    tout = ops.lstm_scan_(Tensor(x), *tt)
    np.testing.assert_allclose(_np(tout.numpy()), _np(jout.numpy()), **FWD_TOL)
    cot = _rand(rng, B, T, H)
    jout.backward(JTensor(cot))
    tout.backward(Tensor(cot))
    _close([t.grad for t in tt], [_np(t.grad) for t in jt], GRAD_TOL)


def test_scan_rejects_an_unknown_impl_and_bad_shapes():
    x = Tensor(np.zeros((B, T, D), np.float32))
    wx = Tensor(np.zeros((D, 4 * H), np.float32))
    wh = Tensor(np.zeros((H, 4 * H), np.float32))
    b = Tensor(np.zeros((1, 4 * H), np.float32))
    with pytest.raises(ValueError, match="impl"):
        ops.lstm_scan_(x, wx, wh, b, impl="xla")
    with pytest.raises(ValueError, match="wh"):
        ops.gru_scan_(x, Tensor(np.zeros((D, 3 * H), np.float32)), wh, b)


# --------------------------------------------------------------------------
# the wrappers and the H100 shape rule (plain Python, no card needed)
# --------------------------------------------------------------------------

def _one_wave(cluster, rows):
    """An occupancy of 132 blocks (the H100's SMs), one a SM."""
    return 132 // cluster


@pytest.mark.parametrize("cell,backward,b,h,fit,want", [
    ("lstm", False, 64, 256, _one_wave, (8, 4)),  # config 8: 16 clusters
    ("lstm", True, 64, 256, _one_wave, (8, 4)),
    ("lstm", False, 64, 256, lambda c, r: 14, (8, 5)),  # 14 fit: 13 of 5
    ("gru", False, 64, 256, _one_wave, (4, 2)),   # the GRU at config 8
    ("gru", True, 64, 256, _one_wave, (4, 2)),
    ("lstm", False, 128, 64, _one_wave, (1, 1)),  # examples/rnn/run_torch.py
    ("gru", True, 128, 64, _one_wave, (1, 1)),
    ("lstm", False, 3, 100, _one_wave, (1, 1)),   # ragged B and H
    ("lstm", True, 1, 328, _one_wave, (8, 1)),    # the LSTM's widest H
    ("gru", True, 2000, 32, _one_wave, (1, 8)),   # 8 rows a cluster, 2 waves
])
def test_plan_picks_clusters_and_rows(cell, backward, b, h, fit, want):
    assert rk.plan(cell, backward, b, h, fit) == want


def test_shape_rule_names_the_limit():
    assert rk.max_hidden("lstm") == 328 and rk.max_hidden("gru") == 384
    assert rk.supports("lstm", 256) and not rk.supports("lstm", 329)
    assert rk.supports("gru", 384) and not rk.supports("gru", 385)
    with pytest.raises(ValueError, match="H <= 328"):
        rk.plan("lstm", False, 64, 512, _one_wave)
    # 329 would fit the forward alone, which then could not be trained
    with pytest.raises(ValueError, match="H <= 328"):
        rk.plan("lstm", False, 1, 329, _one_wave)
    for cell in ("lstm", "gru"):
        for backward in (False, True):
            for h in (1, 7, 100, 129, rk.max_hidden(cell)):
                for b in (1, 64, 1000):
                    cluster, rows = rk.plan(cell, backward, b, h, _one_wave)
                    units, smem = rk._layout(h, rk.GATES[cell], backward,
                                             cluster, rows)
                    assert smem <= rk.SMEM_LIMIT
                    assert units * rows <= rk.THREADS


def test_wrappers_refuse_cpu_tensors():
    xp = torch.zeros((2, 3, 4 * 5))
    wh, h0 = torch.zeros((5, 20)), torch.zeros((3, 5))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rk.cuda_lstm_forward(xp, wh, h0, h0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rk.cuda_gru_backward(torch.zeros((2, 3, 5)), torch.zeros((2, 3, 5)),
                             torch.zeros((2, 3, 15)), torch.zeros((2, 3, 5)),
                             torch.zeros((15, 5)))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_concat_matches_jax():
    rng = np.random.default_rng(2)
    arrays = [_rand(rng, 2, 3), _rand(rng, 2, 5)]
    cot = _rand(rng, 2, 8)
    results = []
    for tensor, op in ((JTensor, jops.concat_), (Tensor, ops.concat_)):
        leaves = [tensor(a, requires_grad=True) for a in arrays]
        out = op(leaves, axis=-1)
        out.backward(tensor(cot))
        results.append([_np(out.numpy())] + [_np(t.grad) for t in leaves])
    _close(results[1], results[0], dict(rtol=0, atol=0))


def _layer_pair(make, seed=11):
    """A JAX-package layer, the port's twin with its parameters, and an
    input."""
    jl = make(jlayers)
    tl = make(layers)
    x = _rand(np.random.default_rng(seed), B, T, D)
    jl.forward(JTensor(x))
    tl.forward(Tensor(x))  # lazy init, then overwritten
    for k, v in jl.params.items():
        tl.params[k] = Tensor(np.asarray(v.data), requires_grad=True)
    return jl, tl, x


@pytest.mark.parametrize("name", ["lstm_last", "lstm_seq", "gru_last",
                                  "gru_seq", "lstm_reverse", "bi_lstm",
                                  "bi_gru_seq"])
def test_layer_matches_jax(name):
    cell = "LSTM" if "lstm" in name else "GRU"
    seq = "seq" in name

    def make(mod):
        layer = getattr(mod, cell)(H, return_sequences=seq, seed=3,
                                   reverse=name == "lstm_reverse")
        return mod.Bidirectional(layer) if name.startswith("bi") else layer

    jl, tl, x = _layer_pair(make)
    jt, tt = JTensor(x, requires_grad=True), Tensor(x, requires_grad=True)
    jout, tout = jl.forward(jt), tl.forward(tt)
    np.testing.assert_allclose(_np(tout.numpy()), _np(jout.numpy()),
                               **FWD_TOL)
    cot = _rand(np.random.default_rng(4), *jout.shape)
    jout.backward(JTensor(cot))
    tout.backward(Tensor(cot))
    np.testing.assert_allclose(_np(tt.grad), _np(jt.grad), **GRAD_TOL)
    for k in jl.params.keys():
        np.testing.assert_allclose(_np(tl.params[k].grad),
                                   _np(jl.params[k].grad), err_msg=k,
                                   **GRAD_TOL)


def test_layer_shapes_and_last_step_slice():
    x = Tensor(_rand(np.random.default_rng(0), B, T, D))
    seq = layers.LSTM(H, num_in=D, return_sequences=True, seed=11)
    last = layers.LSTM(H, num_in=D, seed=11)
    out_seq, out_last = seq.forward(x), last.forward(x)
    assert out_seq.shape == (B, T, H) and out_last.shape == (B, H)
    np.testing.assert_array_equal(out_seq.numpy()[:, -1], out_last.numpy())
    rev_seq = layers.GRU(H, num_in=D, return_sequences=True, seed=2,
                         reverse=True)
    rev_last = layers.GRU(H, num_in=D, seed=2, reverse=True)
    # a reverse cell's final state sits at position 0
    np.testing.assert_array_equal(rev_seq.forward(x).numpy()[:, 0],
                                  rev_last.forward(x).numpy())
    assert seq.init_params((B, T, D)) == (B, T, H)
    assert last.init_params((B, T, D)) == (B, H)
    # impl="plain" asks for the plain versions (what a CPU tensor runs
    # anyway); a Bidirectional twin inherits it
    plain = layers.LSTM(H, num_in=D, seed=11, impl="plain")
    np.testing.assert_array_equal(plain.forward(x).numpy(), out_last.numpy())
    assert layers.Bidirectional(plain).bwd.impl == "plain"


def test_lstm_forget_bias_and_parameter_shapes():
    lstm = layers.LSTM(H, num_in=D, seed=5)
    bias = lstm.params["b"].numpy()[0]
    np.testing.assert_array_equal(bias[H:2 * H], 1.0)
    np.testing.assert_array_equal(np.delete(bias, np.s_[H:2 * H]), 0.0)
    assert lstm.param_shapes == {"wx": (D, 4 * H), "wh": (H, 4 * H),
                                 "b": (1, 4 * H)}
    gru = layers.GRU(H, num_in=D, seed=5)
    np.testing.assert_array_equal(gru.params["b"].numpy(), 0.0)
    assert gru.param_shapes["wh"] == (H, 3 * H)


def test_lazy_init_from_first_input():
    gru = layers.GRU(H, seed=6)
    assert not gru.is_init
    out = gru.forward(Tensor(np.ones((2, 3, 7), np.float32)))
    assert gru.is_init and gru.params["wx"].shape == (7, 3 * H)
    assert out.shape == (2, H)
    a, b = layers.LSTM(H, seed=6), layers.LSTM(H, seed=6)
    a.init_params((2, 3, 7))
    b.forward(Tensor(np.ones((2, 3, 7), np.float32)))
    for k in a.params:
        np.testing.assert_array_equal(a.params[k].numpy(),
                                      b.params[k].numpy())


def test_bidirectional_semantics():
    x = Tensor(_rand(np.random.default_rng(1), B, T, D))
    bi = layers.Bidirectional(layers.LSTM(H, num_in=D, seed=8))
    assert bi.bwd.reverse and bi.bwd._seed == 8 + 0x9E37
    assert bi.name == "Bidirectional(LSTM)"
    out = bi.forward(x).numpy()
    assert out.shape == (B, 2 * H)
    np.testing.assert_array_equal(out[:, :H], bi.fwd.forward(x).numpy())
    np.testing.assert_array_equal(out[:, H:], bi.bwd.forward(x).numpy())
    assert bi.init_params((B, T, D)) == (B, 2 * H)
    seq = layers.Bidirectional(layers.GRU(H, return_sequences=True, seed=1))
    assert not seq.is_init
    assert seq.forward(x).shape == (B, T, 2 * H) and seq.is_init
    # the merged parameter view writes through to the direction layers
    keys = ["f_wx", "f_wh", "f_b", "b_wx", "b_wh", "b_b"]
    assert list(bi.params.keys()) == keys
    new = Tensor(np.zeros((1, 4 * H), np.float32), requires_grad=True)
    bi.params["b_b"] = new
    assert bi.bwd.params["b"] is new and bi.params["b_b"] is new
    bi._is_init = False
    assert not bi.fwd._is_init and not bi.bwd._is_init


def test_bidirectional_refusals():
    with pytest.raises(ValueError, match="reverse=False"):
        layers.Bidirectional(layers.LSTM(H, reverse=True))
    with pytest.raises(ValueError, match="reverse=True"):
        layers.Bidirectional(layers.LSTM(H), layers.LSTM(H))
    with pytest.raises(ValueError, match="return_sequences"):
        layers.Bidirectional(layers.LSTM(H),
                             layers.LSTM(H, return_sequences=True,
                                         reverse=True))
