"""The mixture-of-experts language model of the PyTorch package (the
Mellum 2 layout) on the CPU at a small cut.

- ``rms_norm_``, ``silu_`` and the default ``rope_`` against the JAX
  package's primitives (values and gradients);
- ``rope_tables``' plain and YaRN tables against their closed form,
  written out here in numpy float64;
- the VJPs of ``rms_norm_``, ``silu_``, ``rope_``, the routing ops and
  ``grouped_swiglu_`` against central finite differences of the forward
  (a random direction a leaf, f32);
- ``build_moe_lm`` at the benchmark family's small cut against the plain
  reference (``bench_torch/reference/mellum2.py``) on seeded weights:
  logits, loss and every gradient; one Adam step's loss, and its step as
  the reference's Adam on the port's gradient;
- the expert-parallel share: the held parts of disjoint shares of the
  experts add up to the reference's layer with every expert held;
- the layers' options and refusals, the next-token loss, and the spans and
  counters an expert layer records.

Tolerances: rtol 1e-5/atol 1e-6 for values and 1e-5/1e-5 for gradients
against JAX (f32 sums in other orders); against the reference, the logits
and each gradient leaf within 2e-6 and 2e-5 of its largest entry (four
layers of f32 sums in other orders), the leaves after the Adam step
within rtol 5e-7, atol 1e-8 (a few ulps: the update in another order); the
finite differences' 2e-3 of the directional derivative (f32 forwards at
a step of 1e-2).
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu import Tensor as JTensor
from tinynn_autograd_tpu import ops as jops

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.models import build_moe_lm
from tinynn_autograd_tpu_torch.nn import layers
from tinynn_autograd_tpu_torch.nn.losses import (
    SoftmaxCrossEntropyLoss, SparseSoftmaxCrossEntropyLoss,
)
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.ops import fused_epoch
from tinynn_autograd_tpu_torch.utils import profiler

_BENCH = Path(__file__).resolve().parents[1] / "bench_torch"
if str(_BENCH) not in sys.path:
    sys.path.append(str(_BENCH))

from harness import inputs, manifest, program  # noqa: E402
from reference import common  # noqa: E402
from reference import mellum2 as ref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
YARN = dict(rope_type="yarn", rope_theta=500000, factor=16,
            original_max_position_embeddings=8192, beta_fast=32, beta_slow=1,
            attention_factor=1.2772588722239782)
SEED = 2 ** 31 + 5


def _small():
    """The benchmark family's CPU cut of the cell: (config, traffic)."""
    bench = manifest.load()
    cell = manifest.cell(bench, "mellum2_12b.train_t8192")
    config = manifest.config(bench, cell["config"])
    return program.family(config).small(config,
                                        manifest.traffic(cell["traffic"]))


# --------------------------------------------------------------------------
# primitives against the JAX package
# --------------------------------------------------------------------------

def _run_both(fn_jax, fn_torch, arrays, g):
    results = []
    for tensor, fn in ((JTensor, fn_jax), (Tensor, fn_torch)):
        leaves = [tensor(a, requires_grad=True) for a in arrays]
        out = fn(*leaves)
        out.backward(tensor(g))
        results.append((np.asarray(out.numpy()),
                        [np.asarray(t.grad) for t in leaves]))
    return results


@pytest.mark.parametrize("op", ["rms_norm", "silu", "rope"])
def test_primitive_matches_jax(op):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3, 16, 8) * 2).astype(np.float32)
    g = rng.randn(2, 3, 16, 8).astype(np.float32)
    arrays = [x]
    if op == "rms_norm":
        arrays.append(rng.randn(1, 8).astype(np.float32))
        fns = (lambda *a: jops.rms_norm_(*a, eps=1e-6),
               lambda *a: ops.rms_norm_(*a, eps=1e-6))
    elif op == "silu":
        fns = (jops.silu_, ops.silu_)
    else:
        cos, sin = ops.rope_tables(16, 8, 10000.0)
        fns = (lambda a: jops.rope_(a, base=10000.0),
               lambda a: ops.rope_(a, cos, sin))
    (jout, jgrads), (tout, tgrads) = _run_both(*fns, arrays, g)
    np.testing.assert_allclose(tout, jout, **TOL)
    for a, b in zip(tgrads, jgrads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)


# --------------------------------------------------------------------------
# the rotary tables against their closed form
# --------------------------------------------------------------------------

def _closed_form(t, d, theta, yarn):
    i = np.arange(d // 2, dtype=np.float64)
    freq = theta ** (-2.0 * i / d)
    scale = 1.0
    if yarn:
        def c(r):
            return d * np.log(8192 / (2 * np.pi * r)) / (2 * np.log(theta))

        low = min(max(np.floor(c(32)), 0), d - 1)
        high = min(max(np.ceil(c(1)), 0), d - 1)
        m = 1 - np.clip((i - low) / (high - low), 0, 1)
        freq = freq / 16 * (1 - m) + freq * m
        scale = YARN["attention_factor"]
    angle = np.arange(t, dtype=np.float64)[:, None] * freq[None, :]
    return np.cos(angle) * scale, np.sin(angle) * scale


@pytest.mark.parametrize("yarn", [False, True])
def test_rope_tables_closed_form(yarn):
    t, d, theta = 8192, 128, 500000.0
    cos, sin = ops.rope_tables(t, d, theta, YARN if yarn else None)
    want_cos, want_sin = _closed_form(t, d, theta, yarn)
    assert cos.dtype == torch.float32 and cos.shape == (t, d // 2)
    np.testing.assert_allclose(cos.numpy(), want_cos, rtol=0, atol=2e-7)
    np.testing.assert_allclose(sin.numpy(), want_sin, rtol=0, atol=2e-7)


def test_yarn_interpolates_the_low_frequencies():
    """YaRN at Mellum 2's parameters: the dims below 18 rotate as plain
    RoPE, those from 35 at 1/16 of its frequency, those between on the
    ramp; every entry scaled by the attention factor."""
    cos, sin = ops.rope_tables(2, 128, 500000.0)
    ycos, ysin = ops.rope_tables(2, 128, 500000.0, YARN)
    angle = torch.atan2(sin[1], cos[1]).double()
    yangle = torch.atan2(ysin[1], ycos[1]).double()
    s = YARN["attention_factor"]
    np.testing.assert_allclose(torch.hypot(ycos, ysin).numpy(), s, rtol=1e-6)
    np.testing.assert_allclose(yangle[:19], angle[:19], rtol=1e-6)
    np.testing.assert_allclose(yangle[35:], angle[35:] / 16, rtol=1e-5)
    ratio = (yangle[19:35] / angle[19:35]).numpy()
    assert np.all(np.diff(ratio) < 0)
    assert 1 / 16 < ratio.min() < ratio.max() < 1


def test_reference_tables_agree_with_the_port():
    """The reference builds its tables by itself (HF's full-width form);
    both halves of each equal the port's."""
    config, _ = _small()
    config = dict(config, head_dim=128)
    for kind, yarn in (("sliding_attention", None),
                       ("full_attention", YARN)):
        rcos, rsin = ref.rotary(config, kind, 300, "cpu")
        cos, sin = ops.rope_tables(300, 128, 500000.0, yarn)
        for got, want in ((rcos, cos), (rsin, sin)):
            assert torch.equal(got[:, :64], want)
            assert torch.equal(got[:, 64:], want)


# --------------------------------------------------------------------------
# VJPs by finite differences
# --------------------------------------------------------------------------

def _fd_check(fn, arrays, seed=0, h=1e-2):
    """<the VJP of a random cotangent w, a random direction v> against the
    central difference of <w, fn> along v, for each array."""
    rng = np.random.RandomState(seed)
    leaves = [Tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    w = rng.randn(*out.shape).astype(np.float32)
    out.backward(Tensor(w))
    for i, a in enumerate(arrays):
        v = rng.randn(*a.shape).astype(np.float32)

        def value(step):
            moved = [Tensor(b + step * v if j == i else b)
                     for j, b in enumerate(arrays)]
            return float((fn(*moved).data.double() * torch.from_numpy(
                w).double()).sum())

        numeric = (value(h) - value(-h)) / (2 * h)
        analytic = float((leaves[i].grad.double()
                          * torch.from_numpy(v).double()).sum())
        assert analytic == pytest.approx(numeric, rel=2e-3, abs=1e-3), i


def test_rms_norm_vjp_by_finite_differences():
    rng = np.random.RandomState(2)
    _fd_check(lambda x, g: ops.rms_norm_(x, g, eps=1e-6),
              [rng.randn(6, 16).astype(np.float32),
               rng.randn(1, 16).astype(np.float32)])


def test_silu_vjp_by_finite_differences():
    _fd_check(ops.silu_, [np.random.RandomState(3).randn(5, 7).astype(
        np.float32) * 3])


@pytest.mark.parametrize("yarn", [None, YARN])
def test_rope_vjp_by_finite_differences(yarn):
    cos, sin = ops.rope_tables(9, 16, 500000.0, yarn)
    _fd_check(lambda x: ops.rope_(x, cos[:, None, :], sin[:, None, :]),
              [np.random.RandomState(4).randn(2, 9, 3, 16).astype(
                  np.float32)])


def test_routing_ops_vjps_by_finite_differences():
    rng = np.random.RandomState(5)
    x = rng.randn(6, 8).astype(np.float32)
    top = ops.top_k_(Tensor(x), 3)
    assert torch.equal(top, torch.topk(torch.from_numpy(x), 3).indices)
    _fd_check(lambda a: ops.take_along_axis_(ops.softmax_(a), top), [x])
    rows = torch.tensor([4, 0, 4, 2, 5])
    _fd_check(lambda a: ops.gather_rows_(a, rows), [x])
    _fd_check(lambda a: ops.scatter_add_rows_(a, rows, 7), [x[:5]])
    # rows that share an index sum in the forward and share the gradient
    out = ops.scatter_add_rows_(Tensor(x[:5]), rows, 7).data
    np.testing.assert_allclose(out[4].numpy(), x[0] + x[2], rtol=1e-6)
    assert float(out[1].abs().sum()) == 0.0


def _experts(rng, d, f, n):
    return [[rng.randn(*shape).astype(np.float32) * 0.3
             for shape in ((d, f), (d, f), (f, d))] for _ in range(n)]


@pytest.mark.parametrize("counts", [(3, 4, 2), (0, 5, 4)])
def test_grouped_swiglu_vjp_by_finite_differences(counts):
    rng = np.random.RandomState(6)
    d, f = 8, 6
    weights = [w for triple in _experts(rng, d, f, 3) for w in triple]
    x = rng.randn(sum(counts), d).astype(np.float32)

    def fn(xs, *ws):
        return ops.grouped_swiglu_(xs, counts, [ws[i:i + 3]
                                                for i in range(0, 9, 3)])

    _fd_check(fn, [x] + weights)


def test_grouped_swiglu_is_each_experts_swiglu():
    rng = np.random.RandomState(7)
    d, f, counts = 8, 6, (2, 0, 3)
    experts = _experts(rng, d, f, 3)
    x = rng.randn(5, d).astype(np.float32)
    out = ops.grouped_swiglu_(Tensor(x), counts, [
        [Tensor(w) for w in triple] for triple in experts]).data
    bounds = np.cumsum((0,) + counts)
    for (gate, up, down), lo, hi in zip(experts, bounds[:-1], bounds[1:]):
        xj = torch.from_numpy(x[lo:hi])
        want = (torch.nn.functional.silu(xj @ torch.from_numpy(gate))
                * (xj @ torch.from_numpy(up))) @ torch.from_numpy(down)
        np.testing.assert_allclose(out[lo:hi].numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="do not cover"):
        ops.grouped_swiglu_(Tensor(x), (2, 2, 2), [
            [Tensor(w) for w in triple] for triple in experts])


# --------------------------------------------------------------------------
# the model against the plain reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The small cut's model on seeded weights (the benchmark's laws), its
    data and the same weights for the reference."""
    config, traffic = _small()
    # every matrix drawn, the attention's output projection too (the
    # benchmark starts it at zero), so that every gradient is compared
    spec = [(name, shape, "xavier" if law == "zeros" else law)
            for name, shape, law in ref.param_spec(config, traffic)]
    params = inputs.make_params(spec, SEED, "cpu")
    data = inputs.make_data(config, traffic, SEED, "cpu")
    return config, traffic, params, data


def _model(setup):
    config, traffic, params, _ = setup
    return program.build(config, traffic, params, SEED, "cpu")


def test_the_net_holds_the_references_leaves(setup):
    config, traffic, params, _ = setup
    net = _model(setup).net
    assert [type(layer).__name__ for layer in net.layers] == (
        ["Embedding"] + ["AttentionBlock", "TokenChoiceMoE"] * 4
        + ["RMSNorm", "Dense"])
    assert [layer.window for layer in net.layers[1:9:2]] == [4, 4, 4, None]
    assert [layer.yarn is not None for layer in net.layers[1:9:2]] == [
        False, False, False, True]
    assert set(net.layers[2].params) == {"g", "wr"} | {
        "e%d_%s" % (j, w) for j in range(4) for w in ("gate", "up", "down")}
    assert "b" not in net.layers[-1].params


def test_logits_loss_and_gradients_match_the_reference(setup):
    config, _, params, data = setup
    x, y = data["x"][:4], data["y"][:4]
    model = _model(setup)
    logits = model.net.forward(Tensor(x))
    loss = model.loss.loss(logits, Tensor(y))
    loss.backward()
    got = {"%d.%s" % (i, k): v.grad for i, layer in
           enumerate(model.net.layers) for k, v in layer.params.items()}

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want_logits = ref.forward(p, config, x, "f32")
    want_loss = ref.loss(want_logits, y)
    want = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()))))
    scale = float(want_logits.detach().abs().max())
    np.testing.assert_allclose(logits.data.numpy() / scale,
                               want_logits.detach().numpy() / scale, rtol=0,
                               atol=2e-6)
    assert float(loss.data) == pytest.approx(float(want_loss.detach()),
                                             rel=1e-6)
    assert set(got) == set(want)
    for name, g in want.items():
        scale = float(g.abs().max()) or 1.0
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   g.numpy() / scale, rtol=0, atol=2e-5,
                                   err_msg=name)
    # every held expert of every layer took tokens and a gradient
    assert all(float(got["%d.e%d_gate" % (2 + 2 * l, j)].abs().sum()) > 0
               for l in range(4) for j in range(4))


def test_one_adam_step_matches_the_reference(setup):
    """``train_step``'s loss is the reference's, and its step of each leaf
    is the reference's Adam step (``common.adam_``) on the port's own
    gradient, which the test above holds to the reference's: an element
    whose gradient lies within rounding of 0 steps either way under Adam's
    first, sign-like step."""
    config, _, params, data = setup
    x, y = data["x"][:4], data["y"][:4]
    model = _model(setup)
    model.loss.loss(model.net.forward(Tensor(x)), Tensor(y)).backward()
    grads = {"%d.%s" % (i, k): v.grad for i, layer in
             enumerate(model.net.layers) for k, v in layer.params.items()}
    model = _model(setup)
    loss = float(model.train_step(x, y))
    want = common.train_readings(
        lambda p, xb, prec: ref.forward(p, config, xb, prec), ref.loss,
        params, [(x, y)], config["optimizer"])
    assert loss == pytest.approx(want["losses"][0], rel=1e-6)
    for name, leaf in program.leaves(model).items():
        stepped = params[name].clone()
        common.adam_(stepped, grads[name], torch.zeros_like(stepped),
                     torch.zeros_like(stepped), 1, config["optimizer"])
        np.testing.assert_allclose(leaf.numpy(), stepped.numpy(),
                                   rtol=5e-7, atol=1e-8, err_msg=name)


def test_expert_shares_add_up_to_the_whole_layer():
    """Two layers holding experts 0-3 and 4-7 of one router (a two-way
    expert-parallel split) give parts that add up to the reference's
    layer with all eight experts held; each part is zero on the tokens
    none of its experts takes."""
    config, _ = _small()
    rng = np.random.RandomState(8)
    whole = layers.TokenChoiceMoE(64, 24, 8, 3)
    shares = [layers.TokenChoiceMoE(64, 24, 8, 3, experts_held=held)
              for held in (range(4), range(4, 8))]
    for share in shares:
        for k in share.params:
            share.params[k] = whole.params[k]
    xn = torch.from_numpy(rng.randn(40, 64).astype(np.float32))
    parts = [share.experts_part(Tensor(xn)).data for share in shares]
    want = ref.experts_part({k: v.data for k, v in whole.params.items()}, xn,
                            dict(config, experts_held=8), "f32")
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), want.numpy(),
                               **TOL)
    np.testing.assert_allclose(whole.experts_part(Tensor(xn)).data.numpy(),
                               want.numpy(), **TOL)
    top = torch.topk(torch.softmax(xn @ whole.params["wr"].data, -1),
                     3).indices
    for part, held in zip(parts, (range(4), range(4, 8))):
        takes = torch.isin(top, torch.tensor(list(held))).any(-1)
        assert float(part[~takes].abs().sum()) == 0.0
        assert bool((part[takes].abs().sum(-1) > 0).all())


# --------------------------------------------------------------------------
# options, refusals, the loss, spans and counters
# --------------------------------------------------------------------------

def test_layer_options_and_refusals():
    with pytest.raises(ValueError, match="does not divide"):
        layers.AttentionBlock(64, 4, 3, 16)
    with pytest.raises(ValueError, match="not experts"):
        layers.TokenChoiceMoE(16, 8, 4, 2, experts_held=[3, 4])
    with pytest.raises(ValueError, match="top_k"):
        layers.TokenChoiceMoE(16, 8, 4, 5)
    with pytest.raises(ValueError, match="layer type"):
        build_moe_lm(32, 16, 2, 1, 8, ["dense"], 4, 4, 2, 8)
    block = layers.AttentionBlock(64, 4, 2, 32)
    assert block.params["wq"].shape == (64, 128)
    assert block.params["wk"].shape == (64, 64)
    assert block.params["wo"].shape == (128, 64)
    dense = layers.Dense(5, num_in=3, bias=False)
    assert set(dense.params) == {"w"}
    out = dense.forward(Tensor(np.ones((2, 3), np.float32)))
    want = np.ones((2, 3)) @ dense.params["w"].data.numpy()
    np.testing.assert_allclose(out.data.numpy(), want, rtol=1e-6)


def test_the_whole_epoch_kernel_refuses_a_dense_without_bias():
    net = Net([layers.Dense(4, num_in=3, bias=False), layers.ReLU(),
               layers.Dense(2, num_in=4)])
    reason = fused_epoch.unsupported_reason(
        net, net.params_tree(), None, SoftmaxCrossEntropyLoss())
    assert "no bias" in reason


def test_sparse_cross_entropy_is_the_one_hot_one():
    rng = np.random.RandomState(9)
    logits = rng.randn(2, 5, 7).astype(np.float32)
    ids = rng.randint(0, 7, size=(2, 5))
    sparse, dense = (Tensor(logits, requires_grad=True) for _ in range(2))
    a = SparseSoftmaxCrossEntropyLoss().loss(sparse, ids)
    b = SoftmaxCrossEntropyLoss().loss(
        dense.reshape((10, 7)), np.eye(7, dtype=np.float32)[ids.reshape(-1)])
    a.backward()
    b.backward()
    assert float(a.data) == pytest.approx(float(b.data), rel=1e-6)
    np.testing.assert_allclose(sparse.grad.numpy(), dense.grad.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_spans_and_counters_of_a_step(setup):
    config, _, _, data = setup
    model = _model(setup)
    profiler.reset()
    with profiler.recording():
        model.train_step(data["x"][:4], data["y"][:4])
    table = profiler.totals()
    profiler.reset()
    for name in ("tinynn.moe", "tinynn.moe.route", "tinynn.moe.dispatch",
                 "tinynn.moe.experts", "tinynn.moe.combine"):
        assert table[name]["count"] == 4, name
    assert table["tinynn.attn.rope"]["count"] == 4
    assert table["moe.syncs"] == 4
    # each token takes 3 of 8 experts, 4 of them held: the pairs computed
    # are the (token, held expert) pairs of the routing, 64 tokens a layer
    assert 0 < table["moe.routed_pairs"] <= 4 * 64 * 3
    assert table["moe.routed_pairs"] / 4 / 4 <= table[
        "moe.max_expert_tokens"] / 4 <= 64
