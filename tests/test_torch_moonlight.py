"""The DeepSeek-V3 layout of the PyTorch package (Moonlight-16B-A3B) on the
CPU at a small cut.

- the attention's plain versions at split head dims (192-wide queries and
  keys with 128-wide values, at small sizes) against ``torch.autograd``
  through a float64 softmax attention written out here: causal, banded,
  grouped-query and cross attention;
- the kernels' head-dim rule (``split_dims``) and the designs' answers;
- DeepSeek-V3's rotary pairing (``rope_(interleaved=True)``) against the
  reference's ``view(r/2, 2).transpose`` form and lane by lane, and the
  VJPs of ``rope_``, ``broadcast_to_`` and ``split_`` against central
  finite differences;
- ``build_mla_moe_lm`` at the benchmark family's small cut against the
  plain reference (``bench_torch/reference/moonlight.py``) on seeded
  weights: logits, loss and every gradient; one Adam step;
- the expert-parallel share: the routed parts of disjoint shares of the
  experts, with the shared expert counted once, add up to the reference's
  layer with every expert held; a nonzero selection bias moves the
  selection and not the weights;
- the spans and counters of a step.

Tolerances: the plain versions against the float64 oracle within 1e-5 of
each output's largest entry (f32 sums over at most 40 keys); against the
reference, the logits and each gradient leaf within 2e-6 and 2e-5 of its
largest entry (five layers of f32 sums in other orders), the leaves after
the Adam step within rtol 5e-7, atol 1e-8; the finite differences' 2e-3 of
the directional derivative (f32 forwards at a step of 1e-2).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.models import build_mla_moe_lm
from tinynn_autograd_tpu_torch.nn import layers
from tinynn_autograd_tpu_torch.ops import attention
from tinynn_autograd_tpu_torch.utils import profiler

_BENCH = Path(__file__).resolve().parents[1] / "bench_torch"
if str(_BENCH) not in sys.path:
    sys.path.append(str(_BENCH))

from harness import inputs, manifest, program  # noqa: E402
from reference import common  # noqa: E402
from reference import moonlight as ref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SEED = 2 ** 31 + 22


def _small():
    """The benchmark family's CPU cut of the cell: (config, traffic)."""
    bench = manifest.load()
    cell = manifest.cell(bench, "moonlight_16b.train_b2_t8192")
    config = manifest.config(bench, cell["config"])
    return program.family(config).small(config,
                                        manifest.traffic(cell["traffic"]))


# --------------------------------------------------------------------------
# the attention's plain versions at split head dims
# --------------------------------------------------------------------------

def _oracle(q, k, v, causal, scale, window):
    """softmax(q k^T scale + mask) v in float64 by torch.autograd."""
    group = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    s = q @ kx.transpose(-1, -2) * scale
    if causal:
        vis = torch.from_numpy(attention.band_mask(q.shape[2], window))
        s = s.masked_fill(~vis, float("-inf"))
    return torch.softmax(s, dim=-1) @ vx, torch.logsumexp(s, -1, True)


@pytest.mark.parametrize("shape", [
    (2, 3, 3, 17, 17, 24, 16, True, None),
    (1, 4, 2, 40, 40, 24, 16, True, 5),
    (1, 2, 2, 9, 13, 20, 12, False, None),
    (1, 2, 1, 33, 33, 192, 128, True, None),
])
def test_split_dim_plain_versions_match_autograd(shape):
    b, h, hkv, tq, tk, d, dv, causal, window = shape
    rng = np.random.RandomState(tq)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   for s in ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, dv),
                             (b, h, tq, dv)))
    scale = d ** -0.5
    o, lse = attention.mha_fwd(q, k, v, causal=causal, scale=scale,
                               window=window)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    want_o, want_lse = _oracle(*leaves, causal, scale, window)
    want = torch.autograd.grad(want_o, leaves, do.double())
    assert o.shape == (b, h, tq, dv)
    got = attention.mha_bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                            window=window)
    pairs = [(o, want_o.detach()), (lse, want_lse.detach())] + list(
        zip(got, want))
    for a, w in pairs:
        assert a.shape == w.shape
        top = float(w.abs().max())
        np.testing.assert_allclose(a.double().numpy() / top,
                                   w.numpy() / top, rtol=0, atol=1e-5)


def test_split_dims_and_designs():
    assert attention.split_dims(192, 128) and attention.split_dims(129, 1)
    assert not attention.split_dims(128, 64)
    assert not attention.split_dims(200, 128)
    assert not attention.split_dims(192, 129)
    # the designs' answers where q, k and v share one head dim stand
    for d, design in ((32, "mma"), (64, "mma"), (65, "wgmma"),
                      (128, "wgmma")):
        assert attention.dq_design(d) == attention.dkv_design(d) == design
        assert attention.dq_design(d, d) == design
    assert attention.dq_design(192, 128) == "mma"
    assert attention.dkv_design(192, 128) == "wgmma"
    with pytest.raises(ValueError, match="k's batch, heads and keys"):
        attention.mha_fwd(torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
                          torch.zeros(1, 2, 5, 4))


# --------------------------------------------------------------------------
# the rotary pairing and the new primitives' VJPs
# --------------------------------------------------------------------------

def test_rope_pairing_is_deepseek_v3s():
    cos, sin = ops.rope_tables(11, 8, 50000.0)
    x = torch.randn(2, 3, 11, 8)
    got = ops.rope_(Tensor(x), cos, sin, interleaved=True).data
    rcos, rsin = ref.rotary(dict(qk_rope_head_dim=8, rope_theta=50000), 11,
                            "cpu")
    assert torch.equal(rcos[:, :4], cos) and torch.equal(rcos[:, 4:], cos)
    np.testing.assert_allclose(got.numpy(), ref.rope(x, rcos,
                                                     rsin).numpy(), **TOL)
    # lane by lane: lanes 2i and 2i + 1 turn together by position * f_i, and
    # land at i and i + 4
    p, i = 7, 2
    unit = torch.zeros(1, 1, 11, 8)
    unit[..., p, 2 * i] = 1.0
    out = ops.rope_(Tensor(unit), cos, sin, interleaved=True).data[0, 0, p]
    angle = p * 50000.0 ** (-2.0 * i / 8)
    want = torch.zeros(8)
    want[i], want[i + 4] = np.cos(angle), np.sin(angle)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


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


def test_interleaved_rope_vjp_by_finite_differences():
    cos, sin = ops.rope_tables(9, 8, 50000.0)
    _fd_check(lambda x: ops.rope_(x, cos[:, None, :], sin[:, None, :],
                                  interleaved=True),
              [np.random.RandomState(4).randn(2, 9, 3, 8).astype(
                  np.float32)])


def test_broadcast_and_split_vjps_by_finite_differences():
    rng = np.random.RandomState(5)
    _fd_check(lambda x: ops.broadcast_to_(x, (2, 5, 4, 3)),
              [rng.randn(2, 5, 1, 3).astype(np.float32)])
    _fd_check(lambda x: ops.concat_(
        [p * (k + 1.0) for k, p in enumerate(ops.split_(x, (2, 5, 1)))],
        axis=-1), [rng.randn(3, 4, 8).astype(np.float32)])
    with pytest.raises(ValueError, match="do not cover"):
        ops.split_(Tensor(np.zeros((3, 8), np.float32)), (2, 5))


# --------------------------------------------------------------------------
# the model against the plain reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The small cut's model on seeded weights (the benchmark's laws, W_o
    drawn too so that every gradient is compared), its data and the same
    weights for the reference."""
    config, traffic = _small()
    spec = [(name, shape, "xavier" if law == "zeros" else law)
            for name, shape, law in ref.param_spec(config, traffic)]
    params = inputs.make_params(spec, SEED, "cpu")
    data = inputs.make_data(config, traffic, SEED, "cpu")
    return config, traffic, params, data


def _model(setup):
    config, traffic, params, _ = setup
    return program.build(config, traffic, params, SEED, "cpu")


def test_the_net_holds_the_references_leaves(setup):
    net = _model(setup).net
    assert [type(layer).__name__ for layer in net.layers] == (
        ["Embedding", "LatentAttentionBlock", "SwiGLU"]
        + ["LatentAttentionBlock", "TokenChoiceMoE"] * 4
        + ["RMSNorm", "Dense"])
    mla = net.layers[1].params
    assert {k: tuple(v.shape) for k, v in mla.items()} == {
        "g": (1, 64), "wq": (64, 96), "wkva": (64, 24), "gkv": (1, 16),
        "wkvb": (16, 128), "wo": (64, 64)}
    assert set(net.layers[4].params) == {"g", "wr"} | {
        "e%d_%s" % (j, w) for j in range(4) for w in ("gate", "up", "down")
    } | {"shared_gate", "shared_up", "shared_down"}
    assert net.layers[4].params["shared_gate"].shape == (64, 48)
    assert "score_bias" not in net.layers[4].params


def _grads(model):
    return {"%d.%s" % (i, k): v.grad for i, layer in
            enumerate(model.net.layers) for k, v in layer.params.items()}


def test_logits_loss_and_gradients_match_the_reference(setup):
    config, _, params, data = setup
    x, y = data["x"][:4], data["y"][:4]
    model = _model(setup)
    logits = model.net.forward(Tensor(x))
    loss = model.loss.loss(logits, Tensor(y))
    loss.backward()
    got = _grads(model)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want_logits = ref.forward(p, config, x, "f32")
    want_loss = ref.loss(want_logits, y)
    want = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()))))
    want_logits = want_logits.detach()
    scale = float(want_logits.abs().max())
    np.testing.assert_allclose(logits.data.numpy() / scale,
                               want_logits.numpy() / scale, rtol=0,
                               atol=2e-6)
    assert float(loss.data) == pytest.approx(float(want_loss.detach()),
                                             rel=1e-6)
    assert set(got) == set(want)
    for name, g in want.items():
        top = float(g.abs().max()) or 1.0
        np.testing.assert_allclose(got[name].numpy() / top, g.numpy() / top,
                                   rtol=0, atol=2e-5, err_msg=name)
    # every held expert of every expert layer took tokens and a gradient
    assert all(float(got["%d.e%d_gate" % (2 + 2 * l, j)].abs().sum()) > 0
               for l in range(1, 5) for j in range(4))


def test_one_adam_step_matches_the_reference(setup):
    """``train_step``'s loss is the reference's, and its step of each leaf
    is the reference's Adam step on the port's own gradient (held to the
    reference's above)."""
    config, _, params, data = setup
    x, y = data["x"][:4], data["y"][:4]
    model = _model(setup)
    model.loss.loss(model.net.forward(Tensor(x)), Tensor(y)).backward()
    grads = _grads(model)
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


def _expert_layers(config, helds):
    """A layer with every expert held and layers holding ``helds``, all on
    the whole layer's leaves."""
    kw = dict(scoring="sigmoid", routed_scaling=config[
        "routed_scaling_factor"], shared_width=ref.shared_width(config))
    whole = layers.TokenChoiceMoE(64, 24, 8, 3, **kw)
    shares = [layers.TokenChoiceMoE(64, 24, 8, 3, experts_held=held, **kw)
              for held in helds]
    for share in shares:
        for k in share.params:
            share.params[k] = whole.params[k]
    return whole, shares


def _shared(layer, xn):
    p = layer.params
    return layers._swiglu(Tensor(xn), p["shared_gate"], p["shared_up"],
                          p["shared_down"]).data


def test_expert_shares_add_up_to_the_whole_layer():
    """Two layers holding experts 0-3 and 4-7 of one sigmoid router (a
    two-way expert-parallel split): their routed parts, with the shared
    expert (which every rank computes alike) counted once, add up to the
    reference's layer with all eight experts held; each routed part is
    zero on the tokens none of its experts takes."""
    config, _ = _small()
    helds = (range(4), range(4, 8))
    whole, shares = _expert_layers(config, helds)
    rng = np.random.RandomState(8)
    xn = torch.from_numpy(rng.randn(40, 64).astype(np.float32))
    p = {k: v.data for k, v in whole.params.items()}
    parts = [share.experts_part(Tensor(xn)).data for share in shares]
    want = ref.experts_part(p, xn, config, "f32", held=range(8)) \
        + ref.swiglu(xn, p["shared_gate"], p["shared_up"], p["shared_down"],
                     "f32")
    got = parts[0] + parts[1] + _shared(shares[0], xn)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    x = Tensor(xn.reshape(1, 40, 64))
    layer_out = whole.forward(x).data.reshape(40, 64) - xn
    xnormed = ops.rms_norm_(Tensor(xn), whole.params["g"],
                            eps=whole.eps).data
    np.testing.assert_allclose(
        layer_out.numpy(),
        (ref.experts_part(p, xnormed, config, "f32", held=range(8))
         + ref.swiglu(xnormed, p["shared_gate"], p["shared_up"],
                      p["shared_down"], "f32")).numpy(), **TOL)
    top = torch.topk(torch.sigmoid(xn @ p["wr"]), 3).indices
    for part, held in zip(parts, helds):
        takes = torch.isin(top, torch.tensor(list(held))).any(-1)
        assert float(part[~takes].abs().sum()) == 0.0
        assert bool((part[takes].abs().sum(-1) > 0).all())


def test_selection_bias_moves_the_selection_not_the_weights():
    config, _ = _small()
    whole, _ = _expert_layers(config, ())
    rng = np.random.RandomState(9)
    xn = torch.from_numpy(rng.randn(40, 64).astype(np.float32))
    p = {k: v.data for k, v in whole.params.items()}
    bias = torch.from_numpy(rng.randn(8).astype(np.float32)) * 0.3
    unbiased = whole.experts_part(Tensor(xn)).data
    whole.set_score_bias(bias)
    biased = whole.experts_part(Tensor(xn)).data
    np.testing.assert_allclose(
        biased.numpy(), ref.experts_part(p, xn, config, "f32", held=range(8),
                                         bias=bias).numpy(), **TOL)
    scores = torch.sigmoid(xn @ p["wr"])
    top = torch.topk(scores + bias, 3).indices
    assert not torch.equal(top, torch.topk(scores, 3).indices)
    assert not torch.allclose(biased, unbiased)
    # the weights are the scores' own, renormalised over the biased top-3:
    # one expert alone for a token reads back its weight
    solo = layers.TokenChoiceMoE(64, 24, 8, 3, experts_held=[int(top[0, 0])],
                                 scoring="sigmoid", routed_scaling=2.446)
    for k in solo.params:
        solo.params[k] = whole.params[k]
    solo.set_score_bias(bias)
    s = scores[0, top[0]]
    j = int(top[0, 0])
    want = 2.446 * s[0] / s.sum() * ref.swiglu(
        xn[:1], p["e%d_gate" % j], p["e%d_up" % j], p["e%d_down" % j], "f32")
    np.testing.assert_allclose(solo.experts_part(Tensor(xn)).data[:1].numpy(),
                               want.numpy(), **TOL)
    with pytest.raises(ValueError, match="score bias"):
        whole.set_score_bias(torch.zeros(7))
    with pytest.raises(ValueError, match="scoring"):
        layers.TokenChoiceMoE(64, 24, 8, 3, scoring="softplus")


# --------------------------------------------------------------------------
# options, spans and counters
# --------------------------------------------------------------------------

def test_builder_and_layer_options():
    net = build_mla_moe_lm(32, 16, 2, 8, 4, 8, 8, 3, 2, 24, 4, 2, 8, 16,
                           experts_held=[1, 2])
    names = [type(layer).__name__ for layer in net.layers]
    assert names == ["Embedding"] + ["LatentAttentionBlock", "SwiGLU"] * 2 \
        + ["LatentAttentionBlock", "TokenChoiceMoE", "RMSNorm", "Dense"]
    moe = net.layers[6]
    assert moe.experts_held == [1, 2] and moe.scoring == "sigmoid"
    with pytest.raises(ValueError, match="odd"):
        layers.LatentAttentionBlock(16, 2, 8, 3, 8, 8)


def test_spans_and_counters_of_a_step(setup):
    _, _, _, data = setup
    model = _model(setup)
    profiler.reset()
    with profiler.recording():
        model.train_step(data["x"][:4], data["y"][:4])
    table = profiler.totals()
    profiler.reset()
    for name in ("tinynn.mla", "tinynn.mla.project", "tinynn.mla.rope",
                 "tinynn.mla.attend", "tinynn.mla.out"):
        assert table[name]["count"] == 5, name
    for name in ("tinynn.moe", "tinynn.moe.route", "tinynn.moe.dispatch",
                 "tinynn.moe.experts", "tinynn.moe.combine",
                 "tinynn.moe.shared"):
        assert table[name]["count"] == 4, name
    assert table["moe.syncs"] == 4
    # each token takes 3 of 8 experts, 4 of them held: the pairs computed
    # are the (token, held expert) pairs of the routing, 64 tokens a layer
    assert 0 < table["moe.routed_pairs"] <= 4 * 64 * 3
