"""The cost arithmetic against counts made by hand."""

import pytest

from harness import costs, manifest

BENCH = manifest.load()
MLP = manifest.config(BENCH, "mlp_mnist")
T6B = manifest.config(BENCH, "transformer_6b")

# the MLP's multiply-adds a row: 784*200 + 200*100 + 100*70 + 70*30 + 30*10
MLP_MACS = 186_200


def test_peak_rule():
    assert costs.PEAK_FLOPS == pytest.approx(164.9e12)
    assert costs.bound_s(164.9e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_k2_epoch():
    # a step: forward and dW 2*128*MACs each, dX all but the first layer's
    step = 2 * 128 * (2 * MLP_MACS + (MLP_MACS - 784 * 200))
    assert step == 102_860_800
    flops, n_bytes = costs.k2_epoch_cost(MLP, 390, 128)
    assert flops == 390 * step == pytest.approx(40.1e9, rel=1e-3)
    leaves = MLP_MACS + 200 + 100 + 70 + 30 + 10
    assert n_bytes == 4 * (390 * 128 * (784 + 10) + 390 + 2 * 3 * leaves)
    assert len(costs.mlp_products(MLP, 128)) == 14


def test_eval_products():
    products = costs.mlp_products(MLP, 10_000, train=False)
    assert products == [(10_000, 784, 200), (10_000, 200, 100),
                        (10_000, 100, 70), (10_000, 70, 30), (10_000, 30, 10)]
    assert costs.products_flops(products) == 2 * 10_000 * MLP_MACS
    # the first product's bytes: x, w and the output, f32
    first = 4 * (10_000 * 784 + 784 * 200 + 10_000 * 200)
    assert costs.product_cost(*products[0])[1] == first


@pytest.mark.parametrize("t, batch, want", [(2048, 4, 4.12e11),
                                            (256, 32, 3.22e11)])
def test_transformer_step(t, batch, want):
    # 12 D^2 multiply-adds a token a block, times 3 (forward, dW, dX)
    dense = 3 * 2 * batch * t * 12 * 512 ** 2 * 2
    pairs = batch * 8 * t * (t + 1) // 2 * 2
    attention = pairs * 12 * 64
    head = 3 * 2 * batch * 512 * 16
    got = costs.transformer_step_flops(T6B, batch, t)
    assert got == dense + attention + head
    assert got == pytest.approx(want, rel=2e-3)


def test_attention_pairs():
    assert costs.visible_pairs(2048, True) == sum(range(1, 2049))
    assert costs.visible_pairs(40, False) == 1600


@pytest.mark.parametrize("name, key", [("eval_ms_p95", "eval_ms"),
                                       ("step_ms_p95", "step_ms")])
def test_tail_readers(name, key):
    import types

    reader = manifest.reader(name)
    # 20 times of 1 .. 20 ms: the inclusive 95th percentile is 19.05
    ctx = types.SimpleNamespace(window={key: [float(i) for i in
                                              range(20, 0, -1)]})
    assert reader.read(ctx) == pytest.approx(19.05)
    ctx.window = {key: [1.0]}
    assert reader.read(ctx) is None
