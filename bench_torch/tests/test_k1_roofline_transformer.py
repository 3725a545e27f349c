"""``k1_roofline.transformer``: the 39 products of a 6b step (36 of them
the blocks', whose FLOPs are ``transformer_step_flops``' dense term), the
share on a stretch built by hand, and nothing where a product missed K1 or
its tensor-core tile, or where the program has no tensor-core counter."""

import importlib
import types

import pytest

from harness import costs, manifest, program

BENCH = manifest.load()
CONFIG = manifest.config(BENCH, "transformer_6b")
TRAFFIC = manifest.traffic("train_t256")


def _ctx(steps, k1, tc, seconds=0.05):
    stretch = {"records": {"steps": steps},
               "kernels": {"matmul_kernel": (k1, seconds),
                           "matmul_kernel_tc": (tc, seconds)},
               "checked": {"matmul_kernel": True, "matmul_kernel_tc": True},
               "counted": {"matmul_kernel": k1, "matmul_kernel_tc": tc}}
    return types.SimpleNamespace(stretch=stretch, costs=costs, config=CONFIG,
                                 traffic=TRAFFIC)


def test_products_are_the_step_flops_dense_term():
    reader = manifest.reader("k1_roofline.transformer")
    tokens = TRAFFIC["batch"] * TRAFFIC["seq_len"]
    blocks = CONFIG["depth"] * reader.block_products(CONFIG, tokens)
    head = reader.head_products(CONFIG, TRAFFIC["batch"])
    assert (len(blocks), len(head)) == (36, 3)
    assert costs.products_flops(blocks) == pytest.approx(309.2e9, rel=1e-3)
    whole = costs.transformer_step_flops(CONFIG, TRAFFIC["batch"],
                                         TRAFFIC["seq_len"])
    attention = sum(f for f, _ in costs.attention_costs(
        TRAFFIC["batch"], CONFIG["heads"], TRAFFIC["seq_len"],
        CONFIG["dim"] // CONFIG["heads"], CONFIG["causal"])) * CONFIG["depth"]
    assert costs.products_flops(blocks + head) == pytest.approx(
        whole - attention)


def test_share_of_a_stretch():
    reader = manifest.reader("k1_roofline.transformer")
    tokens = TRAFFIC["batch"] * TRAFFIC["seq_len"]
    products = (CONFIG["depth"] * reader.block_products(CONFIG, tokens)
                + reader.head_products(CONFIG, TRAFFIC["batch"]))
    want = 100.0 * 12 * costs.products_bound_s(products) / 0.05
    assert reader.read(_ctx(12, 12 * 39, 12 * 36)) == pytest.approx(want)


@pytest.mark.parametrize("k1,tc", [(12 * 3, 0), (12 * 39, 0),
                                   (12 * 39, 12 * 35), (12 * 40, 12 * 36)])
def test_nothing_unless_every_product_ran_on_k1(k1, tc):
    assert manifest.reader("k1_roofline.transformer").read(
        _ctx(12, k1, tc)) is None


def test_counter_of_a_program_without_one(monkeypatch):
    # the tensor-core count is read through the harness's program module:
    # cuda_matmul's tc_launches, 0 where the program has none
    reader = manifest.reader("k1_roofline.transformer")
    module, attr = reader.KERNELS["matmul_kernel_tc"]
    counter = getattr(importlib.import_module(module), attr)
    wrapper = types.SimpleNamespace(launches=5)
    asked = []

    def fake_counter(*where):
        asked.append(where)
        return wrapper

    monkeypatch.setattr(program, "counter", fake_counter)
    assert counter.launches == 0
    wrapper.tc_launches = 7
    assert counter.launches == 7
    assert asked == [reader.KERNELS["matmul_kernel"]] * 2
