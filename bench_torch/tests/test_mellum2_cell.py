"""The ``mellum2_12b.train_t8192`` cell on the CPU: its files run through
``tests/cpu_run.py`` in a process of their own at the family's small cut
(the sound run correct, the control and each fault not), faults of the
attention and of the update planted in the program (``plant_program``),
the routing flips of ``routing_flips.py``, the work its readers count
(``metrics/mellum2_work.py``) and the readers on a stretch and a table
built by hand."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from harness import check, costs, manifest, program

BENCH = manifest.load()
CELL = "mellum2_12b.train_t8192"
CONFIG = manifest.config(BENCH, "mellum2_12b")
TRAFFIC = manifest.traffic("train_t8192")
SEED = 2 ** 31 + 6101
WORK = manifest.reader("mellum2_work")


@pytest.fixture(scope="module")
def outcome():
    proc = subprocess.run(
        [sys.executable, str(manifest.BENCH_DIR / "tests" / "cpu_run.py"),
         "--workload", CELL, "--seed", str(SEED)],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(manifest.ROOT)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sound_run_through_cpu_run(outcome):
    result = outcome["sound"]
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(outcome["limits"])
    assert {"setup_s", "train_tokens_per_s"} <= set(result["metrics"])


def test_stand_ins_and_planted_faults_fail(outcome):
    sides = [s for s in outcome["readings"] if s != "program"]
    assert sides == ["control", "frozen", "half_batch", "wrong_label",
                     "fresh_state", "wrong_beta2"]
    for side in sides:
        assert not check.judge(outcome["readings"][side],
                               outcome["limits"])[1], side
    assert sorted(outcome["planted"]) == sorted(sides[1:])
    for fault, result in outcome["planted"].items():
        assert not result["correct"], (fault, result["checks"])


# --------------------------------------------------------------------------
# faults of the attention and of the update, planted in the program
# --------------------------------------------------------------------------

PROGRAM_FAULTS = {"no_window": None, "plain_rope": None,
                  "update_scaled": 1.5, "update_flipped": -1.0}


def plant_program(fault, monkeypatch):
    """Plant ``fault`` of PROGRAM_FAULTS in the program through
    ``monkeypatch``: "no_window", the sliding layers attend to every
    earlier key; "plain_rope", the full layer rotates by the plain tables
    in place of YaRN's; "update_scaled" and "update_flipped", each step's
    update applied times 1.5 or -1 (Adam's state kept as it is)."""
    from families import mellum2

    from tinynn_autograd_tpu_torch.nn.layers import AttentionBlock
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam

    if PROGRAM_FAULTS[fault] is not None:
        compute_step = Adam.compute_step

        def scaled(self, grads, params):
            return [{k: PROGRAM_FAULTS[fault] * v for k, v in step.items()}
                    for step in compute_step(self, grads, params)]

        monkeypatch.setattr(Adam, "compute_step", scaled)
        return
    build = mellum2.build_moe_lm

    def planted(*args, **kwargs):
        net = build(*args, **kwargs)
        for layer in net.layers:
            if isinstance(layer, AttentionBlock):
                if fault == "no_window":
                    layer.window = None
                else:
                    layer.yarn = None
        return net

    monkeypatch.setattr(mellum2, "build_moe_lm", planted)


def program_numbers(config, traffic, seed, device):
    """The numbers compared of the program's check steps (with whatever is
    planted in it) against the reference's."""
    from harness import inputs

    ref = check.reference_module(config)
    params = inputs.make_params(ref.param_spec(config, traffic), seed, device)
    data = inputs.make_data(config, traffic, seed, device)
    model = program.build(config, traffic, params, seed, device)
    got = check.program_readings(model, data, traffic, config)
    del model, data, params
    check.free_device()
    return check.compare(got, check.reference_readings(config, traffic, seed,
                                                       device))


@pytest.mark.parametrize("fault", ["no_window", "plain_rope",
                                   "update_scaled"])
def test_planted_program_faults_fail(monkeypatch, fault):
    config, traffic = program.family(CONFIG).small(CONFIG, TRAFFIC)
    plant_program(fault, monkeypatch)
    numbers = program_numbers(config, traffic, SEED, "cpu")
    assert not check.judge(numbers, manifest.limits(CELL))[1], numbers


def test_routing_flips_at_the_small_cut():
    import routing_flips

    row = routing_flips.readings(BENCH, CELL, SEED, "cpu", small=True)
    assert set(row) == {"program", "control", "frozen", "half_batch",
                        "wrong_label", "fresh_state", "wrong_beta2", "flips"}
    for side in ("program", "control"):
        flips = row["flips"][side]
        assert len(flips["flips"]) == len(flips["held_flips"]) == 3
        assert all(0 <= h <= f for h, f in zip(flips["held_flips"],
                                              flips["flips"]))
    # the control routes by TF32 scores: some of its tokens flip
    assert sum(row["flips"]["control"]["flips"]) > 0


def test_flips_count_set_differences():
    import torch

    import routing_flips

    config = dict(CONFIG, layers=1, num_experts=8, experts_held=4)
    a = [torch.tensor([[0, 1], [2, 5], [6, 7]])] * 3
    b = [torch.tensor([[1, 0], [2, 4], [6, 3]])] * 3
    # row 0: the same set in another order; row 1: 5 for 4 (neither of
    # the held 0-3); row 2: 7 for 3 (3 is held)
    assert routing_flips.flips(a, b, config) == {"flips": [2, 2, 2],
                                                 "held_flips": [1, 1, 1]}
    c = [torch.tensor([[0, 1], [2, 6], [6, 7]])] * 3
    assert routing_flips.flips(a, c, config) == {"flips": [1, 1, 1],
                                                 "held_flips": [0, 0, 0]}
    d = [torch.tensor([[0, 1], [2, 5], [6, 2]])] * 3
    assert routing_flips.flips(a, d, config) == {"flips": [1, 1, 1],
                                                 "held_flips": [1, 1, 1]}


# --------------------------------------------------------------------------
# the work the readers count
# --------------------------------------------------------------------------

def test_products_of_a_step():
    tokens = TRAFFIC["batch"] * TRAFFIC["seq_len"]
    pairs = tokens * 4  # an even load: a token's 8 of 64 experts, 8 held
    products = WORK.products(CONFIG, tokens, pairs)
    assert len(products) == 351
    d, width = 2304, 896
    per_token = 4 * (2304 * (4096 + 2 * 512) + 4096 * 2304 + 2304 * 64) \
        + 2304 * 12288
    experts = 4 * 8 * 3 * d * width * (tokens // 8)
    assert costs.products_flops(products) == pytest.approx(
        6 * (per_token * tokens + experts))


@pytest.mark.parametrize("t,window", [(16, 4), (16, None), (5, 8), (8, 8)])
def test_visible_pairs_count_the_mask(t, window):
    q = np.arange(t)[:, None]
    k = np.arange(t)[None, :]
    mask = (k <= q) & ((q - k < window) if window else True)
    assert WORK.visible_pairs(t, window) == int(mask.sum())


def test_attention_layers_follow_the_layer_types():
    layers = WORK.attention_layers(CONFIG, 4, 8192)
    assert len(layers) == 4
    band, full = layers[0][0][0], layers[3][0][0]
    assert layers[1] == layers[2] == layers[0]
    pairs = 4 * 32 * (1024 * 1025 // 2 + 7168 * 1024)
    assert band == 4.0 * 128 * pairs
    assert full == 4.0 * 128 * 4 * 32 * 8192 * 8193 // 2


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

TABLE = {"tinynn.moe": {"count": 16, "ns": 320_000_000, "self_ns": 0},
         "moe.routed_pairs": 16 * 32_768, "moe.max_expert_tokens": 16 * 4_300,
         "moe.syncs": 16}


def _serve(monkeypatch, table):
    monkeypatch.setattr(program, "counter",
                        lambda module, attr: (lambda: table))


def _ctx(steps=4, k1=4 * 351, attention=16, seconds=1.0):
    kernels = {"matmul_kernel": (k1, seconds)}
    kernels.update({name: (attention, seconds / 3) for name in
                    manifest.reader("attention_roofline.mellum2").KERNELS})
    stretch = {"records": {"steps": steps}, "kernels": kernels,
               "checked": {name: True for name in kernels}}
    window = {"steps": 10, "wall_s": 10.0}
    return types.SimpleNamespace(stretch=stretch, costs=costs, config=CONFIG,
                                 traffic=TRAFFIC, window=window)


def test_program_readers(monkeypatch):
    _serve(monkeypatch, TABLE)
    assert manifest.reader("moe_host_ms.mellum2").read(None) == \
        pytest.approx(20.0)
    assert manifest.reader("expert_imbalance.mellum2").read(_ctx()) == \
        pytest.approx(4_300 / 4_096)
    assert WORK.routed_pairs(CONFIG) == 4 * 32_768


def test_roofline_and_mfu_readers(monkeypatch):
    _serve(monkeypatch, TABLE)
    ctx = _ctx()
    pairs = 4 * 32_768
    products = WORK.products(CONFIG, 32_768, pairs)
    assert manifest.reader("k1_roofline.mellum2").read(ctx) == \
        pytest.approx(100.0 * 4 * costs.products_bound_s(products))
    bound = sum(costs.bound_s(*f) + costs.bound_s(*b)
                for f, b in WORK.attention_layers(CONFIG, 4, 8192))
    assert manifest.reader("attention_roofline.mellum2").read(ctx) == \
        pytest.approx(100.0 * 4 * bound)
    flops = WORK.step_flops(costs, CONFIG, TRAFFIC, pairs)
    assert manifest.reader("mfu.mellum2").read(ctx) == pytest.approx(
        100.0 * 10 * flops / 10.0 / costs.PEAK_FLOPS)


@pytest.mark.parametrize("k1,attention", [(4 * 350, 16), (4 * 351, 15)])
def test_rooflines_need_every_launch(monkeypatch, k1, attention):
    _serve(monkeypatch, TABLE)
    ctx = _ctx(k1=k1, attention=attention)
    name = "k1_roofline.mellum2" if k1 != 4 * 351 \
        else "attention_roofline.mellum2"
    assert manifest.reader(name).read(ctx) is None


def test_launches_per_step_reads_as_the_transformers():
    mine = manifest.reader("launches_per_step.mellum2")
    theirs = manifest.reader("launches_per_step.transformer")
    assert mine.read.__code__.co_filename == \
        theirs.read.__code__.co_filename
    ctx = _ctx()
    ctx.stretch["launches"] = 4 * 2_000
    assert mine.read(ctx) == pytest.approx(2_000)


@pytest.mark.parametrize("name", ["mfu.mellum2", "k1_roofline.mellum2",
                                  "moe_host_ms.mellum2",
                                  "expert_imbalance.mellum2"])
def test_readers_of_a_program_without_the_counters(monkeypatch, name):
    _serve(monkeypatch, {})
    assert manifest.reader(name).read(_ctx()) is None
