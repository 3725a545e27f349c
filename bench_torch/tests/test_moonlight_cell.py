"""The ``moonlight_16b.train_b2_t8192`` cell on the CPU: its files run
through ``tests/cpu_run.py`` in a process of their own at the family's
small cut (the sound run correct, the control and each fault not), faults
of the latent attention and of the update planted in the program
(``plant_program``), the routing flips of ``moonlight_flips.py``, the work
its readers count (``metrics/moonlight_work.py``) and the readers on a
stretch and a table built by hand."""

import json
import os
import subprocess
import sys
import types

import pytest

from harness import check, costs, manifest, program

BENCH = manifest.load()
CELL = "moonlight_16b.train_b2_t8192"
CONFIG = manifest.config(BENCH, "moonlight_16b")
TRAFFIC = manifest.traffic("train_b2_t8192")
SEED = 2 ** 31 + 7103
WORK = manifest.reader("moonlight_work")


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
# faults of the latent attention and of the update, planted in the program
# --------------------------------------------------------------------------

PROGRAM_FAULTS = ("v_half_width", "unshared_k_pe", "no_rope",
                  "update_scaled")


def plant_program(fault, monkeypatch):
    """Plant ``fault`` of PROGRAM_FAULTS in the program through
    ``monkeypatch``: "v_half_width", the attention kernels given v with its
    lanes past the first half zeroed (v taken at 64 of its 128 lanes);
    "unshared_k_pe", the shared k_pe reaching the first head only (the
    other heads' rotated key lanes zero); "no_rope", q_pe and k_pe not
    rotated; "update_scaled", each step's update applied times 1.5 (Adam's
    state kept as it is)."""
    import torch

    from tinynn_autograd_tpu_torch import Tensor, ops
    from tinynn_autograd_tpu_torch.nn.optimizer import Adam

    if fault == "update_scaled":
        compute_step = Adam.compute_step

        def scaled(self, grads, params):
            return [{k: 1.5 * v for k, v in step.items()}
                    for step in compute_step(self, grads, params)]

        monkeypatch.setattr(Adam, "compute_step", scaled)
        return
    if fault == "v_half_width":
        attend = ops.flash_attention_

        def narrowed(q, k, v, **kw):
            keep = torch.ones(v.shape[-1], device=v.device)
            keep[v.shape[-1] // 2:] = 0.0
            return attend(q, k, v * Tensor(keep), **kw)

        monkeypatch.setattr(ops, "flash_attention_", narrowed)
        return
    if fault == "unshared_k_pe":
        broadcast = ops.broadcast_to_

        def first_head(x, shape):
            keep = torch.zeros(shape[-2], 1, device=x.device)
            keep[0] = 1.0
            return broadcast(x, shape) * Tensor(keep)

        monkeypatch.setattr(ops, "broadcast_to_", first_head)
        return
    assert fault == "no_rope", fault
    rope = ops.rope_

    def unrotated(x, cos, sin, interleaved=False):
        return x if interleaved else rope(x, cos, sin, interleaved)

    monkeypatch.setattr(ops, "rope_", unrotated)


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


@pytest.mark.parametrize("fault", PROGRAM_FAULTS)
def test_planted_program_faults_fail(monkeypatch, fault):
    config, traffic = program.family(CONFIG).small(CONFIG, TRAFFIC)
    plant_program(fault, monkeypatch)
    numbers = program_numbers(config, traffic, SEED, "cpu")
    assert not check.judge(numbers, manifest.limits(CELL))[1], numbers


def test_routing_flips_at_the_small_cut():
    import moonlight_flips

    row = moonlight_flips.readings(BENCH, CELL, SEED, "cpu", small=True)
    assert set(row) == {"program", "control", "frozen", "half_batch",
                        "wrong_label", "fresh_state", "wrong_beta2", "flips"}
    for side in ("program", "control"):
        flips = row["flips"][side]
        assert len(flips["flips"]) == len(flips["held_flips"]) == 3
        assert all(0 <= h <= f <= 4 * 64 for h, f in zip(
            flips["held_flips"], flips["flips"]))
    assert moonlight_flips.flip_config(CONFIG) == {
        "layers": 4, "num_experts": 64, "experts_held": 8}


# --------------------------------------------------------------------------
# the work the readers count
# --------------------------------------------------------------------------

def test_products_of_a_step():
    tokens = TRAFFIC["batch"] * TRAFFIC["seq_len"]
    pairs = tokens * 6 * 8 // 64 * 4  # an even load, 4 expert layers
    products = WORK.products(CONFIG, tokens, pairs)
    assert len(products) == 5 * 12 + 9 + 4 * (3 + 8 * 9 + 9) + 3 == 408
    d = 2048
    per_token = (5 * (d * 16 * 192 + d * 576 + 512 * 16 * 256
                      + 16 * 128 * d)
                 + 3 * d * 11264
                 + 4 * (d * 64 + 3 * d * 2816)
                 + d * 20480)
    experts = 4 * 8 * 3 * d * 1408 * (tokens * 6 // 64)
    assert costs.products_flops(products) == pytest.approx(
        6 * (per_token * tokens + experts))


def test_attention_work_at_split_dims():
    (fwd, bwd), = set(WORK.attention_layers(CONFIG, 2, 8192))
    pairs = 2 * 16 * 8192 * 8193 // 2
    assert fwd[0] == 2.0 * (192 + 128) * pairs
    assert bwd[0] == 4.0 * (192 + 128) * pairs
    # at one head dim, the mellum2 counter's (and costs.attention_costs')
    # 4 d and 8 d a pair
    same = dict(CONFIG, qk_nope_head_dim=64, qk_rope_head_dim=0,
                v_head_dim=64)
    want = costs.attention_costs(2, 16, 8192, 64, True)
    assert WORK.attention_costs(same, 2, 8192) == want
    assert len(WORK.attention_layers(CONFIG, 2, 8192)) == 5
    flops = WORK.step_flops(costs, CONFIG, TRAFFIC, 49_152)
    assert 3.5e13 < flops < 4.0e13  # ~37 TFLOP a step


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

TABLE = {"tinynn.moe": {"count": 16, "ns": 320_000_000, "self_ns": 0},
         "tinynn.mla": {"count": 20, "ns": 200_000_000, "self_ns": 0},
         "moe.routed_pairs": 16 * 12_288, "moe.max_expert_tokens": 16 * 1_700,
         "moe.syncs": 16}


def _serve(monkeypatch, table, split=True):
    counters = {}

    class Wrapper:
        launches = 20
        split_launches = 20 if split else 0

    def counter(module, attr):
        if attr == "totals":
            return lambda: table
        return counters.setdefault(attr, Wrapper())

    monkeypatch.setattr(program, "counter", counter)


def _ctx(steps=4, k1=4 * 408, attention=20, seconds=1.0):
    kernels = {"matmul_kernel": (k1, seconds)}
    kernels.update({name: (attention, seconds / 3) for name in
                    manifest.reader("attention_roofline.moonlight").KERNELS})
    stretch = {"records": {"steps": steps}, "kernels": kernels,
               "checked": {name: True for name in kernels}}
    window = {"steps": 12, "wall_s": 10.0}
    return types.SimpleNamespace(stretch=stretch, costs=costs, config=CONFIG,
                                 traffic=TRAFFIC, window=window)


def test_program_readers(monkeypatch):
    _serve(monkeypatch, TABLE)
    assert manifest.reader("mla_host_ms.moonlight").read(None) == \
        pytest.approx(10.0)
    assert manifest.reader("expert_imbalance.moonlight").read(_ctx()) == \
        pytest.approx(1_700 / 1_536)
    assert WORK.routed_pairs(CONFIG) == 4 * 12_288


def test_roofline_and_mfu_readers(monkeypatch):
    _serve(monkeypatch, TABLE)
    ctx = _ctx()
    pairs = 4 * 12_288
    products = WORK.products(CONFIG, 16_384, pairs)
    assert manifest.reader("k1_roofline.moonlight").read(ctx) == \
        pytest.approx(100.0 * 4 * costs.products_bound_s(products))
    bound = sum(costs.bound_s(*f) + costs.bound_s(*b)
                for f, b in WORK.attention_layers(CONFIG, 2, 8192))
    assert manifest.reader("attention_roofline.moonlight").read(ctx) == \
        pytest.approx(100.0 * 4 * bound)
    flops = WORK.step_flops(costs, CONFIG, TRAFFIC, pairs)
    assert manifest.reader("mfu.moonlight").read(ctx) == pytest.approx(
        100.0 * 12 * flops / 10.0 / costs.PEAK_FLOPS)


@pytest.mark.parametrize("k1,attention,split", [(4 * 407, 20, True),
                                                (4 * 408, 19, True),
                                                (4 * 408, 20, False)])
def test_rooflines_need_every_launch(monkeypatch, k1, attention, split):
    _serve(monkeypatch, TABLE, split)
    ctx = _ctx(k1=k1, attention=attention)
    name = "k1_roofline.moonlight" if k1 != 4 * 408 \
        else "attention_roofline.moonlight"
    assert manifest.reader(name).read(ctx) is None


def test_shared_readers_read_as_the_others():
    for base in ("launches_per_step", "device_idle"):
        mine = manifest.reader("%s.moonlight" % base)
        theirs = manifest.reader("%s.mellum2" % base)
        assert mine.read.__code__.co_filename == \
            theirs.read.__code__.co_filename


@pytest.mark.parametrize("name", ["mfu.moonlight", "k1_roofline.moonlight",
                                  "mla_host_ms.moonlight",
                                  "expert_imbalance.moonlight"])
def test_readers_of_a_program_without_the_counters(monkeypatch, name):
    _serve(monkeypatch, {})
    assert manifest.reader(name).read(_ctx()) is None
