"""The port's spans and counters (``utils/profiler.py``) on the CPU: off by
default, on under ``torch.profiler.profile`` or ``recording()``, each span
of the facade, the tape and K2's host path counted once where it runs,
children nested under their parents, and the spans on the profiler's
timeline. K2's phase clock runs only on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tinynn_autograd_tpu_torch
from tinynn_autograd_tpu_torch.models import build_mnist_mlp
from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.optimizer import Adam
from tinynn_autograd_tpu_torch.utils import profiler, seeder

N_EPOCHS, N_EVALS, N_STEPS = 2, 3, 2
STEPS_AN_EPOCH = 4
# span -> (its parent, how many times the traced calls below open it)
SPANS = {
    "tinynn.epoch": (None, N_EPOCHS),
    "tinynn.epoch.tier": ("tinynn.epoch", N_EPOCHS),
    "tinynn.epoch.shuffle": ("tinynn.epoch", N_EPOCHS),
    "tinynn.k2.scalars": ("tinynn.epoch", N_EPOCHS),
    "tinynn.eval": (None, N_EVALS),
    "tinynn.eval.forward": ("tinynn.eval", N_EVALS),
    "tinynn.eval.readback": ("tinynn.eval", N_EVALS),
    "tinynn.step": (None, N_STEPS),
    "tinynn.step.forward": ("tinynn.step", N_STEPS),
    "tinynn.step.loss": ("tinynn.step", N_STEPS),
    "tinynn.step.backward": ("tinynn.step", N_STEPS),
    "tinynn.step.update": ("tinynn.step", N_STEPS),
}


def _model():
    with seeder.scope(0):
        net = build_mnist_mlp(num_in=12, hidden=(8, 6), num_out=4)
    return Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3), device="cpu")


def _data(n):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(n, 12).astype(np.float32))
    y = torch.from_numpy(np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)])
    return x, y


def _traced_calls(model):
    """K2's plain version twice, the eval three times, the tape's step
    twice."""
    x, y = _data(8 * STEPS_AN_EPOCH)
    for _ in range(N_EPOCHS):
        model.train_epoch(x, y, batch_size=8, fused=True)
    for _ in range(N_EVALS):
        model.evaluate_batch(x, y.argmax(1).numpy(), AccEvaluator)
    for _ in range(N_STEPS):
        model.train_step(x[:8], y[:8])


@pytest.fixture(scope="module")
def traced():
    """The table and the profiler's CPU event names after the traced
    calls."""
    profiler.reset()
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _traced_calls(model)
    table = profiler.totals()
    profiler.reset()
    return table, {e.name for e in prof.events()}


def test_off_by_default():
    profiler.reset()
    assert not profiler.enabled()
    assert profiler.span("tinynn.a") is profiler.span("tinynn.b")
    x, y = _data(8)
    _model().train_step(x, y)
    profiler.count("k2.steps", 3)
    assert profiler.totals() == {}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_profiler_records_span(traced, name):
    table, events = traced
    parent, count = SPANS[name]
    row = table[name]
    assert row["count"] == count
    assert 0 < row["self_ns"] <= row["ns"]
    if parent is not None:
        assert row["ns"] <= table[parent]["ns"]
    assert name in events


@pytest.mark.parametrize("parent", sorted({p for p, _ in SPANS.values()
                                           if p is not None}))
def test_self_ns_is_the_span_less_its_children(traced, parent):
    table, _ = traced
    children = [n for n, (p, _) in SPANS.items() if p == parent]
    assert table[parent]["self_ns"] == table[parent]["ns"] - sum(
        table[c]["ns"] for c in children)


def test_no_phase_clock_on_the_cpu(traced):
    table, _ = traced
    assert "k2.phase_ns" not in table and "k2.steps" not in table
    assert "tinynn.k2.plan" not in table and "tinynn.k2.launch" not in table
    assert set(table) == set(SPANS)


def test_step_loop_steps_nest_under_the_epoch():
    profiler.reset()
    x, y = _data(8 * STEPS_AN_EPOCH)
    with profiler.recording():
        _model().train_epoch(x, y, batch_size=8, fused=False)
    table = profiler.totals()
    profiler.reset()
    assert table["tinynn.epoch"]["count"] == 1
    assert "tinynn.step" not in table
    parts = ("forward", "loss", "backward", "update")
    for part in parts:
        assert table["tinynn.step." + part]["count"] == STEPS_AN_EPOCH
    assert table["tinynn.epoch"]["self_ns"] == table["tinynn.epoch"]["ns"] \
        - sum(table[n]["ns"] for n in ("tinynn.epoch.tier",
                                       "tinynn.epoch.shuffle")) \
        - sum(table["tinynn.step." + p]["ns"] for p in parts)


def test_recording_fills_the_table_without_the_profiler():
    profiler.reset()
    x, y = _data(8)
    model = _model()
    with profiler.recording():
        assert profiler.enabled()
        assert not torch.autograd.profiler._is_profiler_enabled
        model.train_step(x, y)
        profiler.count("k2.steps", 3)
        profiler.count("k2.steps")
    assert not profiler.enabled()
    model.train_step(x, y)
    table = profiler.totals()
    assert table["tinynn.step"]["count"] == 1
    assert table["k2.steps"] == 4
    profiler.reset()
    assert profiler.totals() == {}


def test_device_counter_is_kept_and_summed_by_key():
    profiler.reset()
    a = profiler.device_counter("k2.phase_ns", ["x", "y"], "cpu")
    assert a.dtype == torch.int64 and a.tolist() == [0, 0]
    assert profiler.device_counter("k2.phase_ns", ("x", "y"), "cpu") is a
    a += torch.tensor([3, 4])
    b = profiler.device_counter("k2.phase_ns", ["x", "z"], "cpu")
    b += torch.tensor([5, 6])
    assert profiler.totals() == {"k2.phase_ns": {"x": 8, "y": 4, "z": 6}}
    profiler.reset()
    assert profiler.totals() == {}
    assert profiler.device_counter("k2.phase_ns", ["x"], "cpu").tolist() == [0]
    profiler.reset()


def test_span_closes_on_an_exception():
    profiler.reset()
    with profiler.recording():
        with pytest.raises(ValueError):
            with profiler.span("tinynn.outer"):
                with profiler.span("tinynn.inner"):
                    raise ValueError("raised inside")
        with profiler.span("tinynn.after"):
            pass
    table = profiler.totals()
    profiler.reset()
    assert table["tinynn.outer"]["count"] == 1
    assert table["tinynn.inner"]["ns"] <= table["tinynn.outer"]["ns"]
    assert table["tinynn.after"]["self_ns"] == table["tinynn.after"]["ns"]


def test_span_names_keep_to_the_rule():
    """Every span the package opens is named ``tinynn.*`` and holds no
    ``_kernel``, which a reader of the trace matches kernels by."""
    root = Path(tinynn_autograd_tpu_torch.__file__).parent
    names = {m for path in root.rglob("*.py") for m in re.findall(
        r"profiler\.span\(\"([^\"]+)\"\)", path.read_text())}
    # the expert language models' spans, which tests/test_torch_mellum.py
    # and tests/test_torch_moonlight.py record
    moe_lm = {"tinynn.moe", "tinynn.moe.route", "tinynn.moe.dispatch",
              "tinynn.moe.experts", "tinynn.moe.combine", "tinynn.attn.rope",
              "tinynn.moe.shared", "tinynn.mla", "tinynn.mla.project",
              "tinynn.mla.rope", "tinynn.mla.attend", "tinynn.mla.out"}
    assert set(SPANS) | {"tinynn.k2.plan", "tinynn.k2.launch"} | moe_lm \
        == names
    assert all(n.startswith("tinynn.") and "_kernel" not in n for n in names)
