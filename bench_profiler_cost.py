#!/usr/bin/env python3
"""What the port's spans and counters (``utils/profiler.py``) cost on the
card, in one process:

1. a span on the host, in ns: off, under ``recording()`` alone, and under
   ``torch.profiler.profile`` (CPU and CUDA activities), 20,000 spans a
   reading;
2. the 6b transformer's ``train_step`` at the ``transformer_6b.train_t256``
   cell's shapes (32 x 256 tokens, dim 512, 8 heads, depth 2, Adam 1e-3)
   under the profiler against ``recording()`` alone, in turns: the
   ``tinynn.step`` span's mean, and the host's wall a step to a
   synchronise; the device-side annotations the profiler records for the
   spans are listed with whether they are marked as annotations;
3. K2's device time a step at the flagship (784-200-100-70-30-10, 390 steps
   of 128, Adam), by CUDA events around one launch queued behind a wait on
   the device, with its phase clock off and on, in turns.

    python3 bench_profiler_cost.py   # ~2 min with the builds

Without a CUDA device it exits 1.
"""

import contextlib
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch.models import (  # noqa: E402
    build_mnist_mlp, build_tiny_transformer,
)
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.ops import fused_epoch  # noqa: E402
from tinynn_autograd_tpu_torch.utils import profiler, seeder  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import one_hot, synthetic_mnist  # noqa: E402

TURNS = 4
SPANS = 20_000
STEPS = 12


def traced():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span_ns(ctx):
    with ctx:
        t0 = time.perf_counter_ns()
        for _ in range(SPANS):
            with profiler.span("tinynn.probe"):
                pass
        return (time.perf_counter_ns() - t0) / SPANS


def steps(model, x, y, ctx):
    """(the tinynn.step mean in ms, the wall a step in ms) over STEPS."""
    profiler.reset()
    with ctx as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            model.train_step(x[i], y[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = profiler.totals()["tinynn.step"]
    profiler.reset()
    return row["ns"] / row["count"] * 1e-6, 1e3 * wall / STEPS, prof


def k2_us(spec, state, xb, yb, scalars, clock):
    params, slots = state
    phase_ns = torch.zeros(len(fused_epoch.phase_names(spec)),
                           dtype=torch.int64, device="cuda") if clock else None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # the device waits while the host prepares the launch, so the events
    # hold the kernel alone
    torch.cuda._sleep(100_000_000)
    start.record()
    fused_epoch.cuda_fused_epoch(spec, params, slots, xb, yb, scalars,
                                 phase_ns=phase_ns)
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / xb.shape[0]


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print("device: %s" % torch.cuda.get_device_name(0))

    readings = {"off": [], "recording": [], "profiler": []}
    for _ in range(TURNS):
        readings["off"].append(span_ns(contextlib.nullcontext()))
        readings["recording"].append(span_ns(profiler.recording()))
        readings["profiler"].append(span_ns(traced()))
    profiler.reset()
    for name, values in readings.items():
        print("span ns %-9s median %.1f of %s" % (
            name, statistics.median(values),
            ", ".join("%.1f" % v for v in values)))

    with seeder.scope(0):
        net = build_tiny_transformer(vocab=256, seq_len=256, dim=512,
                                     heads=8, depth=2, num_out=16,
                                     causal=True, mlp_ratio=4)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (STEPS, 32, 256), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 16, (STEPS, 32), generator=gen, device="cuda"),
        16).float()
    steps(model, x, y, profiler.recording())
    rows = {"recording": [], "profiler": []}
    prof = None
    for turn in range(TURNS):
        order = ("recording", "profiler") if turn % 2 == 0 \
            else ("profiler", "recording")
        for name in order:
            span, wall, got = steps(model, x, y, profiler.recording()
                                    if name == "recording" else traced())
            rows[name].append((span, wall))
            prof = got if name == "profiler" else prof
    for name, values in rows.items():
        print("6b t256 %-9s tinynn.step mean ms %s; wall ms a step %s" % (
            name, ", ".join("%.3f" % s for s, _ in values),
            ", ".join("%.3f" % w for _, w in values)))
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                e.name().startswith("tinynn."):
            key = (e.name(), e.is_user_annotation())
            marks[key] = marks.get(key, 0) + 1
    print("device-side tinynn.* events (name, marked as annotation): %s"
          % sorted(marks.items()))

    with seeder.scope(1):
        mlp = build_mnist_mlp()
    mlp.to("cuda")
    opt = Adam(1e-3)
    spec = fused_epoch.epoch_spec(mlp, opt)
    n_steps = 390
    (xs, ys), _ = synthetic_mnist(n_steps * 128, 10, seed=5)
    xb = torch.from_numpy(xs).cuda().reshape(n_steps, 128, 784)
    yb = torch.from_numpy(one_hot(ys)).cuda().reshape(n_steps, 128, 10)
    scalars = torch.from_numpy(opt.step_scalars(0, n_steps)).cuda()
    params = fused_epoch.dense_leaves(mlp, mlp.params_tree())
    state = opt.init_state(mlp.params_tree())["slots"]
    slots = {k: fused_epoch.dense_leaves(mlp, tree)
             for k, tree in state.items()}
    k2_us(spec, (params, slots), xb, yb, scalars, False)
    us = {False: [], True: []}
    for turn in range(2 * TURNS):
        for clock in ((False, True) if turn % 2 == 0 else (True, False)):
            us[clock].append(k2_us(spec, (params, slots), xb, yb, scalars,
                                   clock))
    for clock, values in us.items():
        print("K2 us a step, phase clock %-3s median %.3f of %s" % (
            "on" if clock else "off", statistics.median(values),
            ", ".join("%.3f" % v for v in values)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
