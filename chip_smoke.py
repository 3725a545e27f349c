#!/usr/bin/env python3
"""Smoke test of the PyTorch package on one NVIDIA GPU.

Drives the port's main path once, at the full width of the flagship MNIST
MLP (784-200-100-70-30-10 Dense+ReLU, softmax-CE, Adam 1e-3, batch 128,
random weights from seed 0, synthetic MNIST at 50,000/10,000):

1. device: the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build: compiles the CUDA matmul kernel from csrc/ (nvcc, sm_90a).
3. kernel vs plain: the kernel against ``matmul_reference`` on the card at
   every shape the main path gives it (the 14 products of a train step,
   transposed views included, the 10,000-row eval product, two ragged
   shapes), in f32 (rtol 1e-5, atol 1e-4) and bf16 (rtol 2e-2, atol 2e-1),
   with per-launch times of both (back to back, and device-only).
4. slice: one train_epoch, 3 eager steps, a predict and an evaluate_batch,
   with the kernel's launch count reset before and read after: it must be
   14 per train step plus 5 per forward. Losses finite and falling, test
   accuracy above 0.5.
5. trace: torch.profiler over 50 train steps: device busy share and the
   kernels that take the device time.
6. parity: 5 train steps on the GPU and 5 on the CPU from the same seeded
   initial weights; losses agree to rtol 1e-5, atol 1e-6.

Prints the card line, one JSON line of kernel results, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available or any phase fails.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch import Tensor  # noqa: E402
from tinynn_autograd_tpu_torch.models import build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator  # noqa: E402
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.ops import kernels  # noqa: E402
from tinynn_autograd_tpu_torch.utils import seeder  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import one_hot, synthetic_mnist  # noqa: E402

BATCH = 128
LAYERS = [(784, 200), (200, 100), (100, 70), (70, 30), (30, 10)]
# (m, k, n, a transposed, b transposed): per layer the forward x @ W, the
# weight gradient x^T @ g, and the input gradient g @ W^T (not for layer 1)
STEP_SHAPES = ([(BATCH, i, o, False, False) for i, o in LAYERS]
               + [(i, BATCH, o, True, False) for i, o in LAYERS]
               + [(BATCH, o, i, False, True) for i, o in LAYERS[1:]])
EVAL_SHAPE = (10000, 784, 200, False, False)
RAGGED = [(130, 129, 131, False, False), (1, 784, 200, False, False)]
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_SOURCE = "tinynn_autograd_tpu_torch/csrc/matmul.cu"
REPLACES = "tinynn_autograd_tpu/ops/kernels.py:122"


def phase(name):
    print("== %s" % name, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def operands(m, k, n, ta, tb, dtype, device, gen):
    """A [m,k] and B [k,n]; a transposed operand is a transposed VIEW of a
    contiguous tensor, as the tape's VJPs pass it."""
    a = torch.randn((k, m) if ta else (m, k), generator=gen)
    b = torch.randn((n, k) if tb else (k, n), generator=gen)
    a = a.to(device, dtype)
    b = b.to(device, dtype)
    return (a.T if ta else a), (b.T if tb else b)


def launch_us(fn, reps=200, warmup=20):
    """Per-launch time of back-to-back calls, host dispatch included (CUDA
    events around ``reps`` calls): what a train step pays for one."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1000.0 / reps


def device_kernels(prof):
    """(device us, launches, name) of every device kernel in a profile."""
    from torch.autograd import DeviceType

    return [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]


def device_us(fn, reps=50):
    """Device time per call: the summed time of the kernels the call ran,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(row[0] for row in device_kernels(prof)) / reps


def check_kernel(device):
    """Kernel vs plain at the main path's shapes. Returns the f32 max abs
    error and the device time (ms) of one train step's 14 products through
    the kernel and through the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    step_us = np.zeros(4)  # kernel launch, plain launch, kernel dev, plain dev
    print("  f32 product              launch us: kernel   plain"
          "   device us: kernel   plain   max_abs_err")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in STEP_SHAPES + [EVAL_SHAPE] + RAGGED:
            a, b = operands(*shape, dtype, device, gen)
            got = kernels.cuda_matmul(a, b)
            torch.cuda.synchronize()
            ref = kernels.matmul_reference(a, b)
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or got.shape != ref.shape:
                raise AssertionError("%s: got %s %s, plain %s %s" % (
                    shape, got.dtype, tuple(got.shape), ref.dtype,
                    tuple(ref.shape)))
            g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
            err = float(np.max(np.abs(g - r)))
            np.testing.assert_allclose(g, r, err_msg=str(shape),
                                       **TOL[dtype])
            worst[dtype] = max(worst[dtype], err)
            if dtype != torch.float32 or shape in RAGGED:
                continue

            def kernel():
                return kernels.cuda_matmul(a, b)

            def plain():
                return kernels.matmul_reference(a, b)

            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (launch_us(f) for f in (plain, kernel, kernel,
                                                     plain))
            times = np.array([(k1 + k2) / 2, (p1 + p2) / 2,
                              device_us(kernel), device_us(plain)])
            if shape != EVAL_SHAPE:
                step_us += times
            m, k, n, ta, tb = shape
            name = "[%d,%d]%s@[%d,%d]%s" % (m, k, "T" if ta else "", k, n,
                                            "T" if tb else "")
            print("  %-24s %15.2f %7.2f %19.2f %7.2f   %.3g"
                  % ((name,) + tuple(times) + (err,)))
    print("kernel vs plain: max_abs_err f32 %.3g (tol rtol 1e-5 atol 1e-4), "
          "bf16 %.3g (tol rtol 2e-2 atol 2e-1)"
          % (worst[torch.float32], worst[torch.bfloat16]))
    print("one train step's 14 products: launch us kernel %.2f plain %.2f; "
          "device us kernel %.2f plain %.2f" % tuple(step_us))
    return worst[torch.float32], step_us[2] / 1000.0, step_us[3] / 1000.0


def eager_step(model, xb, yb):
    model.zero_grad()
    pred = model.forward(xb)
    loss = model.loss.loss(pred, Tensor(yb, device=model.device))
    loss.backward()
    model.step()
    return float(loss.values)


def run_slice(device):
    """The main path; returns the model, its staged data and the launch
    count of the run."""
    seeder.random_seed(0)
    (train_x, train_y), (test_x, test_y) = synthetic_mnist()
    train_y_oh = one_hot(train_y)
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=device)
    x_dev, y_dev = model.stage(train_x, train_y_oh)
    x_test = model.stage(test_x)
    torch.cuda.synchronize()

    kernels.cuda_matmul.launches = 0
    t0 = time.perf_counter()
    losses = model.train_epoch(x_dev, y_dev, batch_size=BATCH)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    eager = [eager_step(model, train_x[i * BATCH:(i + 1) * BATCH],
                        train_y_oh[i * BATCH:(i + 1) * BATCH])
             for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model.predict(x_test)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    res = model.evaluate_batch(test_x, test_y, AccEvaluator)
    launches = kernels.cuda_matmul.launches

    n_steps = int(losses.shape[0])
    expected = 14 * (n_steps + len(eager)) + 5 * 2
    trace = losses.cpu().numpy()
    print("train_epoch: %d steps in %.3f s = %.1f steps/s (batch %d, "
          "incl. the first step)" % (n_steps, epoch_s, n_steps / epoch_s,
                                     BATCH))
    print("losses: first %.5f last %.5f; eager steps %s"
          % (trace[0], trace[-1], ["%.5f" % v for v in eager]))
    print("eval forward %s -> %s: %.3f ms; accuracy %.4f"
          % (tuple(x_test.shape), tuple(logits.shape), predict_s * 1000.0,
             res["accuracy"]))
    print("matmul launches: %d (expected 14 x %d train steps + 5 x 2 "
          "forwards = %d)" % (launches, n_steps + len(eager), expected))
    if launches != expected:
        raise AssertionError("launch count %d != %d" % (launches, expected))
    if not (np.all(np.isfinite(trace)) and np.all(np.isfinite(eager))):
        raise AssertionError("non-finite loss")
    if not trace[-1] < trace[0]:
        raise AssertionError("loss did not fall: %s -> %s"
                             % (trace[0], trace[-1]))
    if not res["accuracy"] > 0.5:
        raise AssertionError("test accuracy %.4f <= 0.5" % res["accuracy"])
    if tuple(logits.shape) != (len(test_x), 10) or not torch.isfinite(
            logits.data).all():
        raise AssertionError("bad eval logits")
    return model, x_dev, y_dev, launches


def run_trace(model, x_dev, y_dev, steps=50):
    """Device busy share and the top kernels over ``steps`` train steps."""
    from torch.profiler import ProfilerActivity, profile

    xs = x_dev[:steps * BATCH].reshape(steps, BATCH, -1)
    ys = y_dev[:steps * BATCH].reshape(steps, BATCH, -1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.train_step(xs[i], ys[i])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(device_kernels(prof), reverse=True)
    busy_us = sum(r[0] for r in rows)
    print("trace: %d steps, wall %.1f us/step under the profiler, %d "
          "kernel launches/step" % (steps, wall_us / steps,
                                    sum(r[1] for r in rows) // steps))
    if busy_us == 0:
        print("trace: device time not measured (the profiler saw no device "
              "kernels)")
        return
    print("trace: device busy %.1f us/step = %.1f%% of wall (idle %.1f%%)"
          % (busy_us / steps, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us))
    for dev_us, count, key in rows[:8]:
        print("  %8.2f us/step  %3d launches/step  %s"
              % (dev_us / steps, count // steps, key[:80]))


def run_parity(device):
    (x, y), _ = synthetic_mnist(5 * BATCH, 10)
    y = one_hot(y)
    models = []
    for dev in (device, torch.device("cpu")):
        with seeder.scope(1):
            net = build_mnist_mlp()
        models.append(Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3),
                            device=dev))
    gpu, cpu = models
    for i in range(5):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        lg, lc = float(gpu.train_step(xb, yb)), float(cpu.train_step(xb, yb))
        print("  step %d  gpu %.7f  cpu %.7f  rel %.2e"
              % (i, lg, lc, abs(lg - lc) / abs(lc)))
        np.testing.assert_allclose(lg, lc, err_msg="step %d" % i, **LOSS_TOL)


def main():
    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    print("card: %s; torch %s, CUDA %s" % (card, torch.__version__,
                                          torch.version.cuda))

    phase("build")
    t0 = time.perf_counter()
    path, log = kernels.build_matmul()
    print("built %s in %.2f s" % (path.name, time.perf_counter() - t0))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: %s" % line.strip())

    phase("kernel vs plain")
    max_err, ms, plain_ms = check_kernel(device)

    phase("slice")
    model, x_dev, y_dev, launches = run_slice(device)

    phase("trace")
    run_trace(model, x_dev, y_dev)

    phase("parity gpu vs cpu")
    run_parity(device)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
