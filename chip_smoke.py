#!/usr/bin/env python3
"""Smoke test of the PyTorch package on one NVIDIA GPU.

Drives the port's main path, at the full width of the flagship MNIST MLP
(784-200-100-70-30-10 Dense+ReLU, softmax-CE, Adam 1e-3, batch 128, random
weights from seed 0, synthetic MNIST at 50,000/10,000), through both of its
kernels: K1, the matmul (csrc/matmul.cu), and K2, the whole-epoch kernel
(csrc/fused_epoch.cu).

1. device: the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build: compiles both kernels from csrc/ (one nvcc each, started
   together; sm_90a) and prints their registers, shared memory and spills.
3. kernel vs plain: K1 against ``matmul_reference`` on the card at every
   shape the main path gives it (the 14 products of a train step,
   transposed views included, the 10,000-row eval product, two ragged
   shapes), in f32 (rtol 1e-5, atol 1e-4) and bf16 (rtol 2e-2, atol 2e-1),
   with per-launch times of both (back to back, and device-only).
4. fused epoch vs plain: K2 against ``fused_epoch_reference`` on the card
   for 10 flagship steps from pinned seed-1 weights: losses (rtol 1e-5,
   atol 1e-6), parameters, Adam slots and the step count (rtol 1e-4, atol
   1e-5); a second run from the same state must give bit-identical losses;
   under bf16 matmul precision losses within rtol 1e-3 that differ from the
   f32 run. Then both times at the main path's shape, a 390-step epoch,
   and the kernel's time in each of its phases.
5. slice: one epoch with ``fused="auto"``, which must be one K2 launch and
   no K1 launch, test accuracy above 0.9, then a second K2 epoch, timed.
   From the same seed in a fresh model, one ``fused=False`` epoch (the
   step loop), 3 eager steps, a predict and an evaluate_batch: K1 must be
   launched 14 times per train step plus 5 per forward, and K2 never.
   Each path's launch counts are set to 0 before it and read after it.
   Both epochs' steps/s; the two accuracies within 0.02.
6. trace: torch.profiler over 50 step-loop train steps (device busy share,
   the kernels that take the device time), and over one K2 epoch.
7. parity: 5 train steps on the GPU and 5 on the CPU from the same seeded
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch import Tensor  # noqa: E402
from tinynn_autograd_tpu_torch.models import build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator  # noqa: E402
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.ops import fused_epoch, kernels  # noqa: E402
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
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
# The data of the 10-step K2 parity check. Adam turns a weight gradient whose
# terms nearly cancel (or a ReLU input within rounding of 0) into a full-size
# step, so two f32 summation orders can leave a few weights 1e-5 apart; the
# seed is pinned to data that has no such weight (PERF.md).
PARITY_DATA_SEED = 5
EPOCH_STEPS = 390  # a flagship epoch: 50,000 samples at batch 128
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): f32 FMA
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def phase(name):
    print("== %s" % name, flush=True)


def bound(flops, n_bytes):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def product_cost(m, k, n):
    """FLOPs and bytes of one f32 [m,k] @ [k,n]: each input read once, the
    output written once."""
    return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)


def epoch_cost(spec, n_steps, batch):
    """FLOPs and bytes of a whole-epoch kernel launch. FLOPs: the products
    (forward, weight gradients, input gradients but the first layer's);
    the elementwise work (activations, loss, optimizer, about 2% more) is
    left out, so the bound is a little low. Bytes: the batches, the losses,
    and the parameters and Adam slots read once and written once."""
    macs = [d_in * d_out for d_in, d_out, _ in spec.layers]
    flops = 2.0 * batch * (2 * sum(macs) + sum(macs[1:])) * n_steps
    leaves = sum(d_in * d_out + d_out for d_in, d_out, _ in spec.layers)
    n_state = 3 if spec.optimizer == fused_epoch.OPT_ADAM else 1
    n_bytes = 4.0 * (n_steps * batch * (spec.layers[0][0] + spec.layers[-1][1])
                     + n_steps + 2 * n_state * leaves)
    return flops, n_bytes


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


def device_us(fn, reps=50, attempts=3):
    """Device time per call: the summed time of the kernels the call ran,
    from torch.profiler. A profile that saw no device kernel is taken
    again; after ``attempts`` such profiles the measurement fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(row[0] for row in device_kernels(prof))
        if total > 0:
            return total / reps
    raise AssertionError("the profiler saw no device kernel in %d tries"
                         % attempts)


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
          "   device us: kernel   plain   max_abs_err   bound us")
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
            print("  %-24s %15.2f %7.2f %19.2f %7.2f   %-11.3g %.3f"
                  % ((name,) + tuple(times)
                     + (err, 1e3 * bound(*product_cost(m, k, n))[0])))
    print("kernel vs plain: max_abs_err f32 %.3g (tol rtol 1e-5 atol 1e-4), "
          "bf16 %.3g (tol rtol 2e-2 atol 2e-1)"
          % (worst[torch.float32], worst[torch.bfloat16]))
    print("one train step's 14 products: launch us kernel %.2f plain %.2f; "
          "device us kernel %.2f plain %.2f" % tuple(step_us))
    return worst[torch.float32], step_us[2] / 1000.0, step_us[3] / 1000.0


def fresh_state(net, opt):
    """Copies of the net's parameters and zero Adam slots, as trees."""
    params = [{k: v.clone() for k, v in d.items()} for d in net.params_tree()]
    return params, opt.init_state(params)["slots"]


def leaves_of(params, slots):
    return [v for tree in [params] + [slots[k] for k in sorted(slots)]
            for d in tree for _, v in sorted(d.items())]


def epoch_ms(fn, reps):
    """Time per call of ``fn``, between CUDA events over ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_fused_epoch(device):
    """K2 against ``fused_epoch_reference`` on the card: 10 flagship steps
    from pinned seed-1 weights, in f32 and bf16, and a rerun for
    determinism; then both timed over a 390-step epoch. Returns the f32 max
    abs error, the kernel's and the plain version's ms per epoch, and the
    spec."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with seeder.scope(1):
        net = build_mnist_mlp().to(device)
    opt, loss = Adam(1e-3), SoftmaxCrossEntropyLoss()
    spec = fused_epoch.epoch_spec(net, opt)
    n = 10
    (x, y), _ = synthetic_mnist(n * BATCH, 10, seed=PARITY_DATA_SEED)
    xb = torch.from_numpy(x).to(device).reshape(n, BATCH, 784)
    yb = torch.from_numpy(one_hot(y)).to(device).reshape(n, BATCH, 10)
    scalars = torch.from_numpy(opt.step_scalars(0, n)).to(device)
    epoch_fn = fused_epoch.build_fused_epoch(net, loss, opt, n, (BATCH, 784),
                                             (BATCH, 10))

    def kernel_run():
        params, slots = fresh_state(net, opt)
        t, losses = epoch_fn(params, slots, 0, xb, yb)
        torch.cuda.synchronize()
        return t, losses.cpu().numpy(), leaves_of(params, slots)

    def plain_run(bf16=False):
        params, slots = fresh_state(net, opt)
        losses = fused_epoch.fused_epoch_reference(
            spec, fused_epoch.dense_leaves(net, params),
            {k: fused_epoch.dense_leaves(net, v) for k, v in slots.items()},
            xb, yb, scalars, bf16=bf16)
        return n, losses.cpu().numpy(), leaves_of(params, slots)

    t_k, loss_k, state_k = kernel_run()
    t_r, loss_r, state_r = plain_run()
    if t_k != t_r:
        raise AssertionError("step count %d, plain %d" % (t_k, t_r))
    np.testing.assert_allclose(loss_k, loss_r, err_msg="losses", **LOSS_TOL)
    worst = float(np.max(np.abs(loss_k - loss_r)))
    for i, (a, b) in enumerate(zip(state_k, state_r)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, err_msg="state leaf %d" % i,
                                   **STATE_TOL)
        worst = max(worst, float(np.max(np.abs(a - b))))
    print("f32, %d steps: losses %s; max abs err over losses, parameters "
          "and slots %.3g (tol losses rtol 1e-5 atol 1e-6, state rtol 1e-4 "
          "atol 1e-5); t %d" % (n, np.array2string(loss_k, precision=5),
                                worst, t_k))
    _, loss_k2, state_k2 = kernel_run()
    if not (np.array_equal(loss_k, loss_k2) and all(
            torch.equal(a, b) for a, b in zip(state_k, state_k2))):
        raise AssertionError("two runs from the same state differ")
    print("rerun from the same state: losses and state bit-identical")
    kernels.set_matmul_precision("bf16")
    try:
        _, bf_k, _ = kernel_run()
        _, bf_r, _ = plain_run(bf16=True)
    finally:
        kernels.set_matmul_precision("f32")
    np.testing.assert_allclose(bf_k, bf_r, rtol=1e-3, atol=1e-4,
                               err_msg="bf16 losses")
    moved = float(np.max(np.abs(bf_k - loss_k)))
    print("bf16: max abs err of losses %.3g (tol rtol 1e-3 atol 1e-4); they "
          "differ from the f32 run by up to %.3g"
          % (float(np.max(np.abs(bf_k - bf_r))), moved))
    if not moved > 1e-5:
        raise AssertionError("bf16 precision did not change the losses")

    # the main path's shape: one 390-step epoch
    (x, y), _ = synthetic_mnist(EPOCH_STEPS * BATCH, 10)
    xe = torch.from_numpy(x).to(device).reshape(EPOCH_STEPS, BATCH, 784)
    ye = torch.from_numpy(one_hot(y)).to(device).reshape(EPOCH_STEPS, BATCH,
                                                           10)
    se = torch.from_numpy(opt.step_scalars(0, EPOCH_STEPS)).to(device)
    params, slots = fresh_state(net, opt)
    pairs = (fused_epoch.dense_leaves(net, params),
             {k: fused_epoch.dense_leaves(net, v) for k, v in slots.items()})

    def kernel():
        fused_epoch.cuda_fused_epoch(spec, *pairs, xe, ye, se)

    def plain():
        fused_epoch.fused_epoch_reference(spec, *pairs, xe, ye, se)

    kernel()  # warm-up
    # in turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = (epoch_ms(plain, 1), epoch_ms(kernel, 3),
                      epoch_ms(kernel, 3), epoch_ms(plain, 1))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    bound_ms, bound_by = bound(*epoch_cost(spec, EPOCH_STEPS, BATCH))
    print("a %d-step epoch: kernel %.3f ms (%.2f us/step; turns %.3f, "
          "%.3f), plain %.1f ms (turns %.1f, %.1f); bound %.3f ms "
          "(%s-bound), kernel at %.2f%% of it"
          % (EPOCH_STEPS, ms, 1e3 * ms / EPOCH_STEPS, k1, k2, plain_ms, p1, p2,
             bound_ms, bound_by, 100.0 * bound_ms / ms))
    # where the time goes: block 0's clock at each barrier, one more epoch
    phase_ns = torch.zeros(2 * len(spec.layers) + 2, dtype=torch.int64,
                           device=device)
    fused_epoch.cuda_fused_epoch(spec, *pairs, xe, ye, se, phase_ns=phase_ns)
    per_step = phase_ns.cpu().numpy() / 1e3 / EPOCH_STEPS
    print("by phase, us/step (block 0's clock, barrier wait included): "
          + ", ".join("%s %.2f" % (name, t) for name, t in
                      zip(fused_epoch.phase_names(spec), per_step))
          + "; sum %.2f" % per_step.sum())
    return worst, ms, plain_ms, spec


def eager_step(model, xb, yb):
    model.zero_grad()
    pred = model.forward(xb)
    loss = model.loss.loss(pred, Tensor(yb, device=model.device))
    loss.backward()
    model.step()
    return float(loss.values)


def run_fused_slice(device):
    """The main path through K2: ``train_epoch`` with ``fused="auto"``
    from seed 0, then an evaluate_batch, then a second epoch, timed (the
    first includes loading the kernel). Returns the model, its staged data,
    the test accuracy after the first epoch, the launch counts, the second
    epoch's steps/s and the first epoch's losses."""
    seeder.random_seed(0)
    (train_x, train_y), (test_x, test_y) = synthetic_mnist()
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=device)
    x_dev, y_dev = model.stage(train_x, one_hot(train_y))
    torch.cuda.synchronize()

    kernels.cuda_matmul.launches = 0
    fused_epoch.cuda_fused_epoch.launches = 0
    t0 = time.perf_counter()
    losses = model.train_epoch(x_dev, y_dev, batch_size=BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    after_epoch = (fused_epoch.cuda_fused_epoch.launches,
                   kernels.cuda_matmul.launches)
    res = model.evaluate_batch(test_x, test_y, AccEvaluator)
    t0 = time.perf_counter()
    losses2 = model.train_epoch(x_dev, y_dev, batch_size=BATCH)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {"fused_epoch": fused_epoch.cuda_fused_epoch.launches,
                "matmul": kernels.cuda_matmul.launches}

    n_steps = int(losses.shape[0])
    trace = torch.cat([losses, losses2]).cpu().numpy()
    print("fused='auto' epoch 1: %d steps in %.4f s (first launch "
          "included); fused_epoch launches %d, matmul launches %d"
          % ((n_steps, first_s) + after_epoch))
    print("fused='auto' epoch 2: %d steps in %.4f s = %.1f steps/s = "
          "%.2f us/step (batch %d)" % (n_steps, epoch_s, n_steps / epoch_s,
                                      1e6 * epoch_s / n_steps, BATCH))
    print("losses: first %.5f, end of epoch 1 %.5f, end of epoch 2 %.5f; "
          "accuracy after epoch 1 %.4f" % (trace[0], trace[n_steps - 1],
                                           trace[-1], res["accuracy"]))
    print("launches over the path: fused_epoch %d (expected 2), matmul %d "
          "(expected 5: one eval forward)" % (launches["fused_epoch"],
                                              launches["matmul"]))
    if after_epoch != (1, 0):
        raise AssertionError("fused='auto' epoch made %d fused_epoch and %d "
                             "matmul launches, expected 1 and 0"
                             % after_epoch)
    if launches != {"fused_epoch": 2, "matmul": 5}:
        raise AssertionError("launch counts %s" % launches)
    if not np.all(np.isfinite(trace)):
        raise AssertionError("non-finite loss")
    if not trace[-1] < trace[0]:
        raise AssertionError("loss did not fall: %s -> %s"
                             % (trace[0], trace[-1]))
    if not res["accuracy"] > 0.9:
        raise AssertionError("test accuracy %.4f <= 0.9" % res["accuracy"])
    return (model, x_dev, y_dev, res["accuracy"], launches,
            n_steps / epoch_s, trace[:n_steps])


def run_step_slice(device):
    """The main path through the step loop (``fused=False``), K1 in every
    product, from the same seed and initial weights as
    ``run_fused_slice``. Returns the model, its staged data, the test
    accuracy, the launch counts, the epoch's steps/s and its losses."""
    seeder.random_seed(0)
    (train_x, train_y), (test_x, test_y) = synthetic_mnist()
    train_y_oh = one_hot(train_y)
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=device)
    x_dev, y_dev = model.stage(train_x, train_y_oh)
    x_test = model.stage(test_x)
    torch.cuda.synchronize()

    kernels.cuda_matmul.launches = 0
    fused_epoch.cuda_fused_epoch.launches = 0
    t0 = time.perf_counter()
    losses = model.train_epoch(x_dev, y_dev, batch_size=BATCH, fused=False)
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
    launches = {"fused_epoch": fused_epoch.cuda_fused_epoch.launches,
                "matmul": kernels.cuda_matmul.launches}

    n_steps = int(losses.shape[0])
    expected = 14 * (n_steps + len(eager)) + 5 * 2
    trace = losses.cpu().numpy()
    print("fused=False epoch: %d steps in %.4f s = %.1f steps/s = %.2f "
          "us/step (batch %d, incl. the first step)"
          % (n_steps, epoch_s, n_steps / epoch_s, 1e6 * epoch_s / n_steps,
             BATCH))
    print("losses: first %.5f last %.5f; eager steps %s"
          % (trace[0], trace[-1], ["%.5f" % v for v in eager]))
    print("eval forward %s -> %s: %.3f ms; accuracy %.4f"
          % (tuple(x_test.shape), tuple(logits.shape), predict_s * 1000.0,
             res["accuracy"]))
    print("matmul launches: %d (expected 14 x %d train steps + 5 x 2 "
          "forwards = %d); fused_epoch launches %d (expected 0)"
          % (launches["matmul"], n_steps + len(eager), expected,
             launches["fused_epoch"]))
    if launches != {"fused_epoch": 0, "matmul": expected}:
        raise AssertionError("launch counts %s, expected matmul %d and no "
                             "fused_epoch" % (launches, expected))
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
    return (model, x_dev, y_dev, res["accuracy"], launches,
            n_steps / epoch_s, trace)


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


def run_fused_trace(model, x_dev, y_dev):
    """Device time and busy share of one K2 epoch (``fused="auto"``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_epoch(x_dev, y_dev, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(device_kernels(prof), reverse=True)
    busy_us = sum(r[0] for r in rows)
    k2_us = sum(r[0] for r in rows if "fused_epoch" in r[2])
    print("trace, K2 epoch: wall %.1f us under the profiler, %d kernel "
          "launches" % (wall_us, sum(r[1] for r in rows)))
    if busy_us == 0:
        print("trace, K2 epoch: device time not measured (the profiler saw "
              "no device kernels)")
        return
    print("trace, K2 epoch: device busy %.1f us = %.1f%% of wall (idle "
          "%.1f%%); the fused_epoch kernel %.1f us = %.2f us/step"
          % (busy_us, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us, k2_us, k2_us / EPOCH_STEPS))
    for dev_us, count, key in rows[:5]:
        print("  %10.2f us  %3d launches  %s" % (dev_us, count, key[:80]))


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
    names = ("matmul", "fused_epoch")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(kernels.build_library, names))
    print("built both kernels in %.2f s (one nvcc each, in parallel)"
          % (time.perf_counter() - t0))
    for path, log in built:
        print("  %s" % path.name)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas: %s" % line.strip())
    per_sm, sms = fused_epoch.kernel_grid()
    print("fused_epoch grid: %d blocks/SM x %d SMs = %d blocks of 256 threads"
          % (per_sm, sms, per_sm * sms))

    phase("kernel vs plain")
    k1_err, k1_ms, k1_plain_ms = check_kernel(device)
    k1_cost = np.sum([product_cost(m, k, n) for m, k, n, _, _ in STEP_SHAPES],
                     axis=0)
    k1_bound_ms, k1_bound_by = bound(*k1_cost)
    print("one train step's 14 products: bound %.5f ms (%s-bound: %.4g "
          "MFLOP, %.4g MB); kernel at %.2f%% of it"
          % (k1_bound_ms, k1_bound_by, k1_cost[0] / 1e6, k1_cost[1] / 1e6,
             100.0 * k1_bound_ms / k1_ms))

    phase("fused epoch vs plain")
    k2_err, k2_ms, k2_plain_ms, spec = check_fused_epoch(device)
    k2_bound_ms, k2_bound_by = bound(*epoch_cost(spec, EPOCH_STEPS, BATCH))

    phase("slice")
    (fmodel, fx, fy, f_acc, f_launches, f_rate,
     f_trace) = run_fused_slice(device)
    (smodel, sx, sy, s_acc, s_launches, s_rate,
     s_trace) = run_step_slice(device)
    print("same call: fused='auto' (K2) %.1f steps/s, fused=False (step "
          "loop) %.1f steps/s, ratio %.2f; accuracies %.4f and %.4f"
          % (f_rate, s_rate, f_rate / s_rate, f_acc, s_acc))
    gap = np.abs(f_trace - s_trace)
    print("the two epochs' losses (same weights, same batches): max abs "
          "difference %.3g over steps 0-9, %.3g over steps 0-99, %.3g over "
          "all %d" % (gap[:10].max(), gap[:100].max(), gap.max(), len(gap)))
    if abs(f_acc - s_acc) > 0.02:
        raise AssertionError("accuracies %.4f (K2) and %.4f (step loop) "
                             "differ by more than 0.02" % (f_acc, s_acc))

    phase("trace")
    run_trace(smodel, sx, sy)
    run_fused_trace(fmodel, fx, fy)

    phase("parity gpu vs cpu")
    run_parity(device)

    print(card)
    print(json.dumps({"kernels": [
        {"name": "matmul", "route": "cuda",
         "source": "tinynn_autograd_tpu_torch/csrc/matmul.cu",
         "replaces": "tinynn_autograd_tpu/ops/kernels.py:122",
         "launches": f_launches["matmul"] + s_launches["matmul"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by,
         "library_ms": k1_plain_ms},
        {"name": "fused_epoch", "route": "cuda",
         "source": "tinynn_autograd_tpu_torch/csrc/fused_epoch.cu",
         "replaces": "tinynn_autograd_tpu/ops/fused_epoch.py:159",
         "launches": f_launches["fused_epoch"] + s_launches["fused_epoch"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_ms, "bound_by": k2_bound_by,
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
