#!/usr/bin/env python3
"""K1, P3 and K2 with K6 beside the design they replaced, on one CUDA card.

Times this tree's matmul (K1), ring all-reduce (P3) and whole-epoch kernel
over ranks (K2 with its gradient exchange, K6) beside the kernels of a
parent checkout of the repository, built from that checkout's sources in
the same process and timed in turns with this tree's (this, parent,
parent, this; CUDA events):

- K1 at the products of a flagship train step (14), the 10,000-row eval,
  a config-8 step (10, on a config-8 step's own operands) and a 6b step
  (3), each beside torch.matmul (cuBLAS, f32, TF32 off);
- P3 at 2, 3, 4 and 16 ranks of the flagship's 186,610 gradient floats,
  beside torch.stack(xs).sum(0); the parent's result must equal this
  tree's bit for bit;
- K2 with K6, a 390-step epoch of the flagship on 4 ranks of 32 rows, and
  both kernels' time by phase (rank 0's block 0): the ring phase, and the
  last backward plus the ring;
- single-rank K2, a 390-step epoch, and both by phase;
- the paths K1 serves, with every 2-D product on the card through this
  tree's K1 or the parent's: config 8's train steps/s (two LSTM layers of
  256, T = 128, batch 64), the flagship's step loop (``fused=False``) and
  its 10,000-row eval forward (wall time, ``torch.cuda.synchronize``).

The parent is the design before the exchange and split-K: its K1 takes
(a, b, c, m, n, k, four int strides, two dtypes, stream), its P3 and K2
the naive ring's comm slots and four counts a rank. Unpack it into a
git-ignored directory and point --parent there:

    mkdir -p _parent && git archive <commit> | tar -x -C _parent
    python3 bench_vs_parent.py --parent _parent   # ~2 min with the builds

Without a CUDA device it exits 1.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke  # noqa: E402
from tinynn_autograd_tpu_torch.models import build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.ops import (  # noqa: E402
    fused_epoch, kernels, ring_allreduce,
)
from tinynn_autograd_tpu_torch.utils import seeder  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import one_hot, synthetic_mnist  # noqa: E402
from tinynn_autograd_tpu_torch.utils.timing import device_us  # noqa: E402

NAMES = ("matmul", "ring_allreduce", "fused_epoch")
RING_RANKS = (2, 3, 4, 16)


def build_parent(root, pool):
    """The parent checkout's three libraries, one nvcc each on ``pool``,
    into this tree's git-ignored build directory, bound as its wrappers
    bound them."""
    csrc = Path(root) / "tinynn_autograd_tpu_torch" / "csrc"
    nvcc = kernels._find_nvcc()
    kernels.BUILD_DIR.mkdir(exist_ok=True)

    def build(name):
        out = kernels.BUILD_DIR / ("libtinynn_parent_%s.so" % name)
        proc = subprocess.run(
            kernels.nvcc_command(nvcc, csrc / ("%s.cu" % name), out),
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed building the parent's %s:\n%s"
                               % (name, proc.stderr))
        return ctypes.CDLL(str(out))

    libs = dict(zip(NAMES, pool.map(build, NAMES)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs["matmul"].tinynn_matmul.argtypes = [ptr] * 3 + [i32] * 9 + [ptr]
    libs["matmul"].tinynn_matmul.restype = i32
    libs["ring_allreduce"].tinynn_ring_all_reduce.argtypes = [
        i32, ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.c_longlong,
        ptr, ptr, i32, ctypes.c_longlong, ptr]
    libs["ring_allreduce"].tinynn_ring_all_reduce.restype = i32
    fused_epoch._bind(libs["fused_epoch"], ctypes)
    types = list(libs["fused_epoch"].tinynn_fused_epoch.argtypes)
    types[17] = ptr  # the comm slots, where this tree passes grad_stride
    libs["fused_epoch"].tinynn_fused_epoch.argtypes = types
    return libs


def parent_matmul(lib, a, b):
    out = torch.empty((a.shape[0], b.shape[1]),
                      dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    err = lib.tinynn_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1],
        a.shape[1], a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        kernels._KERNEL_DTYPES[a.dtype], kernels._KERNEL_DTYPES[b.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("the parent's matmul failed: CUDA error %d" % err)
    return out


def parent_ring(lib, xs):
    """The parent's P3 as its wrapper called it: comm slots and zeroed
    counts made in the call."""
    n, length = len(xs), xs[0].numel()
    out = torch.empty((n, length), device=xs[0].device)
    comm = torch.empty((n, 2, length), device=xs[0].device)
    sync = torch.zeros(n * 4, dtype=torch.int32, device=xs[0].device)
    ptrs = ctypes.c_void_p * n
    err = lib.tinynn_ring_all_reduce(
        n, ptrs(*[x.data_ptr() for x in xs]),
        ptrs(*[o.data_ptr() for o in out]), length, comm.data_ptr(),
        sync.data_ptr(), -1, 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("the parent's ring failed: CUDA error %d" % err)
    return list(out.unbind(0))


class ParentFusedEpoch:
    """The parent's K2 behind this tree's wrapper: it takes the call
    ``ops/fused_epoch.py`` makes and gives the parent's kernel the
    arguments it took, the gradients as [n_ranks, n_grad] rows (each
    layer's gw and gb pointed there), the ring's comm slots and four counts
    a rank in place of this tree's planes and two counts. Every other
    function is the parent's library's."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def tinynn_fused_epoch(self, n_ranks, n_layers, dims, drops, scales,
                           ptrs, *args):
        (tables, xb, yb, cw, scalars, losses, row_loss, partial,
         partial_len, _, n_grad, _, _) = args[:13]
        grads = torch.empty((n_ranks, n_grad), device="cuda")
        comm = torch.empty((n_ranks, 2, n_grad), device="cuda")
        sync = torch.zeros(n_ranks * 4, dtype=torch.int32, device="cuda")
        for r in range(n_ranks):
            offset = 0
            for l in range(n_layers):
                d_in, d_out = dims[4 * l], dims[4 * l + 1]
                at = 12 * (r * n_layers + l)
                ptrs[at + 2] = grads[r, offset].data_ptr()
                offset += d_in * d_out
                ptrs[at + 3] = grads[r, offset].data_ptr()
                offset += d_out
        # the buffers stay alive until the launch is queued; later work on
        # the stream may reuse them
        return self.lib.tinynn_fused_epoch(
            n_ranks, n_layers, dims, drops, scales, ptrs, tables, xb, yb, cw,
            scalars, losses, row_loss, partial, partial_len,
            grads.data_ptr(), n_grad, comm.data_ptr(), sync.data_ptr(),
            *args[13:])


class parent_k2:
    """Within it, ``fused_epoch``'s wrappers launch the parent's K2."""

    def __init__(self, lib):
        self.shim = ParentFusedEpoch(lib)

    def __enter__(self):
        fused_epoch.kernel_grid()  # this tree's library, loaded
        self.saved = kernels._loaded["fused_epoch"]
        kernels._loaded["fused_epoch"] = self.shim

    def __exit__(self, *exc):
        kernels._loaded["fused_epoch"] = self.saved


class parent_k1:
    """Within it, every 2-D product on the card (``kernels.matmul``)
    launches the parent's K1."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = kernels.cuda_matmul
        kernels.cuda_matmul = lambda a, b: parent_matmul(self.lib, a, b)

    def __exit__(self, *exc):
        kernels.cuda_matmul = self.saved


def in_turns(mine, parents):
    """(mine's mean, the parent's mean) of ``device_us``, in turns mine,
    parent's, parent's, mine."""
    t = [device_us(f) for f in (mine, parents, parents, mine)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def bench_products(libs, device):
    print("== K1: device us a product: this tree's, the parent's, cuBLAS "
          "(f32, TF32 off), the bound")
    gen = torch.Generator().manual_seed(0)
    groups = (
        ("one flagship train step's 14 products", smoke.STEP_SHAPES, None),
        ("the 10,000-row eval product", [smoke.EVAL_SHAPE], None),
        ("one config-8 step's 10 products", smoke.CONFIG8_SHAPES,
         smoke.config8_operands(device)),
        ("one 6b step's 3 products", smoke.CONFIG6B_SHAPES, None))
    for what, shapes, pairs in groups:
        if pairs is None:
            pairs = [smoke.operands(*s, torch.float32, device, gen)
                     for s in shapes]
        total = np.zeros(4)
        for shape, (a, b) in zip(shapes, pairs):
            mine, parents = in_turns(
                lambda: kernels.cuda_matmul(a, b),
                lambda: parent_matmul(libs["matmul"], a, b))
            m, k, n = shape[:3]
            times = np.array([
                mine, parents, device_us(lambda: torch.matmul(a, b)),
                1e3 * smoke.bound(*smoke.product_cost(m, k, n))[0]])
            total += times
            print("  %-24s %9.2f %9.2f %9.2f %9.3f"
                  % ((smoke.product_name(*shape),) + tuple(times)))
        print("%s: this tree's %.2f us, the parent's %.2f, cuBLAS %.2f; "
              "bound %.3f us; this tree's %.2fx cuBLAS's time, %.2fx faster "
              "than the parent's" % ((what,) + tuple(total)
                                     + (total[0] / total[2],
                                        total[1] / total[0])))


def bench_ring(libs, device):
    print("== P3: device us a call (whole calls)")
    n_grad = sum(d_in * d_out + d_out for d_in, d_out in smoke.LAYERS)
    gen = torch.Generator().manual_seed(0)
    for r in RING_RANKS:
        xs = [(1e-3 * torch.randn(n_grad, generator=gen)).to(device)
              for _ in range(r)]
        got = ring_allreduce.cuda_ring_all_reduce(xs)
        if not all(torch.equal(g, p) for g, p in
                   zip(got, parent_ring(libs["ring_allreduce"], xs))):
            raise AssertionError("%d ranks: the two rings differ" % r)
        mine, parents = in_turns(
            lambda: ring_allreduce.cuda_ring_all_reduce(xs),
            lambda: parent_ring(libs["ring_allreduce"], xs))
        lib = device_us(lambda: torch.stack(xs).sum(0))
        bound_ms, bound_by = smoke.bound(*smoke.ring_cost(r, n_grad))
        print("  %2d x [%d]: this tree's %.2f us, the parent's %.2f us, "
              "torch.stack(xs).sum(0) %.2f us; bound %.3f us (%s); this "
              "tree's %.2fx the library call's time, %.2fx faster than the "
              "parent's" % (r, n_grad, mine, parents, lib, 1e3 * bound_ms,
                            bound_by, mine / lib, parents / mine))


def by_phase(what, names, run, device, n_steps):
    phase_ns = torch.zeros(len(names), dtype=torch.int64, device=device)
    run(phase_ns=phase_ns)
    per_step = phase_ns.cpu().numpy() / 1e3 / n_steps
    print("  %s by phase, us/step: " % what
          + ", ".join("%s %.2f" % (name, t) for name, t in
                      zip(names, per_step))
          + "; sum %.2f" % per_step.sum())
    return dict(zip(names, per_step))


def bench_epochs(libs, device):
    steps = smoke.EPOCH_STEPS
    print("== K2 with K6 (%d ranks of %d rows) and single-rank K2: a "
          "%d-step epoch of the flagship" % (smoke.DP_RANKS, smoke.DP_LOCAL,
                                            steps))
    with seeder.scope(1):
        net = build_mnist_mlp().to(device)
    opt = Adam(1e-3)
    spec = fused_epoch.epoch_spec(net, opt)
    (x, y), _ = synthetic_mnist(steps * smoke.BATCH, 10)
    xg = torch.from_numpy(x).to(device).reshape(steps, smoke.BATCH, 784)
    yg = torch.from_numpy(one_hot(y)).to(device).reshape(steps, smoke.BATCH,
                                                          10)
    xe, ye = smoke.rank_shards(xg, yg)
    se = torch.from_numpy(opt.step_scalars(0, steps)).to(device)
    states = [smoke.fresh_state(net, opt) for _ in range(smoke.DP_RANKS)]
    params = [fused_epoch.dense_leaves(net, p) for p, _ in states]
    slots = [{k: fused_epoch.dense_leaves(net, v) for k, v in s.items()}
             for _, s in states]
    one = smoke.fresh_state(net, opt)
    pairs = (fused_epoch.dense_leaves(net, one[0]),
             {k: fused_epoch.dense_leaves(net, v) for k, v in one[1].items()})

    def ranked(**kw):
        fused_epoch.cuda_fused_epoch_ranks(spec, params, slots, xe, ye, se,
                                           **kw)

    def single(**kw):
        fused_epoch.cuda_fused_epoch(spec, *pairs, xg, yg, se, **kw)

    def parents(fn):
        def run(**kw):
            with parent_k2(libs["fused_epoch"]):
                fn(**kw)
        return run

    ring_bound_us = 1e3 * smoke.bound(*smoke.ring_cost(
        smoke.DP_RANKS, sum(d_in * d_out + d_out
                            for d_in, d_out, *_ in spec.layers)))[0]
    for what, fn, n_ranks in (("K2 with K6", ranked, smoke.DP_RANKS),
                              ("single-rank K2", single, 1)):
        fn()  # warm-up
        parents(fn)()
        # in turns: mine, parent's, parent's, mine, mine, parent's
        t = [smoke.epoch_ms(f, 3) for f in (fn, parents(fn), parents(fn),
                                            fn, fn, parents(fn))]
        mine, theirs = [t[i] for i in (0, 3, 4)], [t[i] for i in (1, 2, 5)]
        print("%s: this tree's %.3f ms (%.2f us/step; turns %s), the "
              "parent's %.3f ms (%.2f us/step; turns %s)"
              % (what, np.mean(mine), 1e3 * np.mean(mine) / steps,
                 ", ".join("%.3f" % v for v in mine), np.mean(theirs),
                 1e3 * np.mean(theirs) / steps,
                 ", ".join("%.3f" % v for v in theirs)))
        names = fused_epoch.phase_names(spec, n_ranks)
        for side, run in (("this tree's", fn), ("the parent's", parents(fn))):
            per = by_phase("%s, %s" % (what, side), names, run, device, steps)
            if n_ranks > 1:
                ring = per["ring all-reduce"]
                print("  %s: the ring phase %.2f us/step, the last backward "
                      "and the ring %.2f, against the all-reduce's bound of "
                      "%.3f us" % (side, ring, ring + per["backward 0"],
                                   ring_bound_us))


def wall_s(fn, reps):
    """Seconds a call of ``fn``, by the host's clock over ``reps`` calls
    between two ``torch.cuda.synchronize``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def bench_paths(libs, device):
    print("== the paths K1 serves: this tree's K1 and the parent's in every "
          "2-D product (wall time)")
    tx, ty, _, _ = smoke.rnn_data()
    rnn = smoke.rnn_model(device)
    rx, ry = rnn.stage(tx, ty)
    seeder.random_seed(0)
    (train_x, train_y), (test_x, _) = synthetic_mnist()
    mlp = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                device=device)
    mx, my = mlp.stage(train_x, one_hot(train_y))
    x_test = mlp.stage(test_x)
    paths = (
        ("config 8", "steps/s", len(tx) // smoke.RNN_BATCH, 3,
         lambda: rnn.train_epoch(rx, ry, batch_size=smoke.RNN_BATCH)),
        ("the flagship's step loop", "steps/s", smoke.EPOCH_STEPS, 1,
         lambda: mlp.train_epoch(mx, my, batch_size=smoke.BATCH,
                                 fused=False)),
        ("the 10,000-row eval forward", "ms", None, 20,
         lambda: mlp.predict(x_test)))
    for what, unit, steps, reps, fn in paths:
        def parents():
            with parent_k1(libs["matmul"]):
                fn()

        fn()  # warm-up
        parents()
        # in turns: mine, parent's, parent's, mine
        t = [wall_s(f, reps) for f in (fn, parents, parents, fn)]
        mine, theirs = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        if unit == "steps/s":
            print("  %s: this tree's %.2f steps/s (turns %.2f, %.2f), the "
                  "parent's %.2f (turns %.2f, %.2f)"
                  % (what, steps / mine, steps / t[0], steps / t[3],
                     steps / theirs, steps / t[1], steps / t[2]))
        else:
            print("  %s: this tree's %.3f ms (turns %.3f, %.3f), the "
                  "parent's %.3f ms (turns %.3f, %.3f)"
                  % (what, 1e3 * mine, 1e3 * t[0], 1e3 * t[3],
                     1e3 * theirs, 1e3 * t[1], 1e3 * t[2]))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the parent checkout (git archive)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(smoke.card_line())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 * len(NAMES)) as pool:
        built = [pool.submit(kernels.build_library, name) for name in NAMES]
        libs = build_parent(args.parent, pool)
        for f in built:
            f.result()
    print("built this tree's and the parent's %s in %.2f s (one nvcc each, "
          "in parallel)" % (", ".join(NAMES), time.perf_counter() - t0))
    bench_products(libs, device)
    bench_ring(libs, device)
    bench_epochs(libs, device)
    bench_paths(libs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
