#!/usr/bin/env python3
"""K1's launch plans at the main paths' products, on one CUDA card.

For every product that a flagship train step (784-200-100-70-30-10, batch
128), the 10,000-row eval, a config-8 step (two LSTM layers of 256, T = 128,
batch 64) and a 6b step (its blocks' 36 products and its head's 3) hand to
K1, the matmul kernel (csrc/matmul.cu), this times each of the kernel's
tile configurations that the operands' layout admits (the tensor-core
tile where ``tc_aligned``) at each K-split (a thread block cluster of that
many blocks a tile) by CUDA events (``device_us``), beside torch.matmul
(cuBLAS, f32, TF32 off), and prints the plan ``plan_matmul`` picks, its
time and the best time found; last, a 6b step's 39 products under their
plans beside cuBLAS and beside their least time at the 3xTF32 peak.
It also prints what an SM holds of each configuration and the clusters
the card holds at once, and fails if the blocks an SM differ from
``MATMUL_TILES``'. These are the measurements the plan's cost model
(``MATMUL_TILES``, ``MATMUL_WIDE_CLUSTER`` in ops/kernels.py) rests on.

    python3 bench_matmul_plans.py               # on the card, ~1 min
    python3 bench_matmul_plans.py --plans-only  # the plans alone, any device

Without a CUDA device and without --plans-only it exits 1.
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch.ops import kernels  # noqa: E402

_LAYERS = [(784, 200), (200, 100), (100, 70), (70, 30), (30, 10)]
# name -> (m, k, n, a transposed, b transposed), as the tape passes them
SHAPES = dict(
    [("flagship fwd %d" % l, (128, i, o, False, False))
     for l, (i, o) in enumerate(_LAYERS)]
    + [("flagship dW %d" % l, (i, 128, o, True, False))
       for l, (i, o) in enumerate(_LAYERS)]
    + [("flagship dx %d" % l, (128, o, i, False, True))
       for l, (i, o) in enumerate(_LAYERS) if l]
    + [("eval", (10000, 784, 200, False, False)),
       ("config8 proj 1", (8192, 64, 1024, False, False)),
       ("config8 proj 2", (8192, 256, 1024, False, False)),
       ("config8 head", (64, 256, 16, False, False)),
       ("config8 head dW", (256, 64, 16, True, False)),
       ("config8 head dx", (64, 16, 256, False, True)),
       ("config8 dx 2", (8192, 1024, 256, False, True)),
       ("config8 dWx 2, dWh", (256, 8192, 1024, True, False)),
       ("config8 dWx 1", (64, 8192, 1024, True, False)),
       ("6b head", (4, 512, 16, False, False)),
       ("6b head dW", (512, 4, 16, True, False)),
       ("6b head dx", (4, 16, 512, False, True)),
       ("6b qkvo", (8192, 512, 512, False, False)),
       ("6b w1", (8192, 512, 2048, False, False)),
       ("6b w2", (8192, 2048, 512, False, False)),
       ("6b qkvo dx", (8192, 512, 512, False, True)),
       ("6b w1 dx", (8192, 2048, 512, False, True)),
       ("6b w2 dx", (8192, 512, 2048, False, True)),
       ("6b qkvo dW", (512, 8192, 512, True, False)),
       ("6b w1 dW", (512, 8192, 2048, True, False)),
       ("6b w2 dW", (2048, 8192, 512, True, False))])
# a 6b step's products by name: each of its 2 blocks' six Dense products
# forward, dX and dW (q, k, v and the output projection alike), and the head
STEP_6B = dict([(name, 8) for name in ("6b qkvo", "6b qkvo dx", "6b qkvo dW")]
               + [(name, 2) for name in ("6b w1", "6b w2", "6b w1 dx",
                                         "6b w2 dx", "6b w1 dW", "6b w2 dW")]
               + [(name, 1) for name in ("6b head", "6b head dW",
                                         "6b head dx")])
PEAK_3XTF32 = 494.7e12 / 3


def operands(m, k, n, ta, tb, gen, device):
    a = torch.randn((k, m) if ta else (m, k), generator=gen).to(device)
    b = torch.randn((n, k) if tb else (k, n), generator=gen).to(device)
    return (a.T if ta else a), (b.T if tb else b)


def plan_of(m, k, n, ta, tb):
    """``plan_matmul``'s plan for the product with the tape's layout (meta
    tensors: the strides without the storage, their start at 0)."""
    a = torch.empty((k, m) if ta else (m, k), device="meta")
    b = torch.empty((n, k) if tb else (k, n), device="meta")
    a, b = (a.T if ta else a), (b.T if tb else b)
    return kernels.plan_matmul(m, n, k, aligned=kernels.tc_aligned(a, b))


def plans(k, tensor_cores):
    """Every (config, split) the kernel takes at depth k: splits whose
    slices of whole stages are all non-empty; the tensor-core tile only
    where the operands fit it."""
    for config, (bm, bn, _, _) in enumerate(kernels.MATMUL_TILES):
        if config == kernels.MATMUL_TC and not tensor_cores:
            continue
        stage = (kernels.MATMUL_TC_BK if config == kernels.MATMUL_TC
                 else kernels.MATMUL_BK)
        for split in range(1, kernels.MATMUL_MAX_SPLIT + 1):
            slices, chunk = kernels._k_slices(k, split, stage)
            if slices == split:
                yield kernels.MatmulPlan(config, bm, bn, split, chunk)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plans-only", action="store_true",
                        help="print the plans plan_matmul picks and stop")
    parser.add_argument("--reps", type=int, default=20,
                        help="calls a timing averages over")
    args = parser.parse_args(argv)
    for name, shape in SHAPES.items():
        m, k, n = shape[:3]
        print("%-22s [%d,%d]@[%d,%d]: %s" % (name, m, k, k, n,
                                             plan_of(*shape)))
    if args.plans_only:
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from tinynn_autograd_tpu_torch.utils.timing import device_us

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for config, (bm, bn, per_sm, _) in enumerate(kernels.MATMUL_TILES):
        held = [kernels.matmul_occupancy(config, s)
                for s in range(1, kernels.MATMUL_MAX_SPLIT + 1)]
        print("config %d (%dx%d): (blocks an SM holds, clusters the card "
              "holds) at splits 1-%d: %s"
              % (config, bm, bn, kernels.MATMUL_MAX_SPLIT, held))
        if held[0][0] != per_sm:
            raise AssertionError("config %d: the card holds %d blocks an "
                                 "SM, MATMUL_TILES says %d"
                                 % (config, held[0][0], per_sm))
    gen = torch.Generator().manual_seed(0)
    step = {"plan": 0.0, "cuBLAS": 0.0, "bound": 0.0}
    for name, (m, k, n, ta, tb) in SHAPES.items():
        a, b = operands(m, k, n, ta, tb, gen, device)
        want = torch.matmul(a, b)
        times = {}
        for plan in plans(k, kernels.tc_aligned(a, b)):
            got = kernels.cuda_matmul(a, b, plan)
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
                raise AssertionError("%s: plan %s is wrong" % (name, plan))
            times[plan] = device_us(lambda: kernels.cuda_matmul(a, b, plan),
                                    reps=args.reps)
        chosen = kernels.plan_matmul(m, n, k,
                                     aligned=kernels.tc_aligned(a, b))
        best = min(times, key=times.get)
        library = device_us(lambda: torch.matmul(a, b), reps=args.reps)
        print("%-22s cuBLAS %.2f us; plan (config %d, split %d) %.2f us; "
              "best (config %d, split %d) %.2f us; every plan: %s"
              % (name, library, chosen.config, chosen.split, times[chosen],
                 best.config, best.split, times[best],
                 " ".join("c%ds%d %.1f" % (p.config, p.split, t)
                          for p, t in times.items())))
        count = STEP_6B.get(name, 0)
        step["plan"] += count * times[chosen]
        step["cuBLAS"] += count * library
        step["bound"] += count * 2.0 * m * n * k / PEAK_3XTF32 * 1e6
    print("a 6b step's %d products: plans %.1f us, cuBLAS %.1f us, least "
          "time at the 3xTF32 peak %.1f us (the plans at %.1f%% of it)"
          % (sum(STEP_6B.values()), step["plan"], step["cuBLAS"],
             step["bound"], 100.0 * step["bound"] / step["plan"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
