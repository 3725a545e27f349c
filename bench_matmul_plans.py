#!/usr/bin/env python3
"""K1's launch plans at the main paths' products, on one CUDA card.

For every product that a flagship train step (784-200-100-70-30-10, batch
128), the 10,000-row eval, a config-8 step (two LSTM layers of 256, T = 128,
batch 64) and a 6b step (its head) hand to K1, the matmul kernel
(csrc/matmul.cu), this times each of the kernel's tile configurations at
each K-split (a thread block cluster of that many blocks a tile) by CUDA
events (``device_us``), beside torch.matmul (cuBLAS, f32, TF32 off), and
prints the plan ``plan_matmul`` picks, its time and the best time found.
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
       ("6b head dx", (4, 16, 512, False, True))])


def operands(m, k, n, ta, tb, gen, device):
    a = torch.randn((k, m) if ta else (m, k), generator=gen).to(device)
    b = torch.randn((n, k) if tb else (k, n), generator=gen).to(device)
    return (a.T if ta else a), (b.T if tb else b)


def plans(k):
    """Every (config, split) the kernel takes at depth k: splits whose
    slices of whole stages are all non-empty."""
    for config, (bm, bn, _, _) in enumerate(kernels.MATMUL_TILES):
        for split in range(1, kernels.MATMUL_MAX_SPLIT + 1):
            slices, chunk = kernels._k_slices(k, split)
            if slices == split:
                yield kernels.MatmulPlan(config, bm, bn, split, chunk)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plans-only", action="store_true",
                        help="print the plans plan_matmul picks and stop")
    parser.add_argument("--reps", type=int, default=20,
                        help="calls a timing averages over")
    args = parser.parse_args(argv)
    for name, (m, k, n, _, _) in SHAPES.items():
        print("%-22s [%d,%d]@[%d,%d]: %s" % (name, m, k, k, n,
                                             kernels.plan_matmul(m, n, k)))
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
    for name, (m, k, n, ta, tb) in SHAPES.items():
        a, b = operands(m, k, n, ta, tb, gen, device)
        want = torch.matmul(a, b)
        times = {}
        for plan in plans(k):
            got = kernels.cuda_matmul(a, b, plan)
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
                raise AssertionError("%s: plan %s is wrong" % (name, plan))
            times[plan] = device_us(lambda: kernels.cuda_matmul(a, b, plan),
                                    reps=args.reps)
        chosen = kernels.plan_matmul(m, n, k)
        best = min(times, key=times.get)
        print("%-22s cuBLAS %.2f us; plan (config %d, split %d) %.2f us; "
              "best (config %d, split %d) %.2f us; every plan: %s"
              % (name, device_us(lambda: torch.matmul(a, b), reps=args.reps),
                 chosen.config, chosen.split, times[chosen], best.config,
                 best.split, times[best],
                 " ".join("c%ds%d %.1f" % (p.config, p.split, t)
                          for p, t in times.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
