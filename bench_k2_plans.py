#!/usr/bin/env python3
"""K2, the whole-epoch kernel, under its chosen plan and under others.

``fused_epoch.plan_epoch`` picks, from a cost model, how many thread block
clusters a rank takes and each product's K-split. This times a 390-step
epoch of the flagship (784-200-100-70-30-10, batch 128, Adam 1e-3, pinned
seed-1 weights) by CUDA events, twice a plan, under the plan a launch
takes, under one K slice a product, and under the model's splits at other
cluster counts; then the same for 4 ranks of 32 rows (K2 with K6). A plan
that beats the chosen one by more than the spread between two timings of
one plan says the cost model needs new constants.

    python3 bench_k2_plans.py   # ~1 min with the build

Without a CUDA device it exits 1.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke  # noqa: E402
from tinynn_autograd_tpu_torch.models import build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.ops import fused_epoch  # noqa: E402
from tinynn_autograd_tpu_torch.utils import seeder  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import one_hot, synthetic_mnist  # noqa: E402

STEPS = smoke.EPOCH_STEPS


def plans(spec, batch, n_ranks):
    """(name, plan) to time: the chosen one, one slice a product, and the
    model's splits at other cluster counts."""
    chosen = fused_epoch.epoch_plan(spec, batch, n_ranks)
    grid = fused_epoch.kernel_grid(n_ranks > 1)
    most = grid.clusters // n_ranks
    n = chosen.blocks // chosen.cluster
    out = [("chosen", chosen),
           ("one slice a product", fused_epoch.plan_epoch(
               spec.layers, batch, chosen.blocks, max_split=1,
               n_ranks=n_ranks))]
    for other in sorted({max(1, n - 3), max(1, n - 1), min(most, n + 1),
                         min(most, n + 4), most} - {n}):
        _, splits = fused_epoch._plan_at(spec.layers, batch, other,
                                         chosen.cluster, chosen.cluster,
                                         n_ranks)
        out.append(("%d clusters" % other, fused_epoch.EpochPlan(
            splits, chosen.cluster, other * chosen.cluster)))
    return out


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(smoke.card_line())
    with seeder.scope(1):
        net = build_mnist_mlp().to(device)
    opt = Adam(1e-3)
    spec = fused_epoch.epoch_spec(net, opt)
    (x, y), _ = synthetic_mnist(STEPS * smoke.BATCH, 10)
    xg = torch.from_numpy(x).to(device).reshape(STEPS, smoke.BATCH, 784)
    yg = torch.from_numpy(one_hot(y)).to(device).reshape(STEPS, smoke.BATCH,
                                                          10)
    xs, ys = smoke.rank_shards(xg, yg)
    se = torch.from_numpy(opt.step_scalars(0, STEPS)).to(device)
    one = smoke.fresh_state(net, opt)
    pairs = (fused_epoch.dense_leaves(net, one[0]),
             {k: fused_epoch.dense_leaves(net, v) for k, v in one[1].items()})
    states = [smoke.fresh_state(net, opt) for _ in range(smoke.DP_RANKS)]
    params = [fused_epoch.dense_leaves(net, p) for p, _ in states]
    slots = [{k: fused_epoch.dense_leaves(net, v) for k, v in s.items()}
             for _, s in states]
    for n_ranks, batch in ((1, smoke.BATCH), (smoke.DP_RANKS, smoke.DP_LOCAL)):
        print("== %d rank%s of %d rows: us a step (CUDA events, a 390-step "
              "epoch, two timings)" % (n_ranks, "" if n_ranks == 1 else "s",
                                       batch))
        for name, plan in plans(spec, batch, n_ranks):
            if n_ranks == 1:
                def run():
                    fused_epoch.cuda_fused_epoch(spec, *pairs, xg, yg, se,
                                                 plan=plan)
            else:
                def run():
                    fused_epoch.cuda_fused_epoch_ranks(
                        spec, params, slots, xs, ys, se, plan=plan)
            run()  # warm-up
            t = [1e3 * smoke.epoch_ms(run, 3) / STEPS for _ in range(2)]
            print("  %-20s %3d blocks a rank, K-splits %s: %.2f us/step "
                  "(%.2f, %.2f)" % (name, plan.blocks, " ".join(
                      "%d/%d/%d" % s for s in plan.splits), sum(t) / 2, *t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
