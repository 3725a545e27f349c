#!/usr/bin/env python3
"""Seed scan of K2's Lion check: why ``chip_smoke.py`` holds Lion on data
seed 4.

``chip_smoke.py`` holds K2 with Lion against its plain version step by step
over 10 batches of the Dropout flagship (784-200-100-70-30-10, ReLU,
Dropout 0.3 after the two first ReLUs; weights from seed 1; batch 128).
Lion's step is lr sign(u): a gradient that the two summation orders move by
rounding alone changes a step only where u is within rounding of 0, which
the check leaves out. A ReLU input within rounding of 0 does more: the two
forwards can leave it on different sides of 0, and then its unit's column
of the weight gradient differs by far more than rounding.

Along the plain version's Lion trajectory (lr 1e-4, weight decay 1e-2 and
0) this prints for each step:

- on the card, K2's gradients against the plain version's from the same
  weights at the same step (one SGD(1.0) step of each): by leaf, in
  ``chip_smoke.leaves_of``'s order, the largest |K2 - plain| over the
  largest |plain| of the leaf, and the columns where that passes 1e-4;
- the least |pre-activation| of each ReLU layer over its layer's largest,
  in the plain forward.

``--device cpu`` prints only the least share of each seed, over the whole
trajectory, for the seeds 0 ... N - 1 (``--seeds N``). With ``--ranks`` it
takes ``chip_smoke.py``'s hold of K2 over ranks instead (K6: the Dropout
flagship on ``chip_smoke.DP_RANKS`` shards of each batch, Adam 1e-3, each
rank seeding its Dropouts with its own step): on the card the hold itself
on each of ``--data-seeds``, passed or failed; on the CPU every rank's
least ReLU input along the plain version's trajectory.

Run from the repository root:  python3 k2_seed_scan.py [--data-seeds 5 4]
"""

import argparse

import numpy as np
import torch

import chip_smoke as cs
from tinynn_autograd_tpu_torch.nn.optimizer import SGD, Adam, Lion
from tinynn_autograd_tpu_torch.ops import dropout, fused_epoch
from tinynn_autograd_tpu_torch.utils import seeder

N_STEPS = 10
RELU_LAYERS = 4  # every Dense of the Dropout flagship but the last


def least_relu_inputs(spec, params, x, t):
    """Each ReLU layer's least |z| over its largest, in the plain forward
    of batch ``x`` at step ``t``."""
    h, out = x, []
    for l, (w, b) in enumerate(params[:RELU_LAYERS]):
        z = h @ w + b
        out.append(float(z.abs().min() / z.abs().max()))
        h = torch.clamp(z, min=0)
        rate, idx = spec.layers[l][3], spec.layers[l][4]
        if rate:
            h = dropout.dropout_reference(h, rate,
                                          dropout.layer_seed(t, idx))[0]
    return out


def gradients(fn, net, state, x, y, t):
    """The leaves' gradients of one step of ``fn`` from ``state``'s
    weights, as numpy arrays in ``leaves_of``'s order."""
    sgd = SGD(1.0)
    params, _ = cs.clone_state(*state)
    before = [v.cpu().numpy() for v in cs.leaves_of(params, {})]
    cs.k2_state_run(fn, net, sgd, fused_epoch.epoch_spec(net, sgd), x, y, t,
                    (params, {}))
    return [a - v.cpu().numpy() for a, v in
            zip(before, cs.leaves_of(params, {}))]


def scan(net, device, data_seed, weight_decay, on_card):
    """The plain Lion trajectory's steps; per step the printed line (on the
    card) and the least ReLU input share. Returns the least share."""
    xb, yb = cs.parity_batches(device, N_STEPS, data_seed)
    lion = Lion(1e-4, weight_decay=weight_decay)
    spec = fused_epoch.epoch_spec(net, lion)
    state = cs.fresh_state(net, lion)
    least = 1.0
    for t in range(N_STEPS):
        x, y = xb[t:t + 1], yb[t:t + 1]
        shares = least_relu_inputs(
            spec, fused_epoch.dense_leaves(net, state[0]), x[0], t)
        least = min([least] + shares)
        if on_card:
            parts = []
            for i, (gk, gp) in enumerate(zip(
                    gradients(fused_epoch.cuda_fused_epoch, net, state, x, y,
                              t),
                    gradients(fused_epoch.fused_epoch_reference, net, state,
                              x, y, t))):
                rel = np.abs(gk - gp) / np.abs(gp).max()
                cols = int((rel.max(axis=0) > 1e-4).sum())
                parts.append("%.2g%s" % (rel.max(), " (%d columns past "
                                         "1e-4)" % cols if cols else ""))
            print("  step %d: gradients K2 vs plain by leaf %s; least ReLU "
                  "input by layer %s" % (t, ", ".join(parts), ", ".join(
                      "%.2g" % s for s in shares)), flush=True)
        cs.k2_state_run(fused_epoch.fused_epoch_reference, net, lion, spec,
                        x, y, t, state)
    return least


def scan_ranks(net, data_seed):
    """The least ReLU input share of every rank along the plain version's
    Adam trajectory of chip_smoke.py's K6 hold, on ``data_seed``."""
    opt = Adam(1e-3)
    spec = fused_epoch.epoch_spec(net, opt)
    xs, ys = cs.rank_shards(*cs.parity_batches(torch.device("cpu"), N_STEPS,
                                               data_seed))
    states = [cs.fresh_state(net, opt) for _ in range(len(xs))]
    params = [fused_epoch.dense_leaves(net, p) for p, _ in states]
    slots = [{k: fused_epoch.dense_leaves(net, v) for k, v in s.items()}
             for _, s in states]
    least = 1.0
    for t in range(N_STEPS):
        for r in range(len(xs)):
            least = min([least] + least_relu_inputs(
                spec, params[r], xs[r, t], fused_epoch.rank_step(t, r)))
        fused_epoch.fused_epoch_reference(
            spec, params, slots, xs[:, t:t + 1], ys[:, t:t + 1],
            torch.from_numpy(opt.step_scalars(t, 1)), t0=t)
    return least


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--data-seeds", type=int, nargs="+", default=[5, 4])
    parser.add_argument("--seeds", type=int, default=40,
                        help="with --device cpu: the seeds 0 ... N - 1")
    parser.add_argument("--ranks", action="store_true",
                        help="take the K6 hold instead of Lion's")
    args = parser.parse_args()
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    with seeder.scope(1):
        net = cs.dropout_flagship(cs.DROPOUT_RATE).to(device)
    seeds = args.data_seeds if on_card else range(args.seeds)
    if args.ranks and on_card:
        for seed in seeds:
            try:
                cs.hold_k6("data seed %d" % seed, net, Adam(1e-3),
                           *cs.rank_shards(*cs.parity_batches(
                               device, N_STEPS, seed)))
            except AssertionError as err:
                print("data seed %d fails the hold: %s" % (seed, " ".join(
                    str(err).split("\n")[1:5])), flush=True)
        return
    if args.ranks:
        for seed in seeds:
            print("data seed %d: least ReLU input over the %d steps of %d "
                  "ranks %.2g" % (seed, N_STEPS, cs.DP_RANKS,
                                  scan_ranks(net, seed)), flush=True)
        return
    for seed in seeds:
        shares = []
        for wd in (1e-2, 0.0):
            if on_card:
                print("data seed %d, Lion(1e-4, weight_decay=%g):"
                      % (seed, wd), flush=True)
            shares.append(scan(net, device, seed, wd, on_card))
        print("data seed %d: least ReLU input over the %d steps %.2g (weight "
              "decay 1e-2), %.2g (none)" % (seed, N_STEPS, *shares),
              flush=True)


if __name__ == "__main__":
    main()
