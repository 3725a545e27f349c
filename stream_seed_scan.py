#!/usr/bin/env python3
"""Seed scan of the streaming tier's five-step check on one NVIDIA GPU.

``chip_smoke.py`` runs five streaming steps of the deep MLP (256-256, a
DenseStack of 98 layers of 256x256 with ReLU, 256-10; batch 128; Xavier
weights) through K3 and K3b, and the same five steps through their plain
versions, and holds the two runs at rtol 1e-4/atol 1e-5 (parameters and
slots) and rtol 1e-5/atol 1e-6 (losses), from the weights of one pinned
seed. This script shows why the seed is pinned.

For each seed it runs the five steps with Adam(1e-3) and with SGD(0.01).
Before each step it takes the kernels' run's present state and runs the
body on it four ways: K3 and the plain forward, then K3b (Momentum on zero
slots, whose slot then holds K3b's dW bit for bit, and db) and the plain
backward, the latter on the plain forward's acts and on K3's. It prints:

- flips: the units (row, layer, unit) that one forward leaves active
  (a > 0) and the other not, the first and last layer with one, and the
  largest such unit's a over its layer's largest a: a unit whose
  pre-activation is within rounding of 0;
- for the stacked dW and db, the largest |kernel - plain| over the largest
  |plain| of its layer, against the plain backward on the plain acts ("own
  acts") and on K3's acts ("K3's acts");
- after the step, how many elements of the parameters and slots are
  outside the tolerance, and at the first step with any, which leaves, and
  each such element of the stacked w and b with its three gradients and
  the sum of |terms| the plain one sums (for dW[l][i][j] the sum over the
  batch of |h_in[b][i] dz[b][j]|, for db[l][j] of |dz[b][j]|).

Run from the repository root:  python3 stream_seed_scan.py [--seeds N]
"""

import argparse
import sys

import torch

import chip_smoke as cs
from tinynn_autograd_tpu_torch import Tensor
from tinynn_autograd_tpu_torch.nn.optimizer import SGD, Adam, Momentum
from tinynn_autograd_tpu_torch.ops import streaming_epoch as se

STACK = 2  # the DenseStack's index in the deep MLP's layers
N_STEPS = 5
SHOWN = 8  # elements printed at a divergence; the rest are counted


def leaf_names(model):
    """(tree, layer, key) of ``cs.leaves_of``'s leaves, in its order."""
    params = model.net.params_tree()
    slots = model.optimizer.state_dict()["slots"]
    return [(tree, i, k)
            for tree, d_list in [("param", params)]
            + [(n, slots[n]) for n in sorted(slots)]
            for i, d in enumerate(d_list) for k in sorted(d)]


def plain_grads(activation, h0, acts, dlast, w):
    """The plain backward's stacked (dW, db) and the sums of |terms| they
    sum, from ``acts`` and the loss gradient ``dlast`` at their last
    layer."""
    deriv = se._ACTS[activation][1]
    dw, dw_abs = torch.empty_like(w), torch.empty_like(w)
    db = torch.empty((w.shape[0], 1, w.shape[-1]), device=w.device)
    db_abs = torch.empty_like(db)
    dh = dlast
    for l in reversed(range(w.shape[0])):
        dz = dh * deriv(acts[l])
        h_in = acts[l - 1] if l > 0 else h0
        dw[l] = h_in.T @ dz
        dw_abs[l] = h_in.abs().T @ dz.abs()
        db[l] = dz.sum(dim=0, keepdim=True)
        db_abs[l] = dz.abs().sum(dim=0, keepdim=True)
        dh = dz @ w[l].T
    return dw, db, dw_abs, db_abs


def body_check(model, xs, ys):
    """The four runs of the body on the model's present state (see the
    module's docstring). Returns the number of flips, a line that sums up
    flips and gradients, and a dict of the gradients (dW, db): kernel,
    plain on own acts, plain on K3's acts, and the sums of |terms| of the
    plain ones on own acts."""
    net = model.net
    stack = net.layers[STACK]
    act = stack.activation
    w, b = stack.params["w"].data, stack.params["b"].data
    h0 = net.layers[1].forward(net.layers[0].forward(Tensor(xs))).data
    h0 = h0.contiguous()

    def dlast_of(acts):
        h_last = Tensor(acts[-1], requires_grad=True)
        model.loss.loss(net.layers[3].forward(h_last), Tensor(ys)).backward()
        return h_last.grad.contiguous()

    acts_k = se.cuda_stream_forward(h0, w, b, act)
    acts_p = se.stream_forward_reference(h0, w, b, act)
    dlast_k = dlast_of(acts_k)
    mom = Momentum(1e-3)
    slots = {"acc": torch.zeros_like(w)}
    db_k, _ = se.cuda_stream_backward(act, mom, h0, dlast_k, acts_k,
                                      w.clone(), slots, mom.scalars(1e-3, 1))
    own = plain_grads(act, h0, acts_p, dlast_of(acts_p), w)
    on_k3 = plain_grads(act, h0, acts_k, dlast_k, w)
    for p in net.layers[3].params.values():
        p.grad = None

    flips = (acts_k > 0) != (acts_p > 0)
    n_flips = int(flips.sum())
    summary = "flips %d" % n_flips
    if n_flips:
        layers = torch.nonzero(flips.any(dim=2).any(dim=1)).flatten()
        top = torch.maximum(acts_k, acts_p).amax(dim=(1, 2), keepdim=True)
        share = (torch.maximum(acts_k, acts_p) / top)[flips]
        summary += (" in layers %d-%d, the largest a/max|a| there %.2e"
                    % (int(layers.min()), int(layers.max()),
                       float(share.max())))
    grads = {"kernel": (slots["acc"], db_k), "own acts": own[:2],
             "K3's acts": on_k3[:2], "terms": own[2:]}
    for what in ("own acts", "K3's acts"):
        ratios = []
        for k, p in zip(grads["kernel"], grads[what]):
            top = p.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
            ratios.append(float(((k - p).abs() / top).max()))
        summary += ("; |kernel - plain on %s| / the layer's max|plain|: dW "
                    "%.2e, db %.2e" % ((what,) + tuple(ratios)))
    return n_flips, summary, grads


def show_elements(key, mask, grads):
    """Prints the stacked ``key`` ('w' or 'b') elements in ``mask``."""
    i = 0 if key == "w" else 1
    idx = torch.nonzero(mask).cpu().numpy()
    for pos in idx[:SHOWN]:
        pos = tuple(int(p) for p in pos)
        print("        %s%s: g kernel %+.4e, plain on own acts %+.4e, "
              "on K3's acts %+.4e; sum|terms| %.3e"
              % (key, list(pos), float(grads["kernel"][i][pos]),
                 float(grads["own acts"][i][pos]),
                 float(grads["K3's acts"][i][pos]),
                 float(grads["terms"][i][pos])))
    if len(idx) > SHOWN:
        print("        ... and %d more" % (len(idx) - SHOWN))


def scan(device, opt_name, seed, x, y):
    """Five steps with ``opt_name`` from ``seed``. Returns (first step
    with an element outside the tolerance or None, elements outside after
    the last step, the flips before each step)."""
    make_opt = {"Adam": lambda: Adam(1e-3), "SGD": lambda: SGD(0.01)}[opt_name]
    models, steps = cs.stream_pair(device, make_opt, seed)
    names = leaf_names(models[0])
    first, outside, flips = None, 0, []
    for i in range(N_STEPS):
        xs = torch.from_numpy(x[i * cs.BATCH:(i + 1) * cs.BATCH]).to(device)
        ys = torch.from_numpy(y[i * cs.BATCH:(i + 1) * cs.BATCH]).to(device)
        n_flips, summary, grads = body_check(models[0], xs, ys)
        flips.append(n_flips)
        loss = [float(step(xs, ys)) for step in steps]
        state = [cs.leaves_of(m.net.params_tree(),
                              m.optimizer.state_dict()["slots"])
                 for m in models]
        masks = [(got - want).abs() > (cs.STATE_TOL["atol"]
                                       + cs.STATE_TOL["rtol"] * want.abs())
                 for got, want in zip(*state)]
        outside = sum(int(mk.sum()) for mk in masks)
        print("    step %d: before it %s" % (i + 1, summary))
        print("      losses %.7f / %.7f; %d elements outside after it"
              % (loss[0], loss[1], outside))
        if outside == 0 or first is not None:
            continue
        first = i + 1
        by_leaf = {}
        for name, mk in zip(names, masks):
            if mk.any():
                by_leaf.setdefault(name[1:], []).append(mk)
                print("      outside: %s of layer %d's %s: %d"
                      % (name[0], name[1], name[2], int(mk.sum())))
        for key in ("w", "b"):
            if (STACK, key) in by_leaf:
                show_elements(key, torch.stack(by_leaf[STACK, key]).any(0),
                              grads)
    return first, outside, flips


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: %s" % cs.card_line())
    x, y = cs.deep_data()
    summary = []
    for seed in range(args.seeds):
        for opt_name in ("Adam", "SGD"):
            print("seed %d, %s:" % (seed, opt_name))
            summary.append((seed, opt_name) + scan(device, opt_name, seed,
                                                   x, y))
    print("summary: seed, optimizer, first step with an element outside, "
          "elements outside after step %d, flips before each step" % N_STEPS)
    for seed, opt_name, first, outside, flips in summary:
        print("  %d %-4s %-4s %7d  %s" % (seed, opt_name, first, outside,
                                          flips))
    return 0


if __name__ == "__main__":
    sys.exit(main())
