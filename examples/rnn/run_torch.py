"""Recurrent sequence-learning demo with the PyTorch package (the
counterpart of run.py): a stacked LSTM or GRU trained on the adding problem
(each sequence carries T (value, marker) pairs, exactly two markers are set,
and the target is the sum of the two marked values, so a model must carry
the marked values across the whole sequence).

Same flags as run.py (--steps/--batch/--seq_len/--hidden/--cell/--bi/--lr/
--seed), plus --device: the card (``cuda``) unless the caller asks for the
CPU (``--device cpu``). Without a CUDA device, ``--device cuda`` stops with
an error; it never moves to the CPU. On the card each recurrent layer runs
one recurrent kernel launch forward and one backward a step (K5/K5b for the
LSTM, K5c/K5d for the GRU; both directions under --bi); on the CPU their
plain versions.

Run:  python examples/rnn/run_torch.py --steps 1200 --cell lstm
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from tinynn_autograd_tpu_torch.models import build_rnn_classifier  # noqa: E402
from tinynn_autograd_tpu_torch.nn.layers import (  # noqa: E402
    GRU, LSTM, Bidirectional, Dense,
)
from tinynn_autograd_tpu_torch.nn.losses import MSELoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.net import Net  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.utils.seeder import random_seed  # noqa: E402


def main(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device %s: no CUDA device is available"
                         % args.device)
    random_seed(args.seed)
    T = args.seq_len
    rng = np.random.RandomState(args.seed)

    def sample(n):
        vals = rng.rand(n, T).astype(np.float32)
        marks = np.zeros((n, T), np.float32)
        for i in range(n):
            a, b = rng.choice(T, size=2, replace=False)
            marks[i, a] = marks[i, b] = 1.0
        x = np.stack([vals, marks], axis=-1)          # [n, T, 2]
        y = (vals * marks).sum(axis=1, keepdims=True)  # [n, 1]
        return x, y

    if args.bi:
        cell_cls = {"lstm": LSTM, "gru": GRU}[args.cell]
        net = Net([Bidirectional(cell_cls(args.hidden, num_in=2,
                                          seed=args.seed)),
                   Dense(1, num_in=2 * args.hidden, seed=args.seed + 1)])
    else:
        net = build_rnn_classifier(num_in=2, num_out=1,
                                   hidden=(args.hidden,), cell=args.cell,
                                   seed=args.seed)
    model = Model(net, MSELoss(), Adam(args.lr), device=device)

    # the trivial predict-the-mean baseline has MSE = Var[y] ~ 0.167; a
    # recurrent model that uses its memory goes far below it
    for step in range(args.steps):
        x, y = sample(args.batch)
        loss = float(model.train_step(x, y))
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print("step %4d  mse %.5f" % (step, loss))

    x, y = sample(1024)
    pred = model.predict(x).numpy()
    mse = float(((pred - y) ** 2).mean())
    base = float(((y - y.mean()) ** 2).mean())
    print("eval mse %.5f  (predict-the-mean baseline %.5f, ratio %.3f) on %s"
          % (mse, base, mse / base, device))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (default cuda; cpu "
                             "runs the plain versions of the kernels)")
    parser.add_argument("--steps", type=int, default=1200)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--seq_len", type=int, default=32)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--cell", choices=["lstm", "gru"], default="lstm")
    parser.add_argument("--bi", action="store_true",
                        help="bidirectional recurrence (forward + "
                             "reverse-time twin, features concatenated)")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seed", type=int, default=0)
    main(parser.parse_args())
