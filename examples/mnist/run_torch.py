"""MNIST training with the PyTorch package (the counterpart of run.py).

Same flags as run.py (--num_ep/--data_dir/--lr/--batch_size/--seed/--eager/
--dp/--target_acc/--accum/--ckpt) and the same flagship MLP
(784-200-100-70-30-10 Dense+ReLU, Adam, batch 128), plus --device: the card
(``cuda``) unless the caller asks for the CPU (``--device cpu``). Without a
CUDA device, ``--device cuda`` stops with an error; it never moves to the
CPU.

- default mode stages the dataset on the device once and trains each epoch
  with ``train_epoch``'s default ``fused="auto"`` (on-device shuffle): on
  the card the whole epoch is one launch of the K2 kernel, on the CPU a loop
  of train steps
- --eager runs the reference-style zero_grad/forward/backward/step loop
- --dp N trains data-parallel over N ranks that share --device
  (``parallel.DataParallel``; --batch_size is the global batch): each epoch
  through ``train_epoch(fused="auto")``, on the card one launch of the
  whole-epoch kernel with its in-kernel gradient ring, on the CPU the step
  tier
- offline: falls back to synthetic pseudo-MNIST when data/mnist.pkl.gz is
  absent

Run:  python examples/mnist/run_torch.py --num_ep 10
      python examples/mnist/run_torch.py --num_ep 3 --dp 4
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from tinynn_autograd_tpu_torch import Tensor  # noqa: E402
from tinynn_autograd_tpu_torch.models import build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator  # noqa: E402
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu_torch.parallel import DataParallel, make_mesh  # noqa: E402
from tinynn_autograd_tpu_torch.utils.data_iterator import BatchIterator  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import load_mnist, one_hot  # noqa: E402
from tinynn_autograd_tpu_torch.utils.seeder import random_seed  # noqa: E402


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device %s: no CUDA device is available"
                         % args.device)
    if args.seed >= 0:
        random_seed(args.seed)

    (train_x, train_y), (test_x, test_y) = load_mnist(args.data_dir)
    train_y_oh = one_hot(train_y)

    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                  Adam(lr=args.lr), device=device)
    trainer = model
    if args.dp > 1:
        trainer = DataParallel(model, mesh=make_mesh(
            devices=[device] * args.dp))
        print("data parallel: %d ranks sharing %s, global batch %d"
              % (args.dp, device, args.batch_size))

    if args.eager:
        def step(xb, yb):
            model.zero_grad()
            pred = model.forward(xb)
            loss = model.loss.loss(pred, Tensor(yb, device=device))
            loss.backward()
            model.step()
            return loss.values
    else:
        def step(xb, yb):
            return model.train_step(xb, yb, accum_steps=args.accum)

    epoch_mode = args.dp > 1 or (not args.eager and args.accum <= 1)
    if epoch_mode:
        x_dev, y_dev = trainer.stage(train_x, train_y_oh)

    iterator = BatchIterator(batch_size=args.batch_size,
                             drop_last=not args.eager)
    t_start = time.time()
    reached_at = None
    for epoch in range(args.num_ep):
        t_epoch = time.time()
        if epoch_mode:
            losses = trainer.train_epoch(x_dev, y_dev,
                                         batch_size=args.batch_size,
                                         fused="auto")
            n_steps = int(losses.shape[0])
            loss_val = float(losses[-1])
        else:
            loss = None
            n_steps = 0
            for batch in iterator(train_x, train_y_oh):
                loss = step(batch.inputs, batch.targets)
                n_steps += 1
            loss_val = float(loss)
        _sync(device)
        epoch_s = time.time() - t_epoch

        res = model.evaluate_batch(test_x, test_y, AccEvaluator)
        print("Epoch %d  time %.2fs (%.1f steps/s on %s)  loss %.4f  %s"
              % (epoch, epoch_s, n_steps / epoch_s, device, loss_val, res))
        if reached_at is None and res["accuracy"] >= args.target_acc:
            reached_at = time.time() - t_start
            print("Reached %.3f test accuracy in %.2fs"
                  % (args.target_acc, reached_at))

    if args.ckpt:
        model.save(args.ckpt)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (default cuda; cpu "
                             "runs the plain versions of the kernels)")
    parser.add_argument("--num_ep", default=50, type=int)
    parser.add_argument("--data_dir", default="./data", type=str)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=-1, type=int)
    parser.add_argument("--eager", action="store_true",
                        help="reference-style per-op eager loop")
    parser.add_argument("--dp", default=0, type=int,
                        help="data-parallel over N ranks sharing --device")
    parser.add_argument("--target_acc", default=0.975, type=float)
    parser.add_argument("--accum", default=1, type=int,
                        help="gradient accumulation (not ported yet: >1 "
                             "raises)")
    parser.add_argument("--ckpt", default="", type=str)
    main(parser.parse_args())
