#!/usr/bin/env python3
"""Smoke test of the PyTorch package on one NVIDIA GPU.

Drives the port's paths at full width through their kernels. The flagship
MNIST MLP (784-200-100-70-30-10 Dense+ReLU, softmax-CE, Adam 1e-3, batch
128, random weights from seed 0, synthetic MNIST at 50,000/10,000) runs
through K1, the matmul (csrc/matmul.cu), and K2, the whole-epoch kernel
(csrc/fused_epoch.cu); with Dropout(0.3) after its two first ReLUs also
through P1, the dropout pass (csrc/dropout.cu), on the step loop; with
each of the seven optimizers (examples/mnist/optimizer_sweep.py's table),
a schedule and clip_norm through K2. P2, the optimizer-only probe
(csrc/mega_probe.cu), runs bench_mega_probe_torch.py's timings. The deep
MLP (256-256, a DenseStack of 98 layers of
256x256 with ReLU, 256-10; batch 128; 2,560 samples from numpy seed 0,
labelled by a fixed random linear teacher) runs through K3 and K3b, the
weight-streaming kernels (csrc/streaming_epoch.cu). The long-context causal
transformer classifier (bench_all.py's config 6b: vocab 256, seq 2048, dim
512, 8 heads, depth 2, 16 classes; batch 4, Adam 1e-3, random weights from
seed 0, random tokens from numpy seed 0) runs through the flash-attention
kernels (csrc/attention.cu: the forward, the dq and the dk/dv kernels). The
stacked-LSTM sequence classifier (bench_all.py's config 8: 64 features,
two LSTM layers of 256, 16 classes, T=128; batch 64, Adam 1e-3, random
weights from seed 77, 2,048 sequences from numpy seed 0) runs through the
recurrent kernels (csrc/recurrent.cu: K5 and K5b; the GRU's K5c and K5d).
K7, the fused transformer-block forward (csrc/block_fwd.cu), runs
bench_block_probe_torch.py's probe at config 6's block (B 32, T 128, D
256, 8 heads, causal or not), a T=512 causal block and 6b's block. The
flagship trained data-parallel (BASELINE.json configuration 5: 4 ranks
sharing the card, global batch 128) runs through K2 with its gradient ring
(K6, csrc/fused_epoch.cu with csrc/ring.cuh, one all-rank exchange a
step); P3, the ring all-reduce alone (csrc/ring_allreduce.cu), at the JAX
test's shape and the flagship's gradients over 2, 3, 4 and 16 ranks.
(bench_vs_parent.py times K2, or the attention kernels, beside an older
checkout's; bench_k2_plans.py times K2 under other launch plans.)

1. device: the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build: compiles the nine libraries from csrc/ (one nvcc each, started
   together; sm_90a) and prints each kernel's registers, shared memory and
   spills, and the clusters K2 may take.
3. kernel vs plain: K1's tile configurations hold the blocks an SM that
   ``MATMUL_TILES`` says. K1 against ``matmul_reference`` on the card at
   every shape the main paths give it (the 14 products of a flagship train
   step, transposed views included, the 10,000-row eval product, 6b's
   three, two ragged shapes), in f32 (rtol 1e-5, atol 1e-4) and bf16 (rtol
   2e-2, atol 2e-1); config 8's ten on the operands of a config-8 train
   step at the f32 gate, and on unit-normal operands at the f32 gate where
   K <= 256 and at K = 1,024 and 8,192 (where one f32 chain of K products
   reaches the gate's atol) against float64 within 4x cuBLAS's f32 error, a
   limit cuBLAS's TF32 must miss, and at the bf16 gate; 6b's nine block
   layouts (the forward over 8,192 tokens, dX through the weights'
   transposed views, dW folded over the tokens at K = 8,192) each planned
   on the tensor-core tile and launched there (``tc_launches``), against
   float64 within the same 4x cuBLAS's f32 error that TF32 must miss, and
   so Mellum 2's six expert layouts (an expert's nine products) at a
   ragged M of 4,093 rows, K or N of 896; split-K reruns bit-identical.
   Then each product's device time through the kernel and torch.matmul
   (cuBLAS, TF32 off: the plain version) in turns, with its plan (tile,
   split, cluster) and bound, and the sums of a flagship step, the eval, a
   config-8 step, a 6b step's 36 block products and all its 39, and a
   Mellum 2 expert's nine (bounds at 3xTF32); the flagship step's 14 back
   to back.
4. fused epoch vs plain: K2 against ``fused_epoch_reference`` on the card
   for 10 flagship steps from pinned seed-1 weights: losses (rtol 1e-5,
   atol 1e-6), parameters, Adam slots and the step count (rtol 1e-4, atol
   1e-5); a second run from the same state must give bit-identical losses;
   under bf16 matmul precision losses within rtol 1e-3 that differ from the
   f32 run (a bf16 epoch sums each product in one K slice). Then both
   times at the main path's shape, a 390-step epoch, the plan, and the
   kernel's time in each of its phases.
4a. dropout pass vs plain: P1 against ``dropout_reference`` bit for bit at
   tpu_check's 256x256 tile (seeds 1 and 2), the flagship's [128, 200] and
   6b's [4, 2048, 512] (a seed past the int32 wrap); tpu_check's
   statistics on a tile of ones at rate 0.5 (zero fraction within 0.02 of
   0.5, survivors 2.0, seeds 1 and 2 differing on over 30% of cells); the
   kernel's, the plain version's and F.dropout's times at the flagship's
   and 6b's shapes.
4b. K2 with Dropout: the flagship with Dropout(0.3) after its two first
   ReLUs, K2 against ``fused_epoch_reference`` over the 10 pinned steps
   (Adam from step 0, SGD and Adam from step 3000; the last but at the
   elements ``sign_margins`` marks), at K2's gates, reruns bit-identical;
   a 390-step epoch of each timed; the step loop's launches
   (14 K1 and 2 P1 a step) and its losses against K2's over 5 steps (K2's
   gates: the masks are the same); tpu_check.py's run, rate 0.0 against
   0.3 (synthetic_mnist(12800, 2000), Adam 1e-3, 5 epochs, fused="auto"):
   one K2 launch an epoch and nothing else, finite losses, the last below
   half the first, the two runs different, the accuracies.
4c. K2 optimizer sweep: each of the seven rules, a warmup-cosine schedule
   and clip_norm on the flagship: K2 against its plain version over the 10
   pinned steps (Lion's state but at the elements ``sign_margins`` marks),
   reruns bit-identical; two fused="auto" epochs (one K2 launch each,
   counted over both, the second timed); the first epoch's losses against
   the plain version's over the same epoch, held over its first 10 steps
   (K2's loss gate), the gap over the whole epoch printed beside that
   between the plain version on the card and on the CPU; a fused=False
   epoch (steps/s of both).
4d. optimizer probe vs plain: P2 against ``mega_probe_reference`` after
   100 steps (rtol 1e-5) for each rule; bench_mega_probe_torch.py's four
   timings with their bounds, beside K2's optimizer phase and
   torch.optim.Adam(fused=True)'s step.
5. stream kernels vs plain: the deep MLP from seed-1 weights (the stack's
   times sqrt(2), so that every layer carries values of order 1), batch
   128: one K3 launch against ``stream_forward_reference`` (the acts
   stack, rtol 1e-4/atol 1e-4: a 98-layer chain of f32 sums in two
   orders), one K3b launch against ``stream_backward_reference`` for Adam
   and for SGD, each output at rtol 1e-4 and an atol of 1e-4 of its own
   largest plain value: the step w took, each slot, db, dh0; each rerun
   bit-identical. Adam's step is held to Adam's rule on the kernel's own
   new m and v: its step lr g / (|g| + eps) turns the rounding of a
   gradient near eps into a step difference, so a few hundred of the 6.4
   million weights land further from the plain version's (counted, with
   their |g|, printed, and in the kernels line). Then five whole streaming steps from
   the main path's Xavier weights through the kernels against the same
   steps through the plain versions (losses rtol 1e-5/atol 1e-6,
   parameters and slots rtol 1e-4/atol 1e-5), with Adam and with SGD,
   from seed 7, where no ReLU unit of the five Adam steps has a
   pre-activation within rounding of 0 (``stream_seed_scan.py`` shows what
   such a unit does on other seeds); then each kernel's time a launch
   (CUDA events, and device time: ``device_us``), its plain
   version's, and its bound.
6. slice: one epoch with ``fused="auto"``, which must be one K2 launch and
   no K1 launch, test accuracy above 0.9, then a second K2 epoch, timed.
   From the same seed in a fresh model, one ``fused=False`` epoch (the
   step loop), 3 eager steps, a predict and an evaluate_batch: K1 must be
   launched 14 times per train step plus 5 per forward, and K2 never.
   Each path's launch counts are set to 0 before it and read after it.
   Both epochs' steps/s; the two accuracies within 0.02.
6a. data parallel: K6 and P3 vs plain. P3 at tests/test_dp_megakernel.py's
   8 ranks of [8, 128] (arange) against the sum (rtol 1e-6) and its plain
   version bit for bit, and at 2, 3, 4 and 16 ranks of the flagship's
   186,610 gradient floats bit for bit; each rerun with one rank held back
   200 us before its arrival, bit-identical; the kernel's, the plain
   version's and torch.stack(xs).sum(0)'s device times at each
   rank count; the main path ``ring_all_reduce`` at JAX's shape and 4
   ranks, counted. K2 with K6 on 4 ranks of 32 rows over the 10
   pinned steps (seed-1 weights; data seed 5, and 15 for the Dropout
   flagship: on seed 5 a ReLU input of a rank lies within rounding of 0):
   every rank's losses and state at K2's gates, a rerun and a rerun with
   rank 1 held back bit-identical; one rank through the ranked wrapper
   bit for bit with K2; the kernel's and the plain version's ms for a
   390-step epoch of 4 ranks, its plan, the kernel's time by phase (the
   ring's us/step: the all-rank arrival and the pass) beside its bound.
   Then the
   main path: ``DataParallel(Model(build_mnist_mlp(),
   ...), mesh=make_mesh(devices=[cuda] * 4)).train_epochs(fused="auto")``
   from seed 0 on synthetic MNIST 50,000/10,000: one ranked K2 launch an
   epoch, accuracy above 0.9 after the first, the replica spread, two more
   epochs timed; one fused=False epoch (the step tier: 56 K1 launches a
   step), its accuracy within 0.02; one epoch of the Dropout flagship
   through K2 with K6. Steps/s of both tiers beside single-rank K2's.
7. deep slice: ``Model(build_deep_mlp(stacked=True), ..., Adam(1e-3),
   device="cuda").train_epochs(fused="auto")`` from seed 0, three epochs
   of 20 steps: K3 and K3b once a step, K2 never, K1 5 a step (prefix and
   suffix forward, suffix dW and dx, prefix dW); finite losses whose epoch
   mean falls; the steps/s of the timed epochs after the first. The same
   with SGD(0.01). Then one ``fused=False`` epoch from the same weights
   (``dense_stack_`` on K1: 5 + 294 launches a step), its steps/s and the
   gap between its losses and the stream tier's.
8. attention kernels vs plain: the forward, dq and dk/dv kernels against
   ``attention_forward_reference``/``attention_backward_reference`` at
   every shape of ATTN_SHAPES (config 6b's, the TPU's K4b and K4c shapes,
   config 6's, windows of 512 and of 40 over a ragged 300, GQA 8q/2kv,
   cross attention 256/384, dropout 0.1, head dims 128 with GQA and
   dropout, and 40, Mellum 2's 32:4 GQA of head dim 128 over 4 x 8,192
   tokens banded to 1,024 keys and full; at the split head dims of
   multi-head latent attention, 192-wide q and k with 128-wide v, GQA with
   a window of 40 over a ragged 300 and dropout, cross attention at
   160/96, and Moonlight's 16 heads over 2 x 8,192 tokens, causal; the
   plain versions a (batch row, kv head) group at a time at the 8,192-token
   shapes), o and lse at rtol 1e-4/atol 1e-5,
   dq/dk/dv at rtol 1e-4 and an atol of 1e-4 of their own largest plain
   value, reruns bit-identical; at config 6b and K4c's shape the three kernels (3xTF32
   on the tensor cores) against a float64 plain version, o, lse, dq, dk
   and dv each within 4x the f32 plain version's error, a limit the plain
   version with TF32 allowed must miss; then at config 6b, K4b's and K4c's
   shapes each kernel's time, its plain version's, SDPA's (forward, and
   backward by autograd.grad), the pair plus the delta reduction beside
   SDPA's backward, and the bounds (at 3xTF32 on the tensor cores, and at
   f32 FMA beside them). Every dq and dk/dv launch at a head dim of
   65-128, and every dk/dv launch at split head dims, and none other,
   counts in its wrapper's ``wgmma_launches`` (the wgmma kernels), and
   every launch at split head dims, and none other, in its wrapper's
   ``split_launches``; the dq and the dk/dv kernel are
   each timed alone at Mellum 2's two shapes beside their bounds (6 d and
   8 d FLOPs a visible pair at 3xTF32), and the three kernels at
   Moonlight's (2 (d_qk + d_v), 2 (2 d_qk + d_v) and 4 (d_qk + d_v)). The
   tolerances hold at split dims for the same reasons (sums over at most
   192 dims and 8,192 keys). With ``--parent <checkout>``, then
   ``bench_vs_parent.py --mode same``: the three kernels at head dims 32,
   64 and 128 (Mellum 2's two shapes included) bit-identical to the
   parent's on the same inputs, with both times in turns.
9. transformer slice: ``Model(build_tiny_transformer(**6b), ...,
   device="cuda").train_epochs(fused="auto")``, 3 epochs of 64 steps: each
   step launches each attention kernel twice (two blocks) and K1 39 times
   (each block's six Dense products forward, dX and dW, 36 on the
   tensor-core tile, and the head Dense's three), each eval forward K1 13
   times (12 on the tile), K2, K3 and K3b never; finite losses; the
   steps/s of epochs 2-3; an evaluate_batch on 32 held-out sequences. Then
   5 Adam steps with attn="fused" against 5 with attn="tape" from the same
   weights (losses within rtol 1e-4) and a timed attn="tape" epoch (K1 39
   a step; its batched score products stay torch.matmul).
9a. transformer slice with dropout: config 6b with dropout=0.1 and
   attn_dropout=0.1, one epoch: P1 twice a block a step (the residual
   sites; the attention probabilities drop inside K4 and K4d), each
   attention kernel once a block, K1 39 a step (36 on the tensor-core
   tile); finite losses.
9b. Mellum 2 slice: ``Model(build_moe_lm(**MELLUM2_SLICE), ...,
   device="cuda").train_step``, 3 steps of 2 x 2,048 ids at Mellum 2's
   attention widths (32:4 GQA of head dim 128, 3 layers banded to 1,024
   keys, 1 full YaRN layer; hidden 512, 2 held experts of 64): each
   attention kernel once a layer a step, every dq and dk/dv launch on the
   wgmma kernels (each ``wgmma_launches`` equal to its wrapper's
   launches); finite losses.
9c. Moonlight slice: ``Model(build_mla_moe_lm(**MOONLIGHT_SLICE), ...,
   device="cuda").train_step``, 3 steps of 2 x 2,048 ids at Moonlight's
   attention widths (16 heads of 192/128, a 512 latent, causal; hidden
   512, a dense layer, 2 held experts of 64 behind a sigmoid top-6 of 64,
   a shared expert): each attention kernel once a layer a step, every
   launch at the split dims (each ``split_launches`` equal to its
   wrapper's launches), every dk/dv launch on the split wgmma kernel
   (dk/dv's ``wgmma_launches`` equal to its split launches) and no dq
   launch on wgmma; finite losses.
10. recurrent kernels vs plain: K5, K5b, K5c and K5d against their plain
   versions at config 8's shape (zero initial states) and a ragged one
   (B=3, T=7, H=100, random h0/c0), both directions; forwards at rtol
   1e-4/atol 1e-5, backwards at rtol 1e-4 and an atol of 1e-4 of their own
   largest plain value; reruns bit-identical. Then at config 8 each
   kernel's plan (cluster size, rows, the clusters the card holds at
   once), time (CUDA events, in turns with the plain version), block 0's
   time by phase, bound, and cuDNN's layer (torch.nn.LSTM/GRU, TF32 off)
   beside the port's layer.
11. recurrent slice: ``Model(build_rnn_classifier(**config8), ...,
   device="cuda").train_epochs(fused="auto")``, 3 epochs of 32 steps: K5
   and K5b twice a step, K1 10 times, K2, K3, K3b and K4 never; finite
   losses; an evaluate_batch; 5 Adam steps against impl="plain" from the
   same weights (losses within rtol 1e-4); a timed impl="plain" epoch; one
   GRU epoch and one two-layer Bidirectional LSTM epoch at the same widths,
   each with its launch counts.
11a. block forward vs plain: bench_block_probe_torch.py's ``probe_shape``
   at its four shapes (the launch counts set to 0 before each shape and
   read after it): K7 against ``block_fwd_reference`` and against the tape
   block's forward (``attn="fused"``), and ``TransformerEncoderLayer``
   with the same weights against the plain version, each at rtol 1e-4 and
   an atol of 1e-4 of the plain output's largest value; at config 6's
   block and 6b's the times of the kernel, the tape forward, the library
   call and the plain version (``device_us``, TF32 off) beside the bound,
   and K7's time in each of its phases. Then at each shape two more
   launches: bit-identical, one launch each.
12. trace: torch.profiler over 50 step-loop train steps (device busy share,
   the kernels that take the device time), over one K2 epoch, over one
   stream epoch (busy share, K3 and K3b device time a step), over 10
   transformer steps (busy share, the attention kernels' device time a
   step) and over 10 config-8 steps (busy share, K5 and K5b).
13. parity: 5 train steps on the GPU and 5 on the CPU from the same seeded
   initial weights; losses agree to rtol 1e-5, atol 1e-6.

Prints the card line, one JSON line of kernel results, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available or any phase fails.

Run from the repository root:  python3 chip_smoke.py [--parent _parent]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch import Tensor, ops  # noqa: E402
from tinynn_autograd_tpu_torch.models import (  # noqa: E402
    build_deep_mlp, build_mnist_mlp, build_rnn_classifier,
    build_tiny_transformer,
)
from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator  # noqa: E402
from tinynn_autograd_tpu_torch.nn.layers import (  # noqa: E402
    LSTM, Bidirectional, Dense, Dropout, ReLU,
)
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu_torch.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu_torch.nn.net import Net  # noqa: E402
from tinynn_autograd_tpu_torch.nn.optimizer import (  # noqa: E402
    SGD, Adadelta, Adagrad, Adam, Lion, Momentum, RMSProp,
)
from tinynn_autograd_tpu_torch.nn.scheduler import WarmupCosineLR  # noqa: E402
from tinynn_autograd_tpu_torch.ops import (  # noqa: E402
    attention, block_kernel, dropout, fused_epoch, kernels, mega_probe,
    ring_allreduce,
)
from tinynn_autograd_tpu_torch.ops import recurrent_kernel as rk  # noqa: E402
from tinynn_autograd_tpu_torch.ops import streaming_epoch as se  # noqa: E402
from tinynn_autograd_tpu_torch.parallel import DataParallel, make_mesh  # noqa: E402
from tinynn_autograd_tpu_torch.utils import seeder  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import one_hot, synthetic_mnist  # noqa: E402
from tinynn_autograd_tpu_torch.utils.timing import device_us  # noqa: E402

import bench_block_probe_torch as block_bench  # noqa: E402
import bench_mega_probe_torch as probe_bench  # noqa: E402

BATCH = 128
LAYERS = [(784, 200), (200, 100), (100, 70), (70, 30), (30, 10)]
# (m, k, n, a transposed, b transposed): per layer the forward x @ W, the
# weight gradient x^T @ g, and the input gradient g @ W^T (not for layer 1)
STEP_SHAPES = ([(BATCH, i, o, False, False) for i, o in LAYERS]
               + [(i, BATCH, o, True, False) for i, o in LAYERS]
               + [(BATCH, o, i, False, True) for i, o in LAYERS[1:]])
EVAL_SHAPE = (10000, 784, 200, False, False)
RAGGED = [(130, 129, 131, False, False), (1, 784, 200, False, False)]
# config 8's ten products a train step (two LSTM layers of 256, T = 128,
# batch 64; ops/recurrent.py): the input projections, the head's forward,
# weight and input gradients, layer 2's dx through wx^T, each layer's dWx
# and dWh through its transposed [T B, D] sequences (K = 8,192)
CONFIG8_SHAPES = [(8192, 64, 1024, False, False),
                  (8192, 256, 1024, False, False),
                  (64, 256, 16, False, False), (256, 64, 16, True, False),
                  (64, 16, 256, False, True), (8192, 1024, 256, False, True),
                  (256, 8192, 1024, True, False),
                  (256, 8192, 1024, True, False),
                  (64, 8192, 1024, True, False),
                  (256, 8192, 1024, True, False)]
# 6b's head's three products a step ([4, 512] @ [512, 16] and both
# gradients), on the CUDA-core tiles
CONFIG6B_SHAPES = [(4, 512, 16, False, False), (512, 4, 16, True, False),
                   (4, 16, 512, False, True)]
# 6b's block products as the tape hands them to K1, each with its count in
# a block (two blocks a step: 36 products), all on the tensor-core tile:
# the forward over the step's 8,192 tokens ([8192, 512] @ [512, 512] for
# q, k, v and the output projection, the MLP's [512, 2048] and [2048,
# 512]); the input gradients through the weights' transposed views; the
# weight gradients X^T @ G folded over all the tokens (K = 8,192), X^T the
# transposed view of the [4, 2048, .] activations
CONFIG6B_BLOCK = [((8192, 512, 512, False, False), 4),
                  ((8192, 512, 2048, False, False), 1),
                  ((8192, 2048, 512, False, False), 1),
                  ((8192, 512, 512, False, True), 4),
                  ((8192, 2048, 512, False, True), 1),
                  ((8192, 512, 2048, False, True), 1),
                  ((512, 8192, 512, True, False), 4),
                  ((512, 8192, 2048, True, False), 1),
                  ((2048, 8192, 512, True, False), 1)]
# Mellum 2's expert products as ``grouped_swiglu_`` hands them to K1, on one
# held expert's block of a ragged M = 4,093 rows (~4,096 tokens an expert
# a step), each with its count an expert: the forward's gate and up
# ([M, 2304] @ [2304, 896]) and down ([M, 896] @ [896, 2304]); dh through
# down's transposed view, dX's two through gate's and up's; ddown as
# (act * up)^T @ dE and dgate, dup as X^T @ dG, folded over the M rows
MELLUM2_EXPERT = [((4093, 2304, 896, False, False), 2),
                  ((4093, 896, 2304, False, False), 1),
                  ((4093, 2304, 896, False, True), 1),
                  ((4093, 896, 2304, False, True), 2),
                  ((896, 4093, 2304, True, False), 1),
                  ((2304, 4093, 896, True, False), 2)]
# config 8's products past K = LONG_K on unit-normal operands: there the
# rounding of an f32 sum reaches the f32 gate's atol (on the H100 K1's one
# chain of K products an output errs by 2.6-3.9e-4 against float64 at
# K = 1,024 and 8,192, cuBLAS by 1.3-2.1e-4), so they are held against
# float64 within LONG_K_FACTOR times cuBLAS's own f32 error on the same
# operands (K1 took 1.7-2.9 times it; TF32 over 100 times)
LONG_K = 256
LONG_K_FACTOR = 4.0
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
# The data of the 10-step K2 parity check. Adam turns a weight gradient whose
# terms nearly cancel (or a ReLU input within rounding of 0) into a full-size
# step, so two f32 summation orders can leave a few weights 1e-5 apart; the
# seed is pinned to data that has no such weight (PERF.md).
PARITY_DATA_SEED = 5
# Lion's step is lr sign(u) whatever |u| is, and Adam's from zero slots at a
# large step count ~3 lr sign(g) until sqrt(v) nears eps: where u (or
# sqrt(v)) is within rounding of 0, the two summation orders give steps 2 lr
# apart, and the weights they move change every gradient a little in the
# steps after. Their holds leave out the elements whose plain-version u (or
# sqrt(v) s1) came under this share of its leaf's largest (sign_margins):
# f32 sums of 128 products differ by up to ~2^-17 of their terms' size.
SIGN_MARGIN = 2.0 ** -16
# Lion's step-by-step hold runs on data seed 4: over its 10 plain steps no
# ReLU input of the pinned Dropout flagship comes within 1.8e-6 of its
# layer's largest. On seed 5 one comes within 2.9e-8 at step 2; on the H100
# the two summation orders put it on different sides of 0, its column of
# the first layer's weight gradient differs by 3% of the leaf's largest,
# and Lion turns that into steps 2 lr apart (every other gradient within
# 1.4e-6). k2_seed_scan.py shows both seeds.
LION_DATA_SEED = 4
# The sweep's epoch on the main path is held to its plain version over its
# first steps, at K2's loss gate; past them the gap grows with training.
SWEEP_HELD_STEPS = 10
EPOCH_STEPS = 390  # a flagship epoch: 50,000 samples at batch 128
# The deep MLP (the JAX package's deep-graph config): 256 -> 256, ReLU, a
# DenseStack of 98 layers of 256x256, 256 -> 10; batch 128, 2,560 samples (20
# steps an epoch), its weights from seed 1 for the kernel checks and seed 0
# for the slice.
DEEP = dict(num_in=256, depth=100, width=256, num_out=10, stacked=True)
DEEP_SAMPLES = 2560
# The kernel checks scale the stack's Xavier weights by sqrt(2): at Xavier
# gain a ReLU layer shrinks its input ~0.7x, so the deep layers would carry
# values of 1e-15 and hide any error there; at sqrt(2) every layer carries
# values of order 1.
DEEP_GAIN = float(np.sqrt(2.0))
# K3 against its plain version: a 98-layer chain of f32 sums in two orders,
# whose error grows with depth
STREAM_TOL = dict(rtol=1e-4, atol=1e-4)
# K3b's outputs differ in size by orders of magnitude (Adam's v is 1e-3 g^2,
# a weight's step 1e-3 of the weight): each is held at rtol 1e-4 and an atol
# of 1e-4 of its own largest plain value
SCALED_TOL = dict(rtol=1e-4, atol=1e-4)
# The weights of the five-step check. Where a ReLU unit's pre-activation is
# within rounding of 0, the two forwards' sums in two orders can leave it
# active in one run and not in the other, and the gradients of its row
# below it differ. Adam's step lr g / (|g| + eps) changes most with g where
# |g| is near eps, so a change of a small g moves the state past STATE_TOL.
# stream_seed_scan.py shows it seed by seed: with Adam seed 7's five steps
# have no such unit; with SGD one unit flips before step 5 and moves nothing
# past STATE_TOL.
STEPS_SEED = 7
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): f32 FMA
# outside the tensor cores, dense TF32 on the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12
# Config 6b of bench_all.py (bench_transformer_long): the long-context causal
# transformer classifier, 7.49 M parameters, head dim 64; batch 4, Adam 1e-3,
# 256 sequences of random tokens (64 steps an epoch) and random labels from
# numpy seed 0; its weights from seed 0 for the slice, seed 1 for the
# fused-vs-tape check. Nothing is cut but the run: 3 epochs.
TRANSFORMER = dict(vocab=256, seq_len=2048, dim=512, heads=8, depth=2,
                   num_out=16, causal=True)
T_BATCH = 4
T_SAMPLES = 256
T_EVAL = 32
T_PARITY_STEPS = 5
# The attention kernels' checks, (B, H, Hkv, Tq, Tk, d, causal, window,
# dropout): config 6b's shape (K4's row-band forward and K4d's gridded
# backward on the TPU), the shapes that take K4b (T=512) and K4c (non-causal
# T=2048) there, config 6's, a 512 window over 2048 (config 6d), a window
# narrower than a tile over a ragged T, GQA 8q/2kv, cross attention, dropout,
# and Mellum 2's two layer kinds at its step (32:4 GQA of head dim 128 over
# 4 x 8,192 tokens, banded to 1,024 keys, or full). d is one head dim for q,
# k and v, or a pair (d_qk, d_v): multi-head latent attention's split dims,
# at Moonlight's step (16 heads of 192/128, causal, over 2 x 8,192 tokens),
# and small shapes that take GQA, a window narrower than a tile over a
# ragged T with dropout, and cross attention at split dims inside
# 192/128 (160/96, zero-padded)
ATTN_SHAPES = {"config6b": (4, 8, 8, 2048, 2048, 64, True, None, 0.0),
               "k4b_t512": (4, 8, 8, 512, 512, 64, True, None, 0.0),
               "k4c_noncausal": (4, 8, 8, 2048, 2048, 64, False, None, 0.0),
               "config6": (32, 8, 8, 128, 128, 32, False, None, 0.0),
               "window512": (4, 8, 8, 2048, 2048, 64, True, 512, 0.0),
               "window40_ragged": (2, 4, 4, 300, 300, 64, True, 40, 0.0),
               "gqa_8q_2kv": (2, 8, 2, 256, 256, 64, True, None, 0.0),
               "cross_256_384": (2, 4, 4, 256, 384, 64, False, None, 0.0),
               "dropout": (1, 4, 4, 2048, 2048, 64, True, None, 0.1),
               "d128_gqa_dropout": (1, 4, 2, 200, 200, 128, True, None, 0.1),
               "d40": (1, 2, 1, 100, 100, 40, False, None, 0.0),
               "mellum2_sliding": (4, 32, 4, 8192, 8192, 128, True, 1024,
                                   0.0),
               "mellum2_full": (4, 32, 4, 8192, 8192, 128, True, None, 0.0),
               "split_gqa_window_dropout": (1, 4, 2, 300, 300, (192, 128),
                                            True, 40, 0.1),
               "split_cross": (1, 2, 2, 100, 130, (160, 96), False, None,
                               0.0),
               "moonlight": (2, 16, 16, 8192, 8192, (192, 128), True, None,
                             0.0)}
# the plain versions hold [B, H, Tq, Tk] scores whole; past PLAIN_SCORES
# elements (Mellum 2's 34 GB a tensor) they run one (batch row, kv head)
# group at a time: its query heads against its kv head, dk and dv summed
# over the group whole
PLAIN_SCORES = 2 ** 30
ATTN_MAIN = "config6b"
# timed too: the shapes that take K4b and K4c on the TPU
ATTN_TIMED = ("k4b_t512", "k4c_noncausal")
# the dq and the dk/dv kernel each timed alone at Mellum 2's two layer kinds
ATTN_BWD_TIMED = ("mellum2_sliding", "mellum2_full")
# the three kernels each timed alone at Moonlight's split dims
ATTN_SPLIT_TIMED = ("moonlight",)
ATTN_SEED = 1234
# O and lse: sums of up to 2048 f32 terms in another order. dq, dk and dv
# differ in size by shape; each is held at rtol 1e-4 and an atol of 1e-4 of
# its own largest plain value, as K3b's outputs are. Under dropout one keep
# decision that differs from the plain hash moves an output by ~p v / (1 -
# rate), far past these.
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-4
# the attention kernels' float64 hold (their products in 3xTF32 on the
# tensor cores): at these shapes each of o, lse, dq, dk and dv within
# F64_FACTOR times the f32 plain version's own max error against a float64
# plain version (TF32 off), as K1's long-K products are held; the plain
# version with TF32 allowed must miss that limit
ATTN_F64 = ("config6b", "k4c_noncausal")
F64_FACTOR = 4.0
# fused vs tape losses over 5 Adam steps: the same math with sums in other
# orders
PARITY_RTOL = 1e-4
# Config 8 of bench_all.py (bench_rnn): the stacked-LSTM sequence
# classifier, build_rnn_classifier(num_in=64, num_out=16, hidden=(256, 256),
# cell="lstm", seed=77) after random_seed(0); T=128, batch 64, Adam 1e-3,
# softmax-CE; 2,048 sequences from numpy seed 0 (32 steps an epoch) and 64
# held-out ones from seed 1. Nothing is cut but the run: 3 epochs (the bench
# times 12).
RNN = dict(num_in=64, num_out=16, hidden=(256, 256), cell="lstm", seed=77)
RNN_T = 128
RNN_BATCH = 64
RNN_SAMPLES = 2048
RNN_PARITY_STEPS = 5
# The recurrent kernels' checks, (B, T, H): config 8's (zero initial states,
# as the slice has them) and a ragged one with random initial states
RNN_SHAPES = {"config8": (RNN_BATCH, RNN_T, 256), "ragged": (3, 7, 100)}
# the forwards' outputs: 128 steps of f32 sums in another order; the
# backwards' are held as the attention gradients are (GRAD_RTOL, GRAD_ATOL)
RNN_TOL = dict(rtol=1e-4, atol=1e-5)
# P1 against its plain version, (shape, seed): tpu_check's tile for seeds 1
# and 2, the flagship's first Dropout, a 6b residual site with a seed past
# the int32 wrap (step 3000's second seeded layer)
DROPOUT_RATE = 0.3
DROPOUT_SHAPES = {"tile_seed1": ((256, 256), 1), "tile_seed2": ((256, 256), 2),
                  "flagship": ((BATCH, 200), 7),
                  "config6b": ((4, 2048, 512), 3000 * 1000003 + 1)}

# K7's probe: bench_block_probe_torch.py's shapes; the times at config 6's
# block and 6b's, the kernels line's numbers at 6b's
BLOCK_TIMED = ("config6", "config6b")
BLOCK_MAIN = "config6b"
# data parallel (BASELINE.json configuration 5): ranks sharing the card, the
# global batch of 128 split among them; P3 at tests/test_dp_megakernel.py's
# shape (n ranks, each's [8, 128])
DP_RANKS = 4
DP_LOCAL = BATCH // DP_RANKS
RING_JAX = (8, (8, 128))
RING_SKEW_US = 200.0  # the hold of one rank before its arrival
# the Dropout flagship's K6 hold: on data seed 5 a rank's ReLU input comes
# within rounding of 0 and one weight moves past the state gate
# (`k2_seed_scan.py --device cpu --ranks` ranks the seeds)
K6_DROPOUT_DATA_SEED = 15


def phase(name):
    print("== %s" % name, flush=True)


def bound(flops, n_bytes, peak=PEAK_F32_FLOPS):
    """(least ms the card could take, "operations" or "bytes"), the
    operations at ``peak`` FLOP/s (f32 FMA by default)."""
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32(flops, n_bytes):
    """``bound`` for f32 products done in 3xTF32 on the tensor cores: three
    TF32 products each, at the dense TF32 peak."""
    return bound(3.0 * flops, n_bytes, peak=PEAK_TF32_FLOPS)


def product_cost(m, k, n):
    """FLOPs and bytes of one f32 [m,k] @ [k,n]: each input read once, the
    output written once."""
    return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)


def epoch_cost(spec, n_steps, batch):
    """FLOPs and bytes of a whole-epoch kernel launch. FLOPs: the products
    (forward, weight gradients, input gradients but the first layer's);
    the elementwise work (activations, loss, optimizer, about 2% more) is
    left out, so the bound is a little low. Bytes: the batches, the losses,
    and the parameters and the rule's slots read once and written once."""
    macs = [d_in * d_out for d_in, d_out, *_ in spec.layers]
    flops = 2.0 * batch * (2 * sum(macs) + sum(macs[1:])) * n_steps
    leaves = sum(d_in * d_out + d_out for d_in, d_out, *_ in spec.layers)
    n_state = 1 + len(spec.slot_names)
    n_bytes = 4.0 * (n_steps * batch * (spec.layers[0][0] + spec.layers[-1][1])
                     + n_steps + 2 * n_state * leaves)
    return flops, n_bytes


def stream_costs(n_layers, batch, width, n_slots):
    """FLOPs and bytes of one K3 and one K3b launch. K3: the L products
    [B,W] @ [W,W]; h0, w and b read once, acts written once. K3b: the dh and
    dW products (its elementwise work, about 1% more, left out); h0, the
    loss gradient, acts, w and the slots read once, w, the slots, db and
    dh0 written once."""
    product = 2.0 * n_layers * batch * width * width
    stack = n_layers * width * width
    rows = batch * width
    k3 = (product, 4.0 * (rows + stack + n_layers * width
                          + n_layers * rows))
    k3b = (2 * product, 4.0 * (2 * rows + n_layers * rows
                               + 2 * (1 + n_slots) * stack
                               + n_layers * width + rows))
    return k3, k3b


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
    """(device us, launches, name) of every device kernel in a profile;
    not the program's spans (``tinynn.*``), which the profiler also lays
    on the device's timeline, over the kernels they enclose."""
    from torch.autograd import DeviceType

    return [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not ev.key.startswith("tinynn.")]


def product_name(m, k, n, ta, tb):
    return "[%d,%d]%s@[%d,%d]%s" % (m, k, "T" if ta else "", k, n,
                                    "T" if tb else "")


def hold_product(got, ref, dtype, what):
    """Kernel vs plain at the K1 gate; returns the max abs error."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError("%s: got %s %s, plain %s %s" % (
            what, got.dtype, tuple(got.shape), ref.dtype, tuple(ref.shape)))
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(g, r, err_msg=what, **TOL[dtype])
    return float(np.max(np.abs(g - r)))


def long_k_errors(a, b, got):
    """The largest |C - A B| (A B in float64) of the kernel's C (``got``),
    cuBLAS's f32 C (TF32 off) and cuBLAS's TF32 C, on the same operands."""
    exact = torch.matmul(a.double(), b.double())
    f32 = torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return [float((c.double() - exact).abs().max()) for c in (got, f32, tf32)]


def config8_operands(device):
    """The operands of a config-8 train step's ten products, as K1 sees them
    (transposed views included): one step of the config-8 model from seed 0
    on its first batch, each product's (a, b) recorded."""
    tx, ty, _, _ = rnn_data()
    model = rnn_model(device)
    seen = []
    matmul = kernels.matmul

    def record(a, b):
        seen.append((a.clone(), b.clone()))
        return matmul(a, b)

    kernels.matmul = record
    try:
        model.train_step(tx[:RNN_BATCH], ty[:RNN_BATCH])
        torch.cuda.synchronize()
    finally:
        kernels.matmul = matmul
    shapes = [(a.shape[0], a.shape[1], b.shape[1]) for a, b in seen]
    if sorted(shapes) != sorted((m, k, n) for m, k, n, _, _ in
                                CONFIG8_SHAPES):
        raise AssertionError("a config-8 step made the products %s" % shapes)
    return seen


def time_products(shapes, operand_pairs, counts=None, bound_of=bound):
    """Device us of each product through the kernel and torch.matmul
    (cuBLAS, f32, TF32 off; also the plain version), in turns: cuBLAS,
    kernel, kernel, cuBLAS. Prints each with its plan and its bound
    (``bound_of``: at the f32 FMA peak by default); returns the sums
    (kernel, cuBLAS, bound), each product taken ``counts`` times (once
    each by default)."""
    total = np.zeros(3)
    for i, (shape, (a, b)) in enumerate(zip(shapes, operand_pairs)):
        fns = (lambda: torch.matmul(a, b), lambda: kernels.cuda_matmul(a, b))
        lib, new, new2, lib2 = (device_us(fns[j]) for j in (0, 1, 1, 0))
        m, k, n = shape[:3]
        times = np.array([(new + new2) / 2, (lib + lib2) / 2,
                          1e3 * bound_of(*product_cost(m, k, n))[0]])
        count = 1 if counts is None else counts[i]
        total += count * times
        plan = kernels.plan_matmul(m, n, k,
                                   aligned=kernels.tc_aligned(a, b))
        print("  %-24s %9.2f %9.2f %9.3f   config %d (%dx%d tile), "
              "split %d (cluster of %d, K slices of %d)%s"
              % ((product_name(*shape),) + tuple(times)
                 + (plan.config, plan.bm, plan.bn, plan.split, plan.split,
                    plan.k_chunk, "" if counts is None
                    else "; %d a step" % count)))
    return total


def check_tc_products(device, gen, layouts, label):
    """``layouts`` [((m, k, n, ta, tb), count)] through K1's wrapper: each
    must plan the tensor-core tile and launch it (``tc_launches`` counts
    both launches of a rerun, which must be bit-identical). Held against
    float64 within LONG_K_FACTOR times cuBLAS's f32 error (K of 512 and
    more, where one f32 chain of K products reaches the f32 gate's atol), a
    limit cuBLAS's TF32 must miss; the largest difference from the plain
    version (``matmul_reference``) is printed beside it. Returns the
    operand pairs."""
    pairs = []
    for shape, _ in layouts:
        m, k, n = shape[:3]
        a, b = operands(*shape, torch.float32, device, gen)
        plan = kernels.plan_matmul(m, n, k, aligned=kernels.tc_aligned(a, b))
        if plan.config != kernels.MATMUL_TC:
            raise AssertionError("%s's %s plans %s, not the tensor-core tile"
                                 % (label, product_name(*shape), plan))
        before = (kernels.cuda_matmul.launches,
                  kernels.cuda_matmul.tc_launches)
        got = kernels.cuda_matmul(a, b)
        again = kernels.cuda_matmul(a, b)
        torch.cuda.synchronize()
        after = (kernels.cuda_matmul.launches,
                 kernels.cuda_matmul.tc_launches)
        if after != (before[0] + 2, before[1] + 2):
            raise AssertionError("%s's %s: two calls counted as %s launches "
                                 "and %s on the tensor-core tile" % (
                                     label, product_name(*shape),
                                     after[0] - before[0],
                                     after[1] - before[1]))
        if not torch.equal(got, again):
            raise AssertionError("%s's %s: a rerun differs"
                                 % (label, product_name(*shape)))
        mine, f32, tf32 = long_k_errors(a, b, got)
        plain = float((got - kernels.matmul_reference(a, b)).abs().max())
        print("  %s %-24s plan %s: max |C - A B| against float64: kernel "
              "%.3g, cuBLAS f32 %.3g, cuBLAS TF32 %.3g; limit %.3g (%g x "
              "cuBLAS f32); max |C - plain| %.3g"
              % (label, product_name(*shape), tuple(plan), mine, f32, tf32,
                 LONG_K_FACTOR * f32, LONG_K_FACTOR, plain))
        if not mine <= LONG_K_FACTOR * f32:
            raise AssertionError("%s's %s: the kernel's error %.3g is past "
                                 "%g x cuBLAS's %.3g" % (
                                     label, product_name(*shape), mine,
                                     LONG_K_FACTOR, f32))
        if not tf32 > LONG_K_FACTOR * f32:
            raise AssertionError("%s's %s: TF32's error %.3g is within the "
                                 "limit %.3g: the check cannot tell f32 from "
                                 "TF32" % (label, product_name(*shape), tf32,
                                           LONG_K_FACTOR * f32))
        pairs.append((a, b))
    print("%s's %d layouts on the tensor-core tile: within %g x cuBLAS "
          "f32's error against float64, TF32 past it, reruns bit-identical, "
          "each launch counted in tc_launches"
          % (label, len(layouts), LONG_K_FACTOR))
    return pairs


def check_kernel(device):
    """K1 against its plain version at the main paths' shapes (6b's block
    products against float64), and timed beside torch.matmul (cuBLAS).
    Returns
    the f32 max abs error and the sums (device ms) of a flagship train
    step's 14 products through the kernel and the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # plan_matmul's cost model takes each configuration's blocks an SM from
    # MATMUL_TILES: it must be what the card reports for the built kernel
    held = [kernels.matmul_occupancy(c, 1)[0]
            for c in range(len(kernels.MATMUL_TILES))]
    if held != [t[2] for t in kernels.MATMUL_TILES]:
        raise AssertionError("the card holds %s blocks an SM of K1's tile "
                             "configurations, MATMUL_TILES says %s" % (
                                 held, [t[2] for t in kernels.MATMUL_TILES]))
    print("K1's tile configurations, blocks an SM: %s, as MATMUL_TILES says"
          % held)
    gen = torch.Generator().manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (STEP_SHAPES + [EVAL_SHAPE] + CONFIG6B_SHAPES
                      + RAGGED):
            a, b = operands(*shape, dtype, device, gen)
            got = kernels.cuda_matmul(a, b)
            torch.cuda.synchronize()
            worst[dtype] = max(worst[dtype], hold_product(
                got, kernels.matmul_reference(a, b), dtype, str(shape)))
    # config 8: on a step's own operands at the gate; on unit-normal
    # operands at the gate where K <= LONG_K, and past it against float64
    # within LONG_K_FACTOR times cuBLAS's f32 error, a limit that TF32
    # must miss
    real = config8_operands(device)
    for a, b in real:
        got = kernels.cuda_matmul(a, b)
        worst[torch.float32] = max(worst[torch.float32], hold_product(
            got, kernels.matmul_reference(a, b), torch.float32,
            "config 8 step %s" % (tuple(a.shape) + tuple(b.shape),)))
    for shape in CONFIG8_SHAPES:
        a, b = operands(*shape, torch.float32, device, gen)
        got = kernels.cuda_matmul(a, b)
        if shape[1] <= LONG_K:
            worst[torch.float32] = max(worst[torch.float32], hold_product(
                got, kernels.matmul_reference(a, b), torch.float32,
                "config 8 %s" % (shape,)))
        else:
            mine, f32, tf32 = long_k_errors(a, b, got)
            print("  %s: max |C - A B| against float64: kernel %.3g, cuBLAS "
                  "f32 %.3g, cuBLAS TF32 %.3g; limit %.3g (%g x cuBLAS f32)"
                  % (product_name(*shape), mine, f32, tf32,
                     LONG_K_FACTOR * f32, LONG_K_FACTOR))
            if not mine <= LONG_K_FACTOR * f32:
                raise AssertionError("%s: the kernel's error %.3g is past "
                                     "%g x cuBLAS's %.3g" % (
                                         shape, mine, LONG_K_FACTOR, f32))
            if not tf32 > LONG_K_FACTOR * f32:
                raise AssertionError("%s: TF32's error %.3g is within the "
                                     "limit %.3g: the check cannot tell f32 "
                                     "from TF32" % (shape, tf32,
                                                    LONG_K_FACTOR * f32))
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        worst[torch.bfloat16] = max(worst[torch.bfloat16], hold_product(
            kernels.cuda_matmul(a16, b16),
            kernels.matmul_reference(a16, b16), torch.bfloat16, str(shape)))
    print("kernel vs plain: max_abs_err f32 %.3g (tol rtol 1e-5 atol 1e-4; "
          "config 8 on a step's operands, and on unit-normal ones where K <= "
          "%d), bf16 %.3g (tol rtol 2e-2 atol 2e-1)"
          % (worst[torch.float32], LONG_K, worst[torch.bfloat16]))
    block_pairs = check_tc_products(device, gen, CONFIG6B_BLOCK, "6b")
    expert_pairs = check_tc_products(device, gen, MELLUM2_EXPERT,
                                     "Mellum 2 expert")
    # split-K reruns
    split = 0
    for shape in STEP_SHAPES + CONFIG8_SHAPES + CONFIG6B_SHAPES + RAGGED:
        m, k, n = shape[:3]
        a, b = operands(*shape, torch.float32, device, gen)
        if kernels.plan_matmul(m, n, k, aligned=kernels.tc_aligned(
                a, b)).split == 1:
            continue
        if not torch.equal(kernels.cuda_matmul(a, b),
                           kernels.cuda_matmul(a, b)):
            raise AssertionError("%s: a split-K rerun differs" % (shape,))
        split += 1
    print("split-K reruns bit-identical at the %d split products" % split)

    print("  f32 product              device us: kernel    cuBLAS   bound"
          "     plan")
    step_pairs = [operands(*s, torch.float32, device, gen)
                  for s in STEP_SHAPES]
    step = time_products(STEP_SHAPES, step_pairs)
    # in turns: plain, kernel, kernel, plain
    launch = [launch_us(lambda: [f(*p) for p in step_pairs]) for f in (
        kernels.matmul_reference, kernels.cuda_matmul, kernels.cuda_matmul,
        kernels.matmul_reference)]
    evals = time_products([EVAL_SHAPE], [operands(*EVAL_SHAPE, torch.float32,
                                                  device, gen)])
    c8 = time_products(CONFIG8_SHAPES, real)
    print("  6b's step, bounds at 3xTF32 on the tensor cores (%.1f TFLOP/s)"
          % (PEAK_TF32_FLOPS / 3e12))
    c6b_head = time_products(CONFIG6B_SHAPES, [
        operands(*s, torch.float32, device, gen) for s in CONFIG6B_SHAPES],
        bound_of=bound_3xtf32)
    depth = TRANSFORMER["depth"]
    c6b_blocks = time_products(
        [s for s, _ in CONFIG6B_BLOCK], block_pairs,
        counts=[depth * c for _, c in CONFIG6B_BLOCK], bound_of=bound_3xtf32)
    n_blocks = depth * sum(c for _, c in CONFIG6B_BLOCK)
    expert = time_products(
        [s for s, _ in MELLUM2_EXPERT], expert_pairs,
        counts=[c for _, c in MELLUM2_EXPERT], bound_of=bound_3xtf32)
    for what, t in (("one flagship train step's 14 products", step),
                    ("the 10,000-row eval product", evals),
                    ("one config-8 step's 10 products", c8),
                    ("one 6b step's %d block products (tensor-core tile; "
                     "bound at 3xTF32)" % n_blocks, c6b_blocks),
                    ("one 6b step's %d products (bound at 3xTF32)"
                     % (n_blocks + len(CONFIG6B_SHAPES)),
                     c6b_blocks + c6b_head),
                    ("one Mellum 2 expert's %d products at M 4,093 (bound at "
                     "3xTF32)" % sum(c for _, c in MELLUM2_EXPERT), expert)):
        print("%s: device us kernel %.2f, cuBLAS %.2f; bound %.3f us; "
              "kernel at %.1f%% of the bound, %.2fx cuBLAS's time"
              % ((what,) + tuple(t) + (100.0 * t[2] / t[0], t[0] / t[1])))
    print("one train step's 14 products back to back, host dispatch "
          "included: launch us kernel %.2f (turns %.2f, %.2f), plain %.2f"
          % ((launch[1] + launch[2]) / 2, launch[1], launch[2],
             (launch[0] + launch[3]) / 2))
    return worst[torch.float32], step[0] / 1000.0, step[1] / 1000.0


def fresh_state(net, opt):
    """Copies of the net's parameters and the optimizer's zero slots, as
    trees."""
    params = [{k: v.clone() for k, v in d.items()} for d in net.params_tree()]
    return params, opt.init_state(params)["slots"]


def clone_state(params, slots):
    """Copies of a (params, slots) pair of trees."""
    def copy(tree):
        return [{k: v.clone() for k, v in d.items()} for d in tree]

    return copy(params), {k: copy(v) for k, v in slots.items()}


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
    print(plan_line(spec, BATCH))
    phase_ns = torch.zeros(2 * len(spec.layers) + 2, dtype=torch.int64,
                           device=device)
    fused_epoch.cuda_fused_epoch(spec, *pairs, xe, ye, se, phase_ns=phase_ns)
    per_step = phase_ns.cpu().numpy() / 1e3 / EPOCH_STEPS
    print("by phase, us/step (block 0's clock, barrier wait included): "
          + ", ".join("%s %.2f" % (name, t) for name, t in
                      zip(fused_epoch.phase_names(spec), per_step))
          + "; sum %.2f" % per_step.sum())
    return worst, ms, plain_ms, spec, per_step[-1]


def plan_line(spec, batch, n_ranks=1):
    """The plan K2 launches for ``spec`` at ``batch`` rows a rank: each
    layer's K-splits (forward, dW, dh), the cluster size, the blocks a rank
    and the co-resident blocks."""
    plan = fused_epoch.epoch_plan(spec, batch, n_ranks)
    grid = fused_epoch.kernel_grid(n_ranks > 1)
    return ("plan at %d rows a rank, %d rank%s: K-splits (forward, dW, dh) "
            "%s; clusters of %d, %d blocks a rank of %d co-resident"
            % (batch, n_ranks, "" if n_ranks == 1 else "s",
               " ".join("%d/%d/%d" % s for s in plan.splits), plan.cluster,
               plan.blocks, grid.clusters * grid.cluster))


def eager_step(model, xb, yb):
    model.zero_grad()
    pred = model.forward(xb)
    loss = model.loss.loss(pred, Tensor(yb, device=model.device))
    loss.backward()
    model.step()
    return float(loss.values)


def _wrappers():
    """Each kernel's wrapper, by the kernel's name in the kernels line."""
    return {"matmul": kernels.cuda_matmul,
            "fused_epoch": fused_epoch.cuda_fused_epoch,
            "streaming_forward": se.cuda_stream_forward,
            "streaming_backward": se.cuda_stream_backward,
            "attention_forward": attention.cuda_attention_forward,
            "attention_backward_dq": attention.cuda_attention_backward_dq,
            "attention_backward_dkv": attention.cuda_attention_backward_dkv,
            "lstm_forward": rk.cuda_lstm_forward,
            "lstm_backward": rk.cuda_lstm_backward,
            "gru_forward": rk.cuda_gru_forward,
            "gru_backward": rk.cuda_gru_backward,
            "dropout": dropout.cuda_dropout,
            "mega_probe": mega_probe.cuda_mega_probe,
            "block_forward": block_kernel.cuda_block_fwd,
            "ring_all_reduce": ring_allreduce.cuda_ring_all_reduce,
            "fused_epoch_ring": fused_epoch.cuda_fused_epoch_ranks}


def launch_counts():
    """Each kernel wrapper's launches since zero_counts()."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    kernels.cuda_matmul.tc_launches = 0


def transformer_k1(steps, forwards=0):
    """K1's launches in ``steps`` 6b train steps and ``forwards`` eval
    forwards, and those of them on the tensor-core tile: a step's block
    products (six Dense products a block, forward, dX and dW) on the tile
    and the head Dense's three beside them; a forward's six a block on the
    tile and the head's one beside them."""
    depth = TRANSFORMER["depth"]
    tc = 6 * depth * (3 * steps + forwards)
    return tc + 3 * steps + forwards, tc


def only(**counts):
    """A launch-count dict with ``counts`` and every other kernel at 0."""
    return dict(dict.fromkeys(_wrappers(), 0), **counts)


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

    zero_counts()
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
    launches = launch_counts()

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
    if launches != only(fused_epoch=2, matmul=5):
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

    zero_counts()
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
    launches = launch_counts()

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
    if launches != only(matmul=expected):
        raise AssertionError("launch counts %s, expected matmul %d and no "
                             "other kernel" % (launches, expected))
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


def deep_data():
    """The deep MLP's 2,560 x 256 inputs, as the JAX package's benchmark
    makes them (numpy seed 0), with labels from a fixed random linear
    teacher (seed 1), so that the loss has something to learn."""
    x = np.random.RandomState(0).randn(DEEP_SAMPLES, 256).astype(np.float32)
    teacher = np.random.RandomState(1).randn(256, 10).astype(np.float32)
    return x, one_hot(np.argmax(x @ teacher, axis=1))


def deep_model(device, opt, seed, gain=1.0):
    """The deep MLP from ``seed`` (its stack's weights times ``gain``) in a
    Model on ``device`` with its optimizer state made."""
    with seeder.scope(seed):
        net = build_deep_mlp(**DEEP)
    net.layers[2].params["w"].data.mul_(gain)
    model = Model(net, SoftmaxCrossEntropyLoss(), opt, device=device)
    opt.load_state_dict(opt.init_state(net.params_tree()))
    return model


def adam_update(opt, w0, m, v):
    """The new weights of Adam's first step (t = 1) from its new moments:
    Adam's step from step_leaf's algebra, with weight decay."""
    scale, rsqrt_c2 = opt.scalars(opt.lr, 1)
    step = scale * m / (torch.sqrt(v) * rsqrt_c2 + opt._eps)
    if opt.weight_decay:
        step = step - opt.weight_decay * w0
    return w0 + step


def max_err(pairs):
    """The largest |a - b| over pairs of tensors, each pair held to
    STREAM_TOL."""
    worst = 0.0
    for what, a, b in pairs:
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        np.testing.assert_allclose(a, b, err_msg=what, **STREAM_TOL)
        worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def scaled_allowance(want, ulp_of=None):
    """SCALED_TOL's allowance for each element of ``want`` (numpy); plus,
    where ``ulp_of`` is given, one unit in the last place of it: a step read
    back as new w - w carries the rounding of the new w."""
    atol = SCALED_TOL["atol"] * float(np.max(np.abs(want), initial=0.0))
    allowed = atol + SCALED_TOL["rtol"] * np.abs(want)
    if ulp_of is not None:
        allowed = allowed + np.spacing(np.abs(ulp_of))
    return allowed


def hold_scaled(what, got, want, ulp_of=None):
    """Holds ``got`` to ``want`` at ``scaled_allowance``; returns the
    largest share of its allowance an element uses (1.0 at the limit)."""
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    if ulp_of is not None:
        ulp_of = ulp_of.detach().cpu().numpy()
    allowed = scaled_allowance(want, ulp_of)
    over = np.abs(got - want) > allowed
    if over.any():
        raise AssertionError("%s: %d of %d elements outside rtol %g and atol "
                             "%g of max|plain| (largest difference %.3g)"
                             % (what, int(over.sum()), over.size,
                                SCALED_TOL["rtol"], SCALED_TOL["atol"],
                                float(np.max(np.abs(got - want)))))
    used = np.abs(got - want) / np.where(allowed > 0, allowed, 1.0)
    return float(np.max(used, initial=0.0))


def stream_pair(device, make_opt, seed):
    """Two deep MLPs from ``seed`` (Xavier weights, ``make_opt()``) on the
    card, and their streaming steps: the first through the kernels, the
    second through the plain versions."""
    models = [deep_model(device, make_opt(), seed=seed) for _ in range(2)]
    steps = [se.build_streaming_step(models[0].net, models[0].loss,
                                     models[0].optimizer),
             se.build_streaming_step(models[1].net, models[1].loss,
                                     models[1].optimizer,
                                     forward=se.stream_forward_reference,
                                     backward=se.stream_backward_reference)]
    return models, steps


def stream_steps(device, make_opt, seed, x, y, n_steps=5):
    """``n_steps`` streaming steps of ``stream_pair``'s two models. Returns
    both runs' losses [2, n_steps] and their parameters and slots."""
    models, steps = stream_pair(device, make_opt, seed)
    losses = [[], []]
    for i in range(n_steps):
        xs = torch.from_numpy(x[i * BATCH:(i + 1) * BATCH]).to(device)
        ys = torch.from_numpy(y[i * BATCH:(i + 1) * BATCH]).to(device)
        for j in range(2):
            losses[j].append(float(steps[j](xs, ys)))
    state = [leaves_of(m.net.params_tree(), m.optimizer.state_dict()["slots"])
             for m in models]
    return np.array(losses), state


def hold_steps(what, losses, state):
    """Holds the kernels' run of ``stream_steps`` to the plain run: losses
    at LOSS_TOL, parameters and slots at STATE_TOL. Returns the largest
    |difference| over them."""
    np.testing.assert_allclose(losses[0], losses[1],
                               err_msg=what + ": losses", **LOSS_TOL)
    worst = float(np.max(np.abs(losses[0] - losses[1])))
    for i, (got, want) in enumerate(zip(*state)):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_allclose(got, want, err_msg="%s: state leaf %d"
                                   % (what, i), **STATE_TOL)
        worst = max(worst, float(np.max(np.abs(got - want))))
    return worst


def check_stream_kernels(device):
    """K3 and K3b against their plain versions on the card at the deep
    MLP's full width, batch 128; five whole streaming steps against the
    plain step; a rerun for determinism; then the times. Returns a dict
    per kernel: max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = deep_data()
    xb = torch.from_numpy(x[:BATCH]).to(device)
    yb = torch.from_numpy(y[:BATCH]).to(device)
    model = deep_model(device, Adam(1e-3), seed=1, gain=DEEP_GAIN)
    stack = model.net.layers[2]
    act = stack.activation
    w, b = stack.params["w"].data, stack.params["b"].data
    h0 = model.net.layers[1].forward(model.net.layers[0].forward(
        Tensor(xb))).data.contiguous()
    n_layers, width = w.shape[0], w.shape[-1]

    acts = se.cuda_stream_forward(h0, w, b, act)
    torch.cuda.synchronize()
    acts_ref = se.stream_forward_reference(h0, w, b, act)
    k3_err = max_err([("acts", acts, acts_ref)])
    if not torch.equal(acts, se.cuda_stream_forward(h0, w, b, act)):
        raise AssertionError("two K3 runs on the same inputs differ")
    print("K3, [%d,%d] x %d layers of [%d,%d] (%s): acts max abs err %.3g "
          "(tol rtol 1e-4 atol 1e-4); rerun bit-identical"
          % (BATCH, width, n_layers, width, width, act, k3_err))

    h_last = Tensor(acts_ref[-1], requires_grad=True)
    model.loss.loss(model.net.layers[3].forward(h_last), Tensor(yb)).backward()
    dlast = h_last.grad.contiguous()
    # the largest |kernel - plain| over every output, Adam's w included, and
    # the Adam weights whose step is outside SCALED_TOL of the plain step
    k3b_err, adam_w_over = 0.0, 0
    for opt in (Adam(1e-3), SGD(0.01)):
        outs = []
        for fn in (se.cuda_stream_backward, se.cuda_stream_backward,
                   se.stream_backward_reference):
            wk = w.clone()
            slots = {n: torch.zeros_like(w) for n in opt.slot_names}
            db, dh0 = fn(act, opt, h0, dlast, acts_ref, wk, slots,
                         opt.scalars(opt.lr, 1))
            torch.cuda.synchronize()
            outs.append([wk] + [slots[n] for n in opt.slot_names]
                        + [db, dh0])
        if not all(torch.equal(a, b) for a, b in zip(outs[0], outs[1])):
            raise AssertionError("two K3b runs from the same state differ")
        got, plain = outs[0], outs[2]
        err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
        k3b_err = max(k3b_err, err)
        # w by the step it took, which an error of the step would move; for
        # Adam the step that Adam's rule makes of the kernel's own m and v
        want_w = adam_update(opt, w, *got[1:3]) if isinstance(opt, Adam) \
            else plain[0]
        names = ["the step of w"] + list(opt.slot_names) + ["db", "dh0"]
        pairs = ([(names[0], got[0] - w, want_w - w, want_w)]
                 + [(n, a, b, None)
                    for n, a, b in zip(names[1:], got[1:], plain[1:])])
        used = {what: hold_scaled("K3b, %s: %s" % (type(opt).__name__, what),
                                  a, b, ulp_of)
                for what, a, b, ulp_of in pairs}
        print("K3b, %s: each output within SCALED_TOL (rtol 1e-4, atol 1e-4 "
              "of its max|plain|), share of the allowance used: %s; rerun "
              "bit-identical; the step moved w by up to %.3g"
              % (type(opt).__name__,
                 ", ".join("%s %.3g" % kv for kv in used.items()),
                 float((got[0] - w).abs().max())))
        if isinstance(opt, Adam):
            step_k = (got[0] - w).cpu().numpy()
            step_p = (plain[0] - w).cpu().numpy()
            outside = np.abs(step_k - step_p) > scaled_allowance(
                step_p, plain[0].cpu().numpy())
            adam_w_over = int(outside.sum())
            # Adam's first m is (1 - beta1) g
            g = np.abs(plain[1].cpu().numpy()) / (1.0 - opt._b1)
            print("  Adam: %d of %d weights took a step outside SCALED_TOL of "
                  "the plain version's step; their plain |g| is at most %.3g "
                  "and at least %.3g (Adam's step lr g / (|g| + eps), eps "
                  "%g, turns the rounding of a g near eps into a step "
                  "difference); their new w differs from the plain w by up "
                  "to %.3g" % (adam_w_over, w.numel(),
                               float(np.max(g[outside], initial=0.0)),
                               float(np.min(g[outside], initial=np.inf)),
                               opt._eps,
                               float((got[0] - plain[0]).abs().max())))
        print("  largest |kernel - plain| over w, slots, db, dh0: %.3g" % err)

    # five whole steps: the streaming step through the kernels against the
    # same step through the plain versions, on the card, from the main
    # path's Xavier weights, not at gain sqrt(2): there the 98-layer chain
    # amplifies a rounding-level change of the weights after one step into
    # a loss change far above LOSS_TOL
    losses, state = stream_steps(device, lambda: Adam(1e-3), STEPS_SEED, x, y)
    worst = hold_steps("Adam, seed %d" % STEPS_SEED, losses, state)
    print("5 streaming steps (Adam 1e-3, seed %d), kernels vs plain: losses "
          "%s; max abs err over losses, parameters and slots %.3g (tol "
          "losses rtol 1e-5 atol 1e-6, state rtol 1e-4 atol 1e-5)"
          % (STEPS_SEED, np.array2string(losses[0], precision=6), worst))
    losses, state = stream_steps(device, lambda: SGD(0.01), STEPS_SEED, x, y)
    worst = hold_steps("SGD, seed %d" % STEPS_SEED, losses, state)
    print("5 streaming steps (SGD 0.01, seed %d), kernels vs plain: losses "
          "%s; max abs err %.3g (the same tolerances)"
          % (STEPS_SEED, np.array2string(losses[0], precision=6), worst))

    # times at the main path's shape; K3b updates a scratch copy of the state
    opt = Adam(1e-3)
    wk = w.clone()
    slots = {n: torch.zeros_like(w) for n in opt.slot_names}
    scalars = opt.scalars(1e-3, 1)
    fns = {
        "streaming_forward": (
            lambda: se.cuda_stream_forward(h0, w, b, act),
            lambda: se.stream_forward_reference(h0, w, b, act)),
        "streaming_backward": (
            lambda: se.cuda_stream_backward(act, opt, h0, dlast, acts_ref,
                                            wk, slots, scalars),
            lambda: se.stream_backward_reference(act, opt, h0, dlast,
                                                 acts_ref, wk, slots,
                                                 scalars)),
    }
    costs = dict(zip(fns, stream_costs(n_layers, BATCH, width,
                                       len(opt.slot_names))))
    out = {}
    for name, (kernel, plain) in fns.items():
        kernel()
        plain()
        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (epoch_ms(plain, 3), epoch_ms(kernel, 50),
                          epoch_ms(kernel, 50), epoch_ms(plain, 3))
        dev_ms = device_us(kernel, reps=20) / 1e3
        bound_ms, bound_by = bound(*costs[name])
        out[name] = dict(max_abs_err=k3_err if name == "streaming_forward"
                         else k3b_err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                         bound_ms=bound_ms, bound_by=bound_by)
        print("%s (Adam for K3b): %.4f ms a launch by CUDA events (turns "
              "%.4f, %.4f), %.4f ms device time (queued); plain %.3f ms "
              "(turns %.3f, %.3f); bound %.4f ms (%s-bound: %.4g GFLOP, "
              "%.4g MB); kernel at %.2f%% of it"
              % (name, out[name]["ms"], k1, k2, dev_ms, out[name]["plain_ms"],
                 p1, p2, bound_ms, bound_by, costs[name][0] / 1e9,
                 costs[name][1] / 1e6, 100.0 * bound_ms / out[name]["ms"]))
    sgd_bound = bound(*stream_costs(n_layers, BATCH, width, 0)[1])
    print("K3b bound with SGD: %.4f ms (%s-bound)" % sgd_bound)
    out["streaming_backward"]["adam_w_over_tol"] = adam_w_over
    return out


def run_deep_slice(device, opt, fused="auto", n_epochs=3):
    """The deep MLP's main path: ``Model(build_deep_mlp(stacked=True), ...,
    device="cuda").train_epochs(..., fused=...)`` from seed 0 over the
    2,560-sample data, an epoch and then ``n_epochs - 1`` timed ones.
    Returns the model, the losses [n_epochs, 20], the launch counts and the
    timed epochs' steps/s (the first epoch's where it is the only one)."""
    x, y = deep_data()
    seeder.random_seed(0)
    model = Model(build_deep_mlp(**DEEP), SoftmaxCrossEntropyLoss(), opt,
                  device=device)
    x_dev, y_dev = model.stage(x, y)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    first = model.train_epoch(x_dev, y_dev, batch_size=BATCH, fused=fused)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rest = first[None][:0]
    if n_epochs > 1:
        t0 = time.perf_counter()
        rest = model.train_epochs(x_dev, y_dev, n_epochs=n_epochs - 1,
                                  batch_size=BATCH, fused=fused)
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t0
    counts = launch_counts()
    losses = torch.cat([first[None], rest]).cpu().numpy()
    n_steps = losses.shape[1]
    rate = (n_steps * (n_epochs - 1) / timed_s if n_epochs > 1
            else n_steps / first_s)
    print("%s, fused=%r: %d epochs of %d steps; epoch 1 %.4f s (the "
          "kernels' first loads included); %s %.1f steps/s = %.1f us/step; "
          "epoch-mean losses %s; launches %s"
          % (type(opt).__name__, fused, n_epochs, n_steps, first_s,
             "then" if n_epochs > 1 else "that is", rate, 1e6 / rate,
             np.array2string(losses.mean(axis=1), precision=6), counts))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    if n_epochs > 1 and not losses[-1].mean() < losses[0].mean():
        raise AssertionError("the loss did not fall: epoch means %s"
                             % losses.mean(axis=1))
    return model, x_dev, y_dev, losses, counts, rate


def check_deep_slice(device):
    """The stream tier's slice (Adam, then SGD) and the step loop from the
    same weights. Returns the summed launch counts and the stream
    model (Adam) with its staged data."""
    n_steps = DEEP_SAMPLES // BATCH
    total = dict.fromkeys(launch_counts(), 0)
    rates = {}
    for opt in (Adam(1e-3), SGD(0.01)):
        model, x_dev, y_dev, losses, counts, rate = run_deep_slice(device,
                                                                   opt)
        steps = 3 * n_steps
        expected = only(matmul=5 * steps, streaming_forward=steps,
                        streaming_backward=steps)
        if counts != expected:
            raise AssertionError("launch counts %s, expected %s (K3 and K3b "
                                 "once a step, K1 5 a step: prefix and suffix "
                                 "forward, suffix dW and dx, prefix dW)"
                                 % (counts, expected))
        rates[type(opt).__name__] = rate
        for k in total:
            total[k] += counts[k]
        if isinstance(opt, Adam):
            stream = (model, x_dev, y_dev, losses[0])
    _, _, _, loop_losses, counts, loop_rate = run_deep_slice(
        device, Adam(1e-3), fused=False, n_epochs=1)
    n_body = DEEP["depth"] - 2
    expected = only(matmul=(5 + 3 * n_body) * n_steps)
    if counts != expected:
        raise AssertionError("step-loop launch counts %s, expected %s (K1 5 + "
                             "3 x %d a step)" % (counts, expected, n_body))
    for k in total:
        total[k] += counts[k]
    gap = np.abs(loop_losses[0] - stream[3])
    print("same call: the stream tier (Adam) %.1f steps/s, SGD %.1f, the "
          "step loop (dense_stack_ on K1, %d launches a step) %.1f (its "
          "first epoch); stream/loop %.2f. The two tiers' losses from the "
          "same weights and batches differ by at most %.3g over the epoch"
          % (rates["Adam"], rates["SGD"], 5 + 3 * n_body, loop_rate,
             rates["Adam"] / loop_rate, gap.max()))
    return total, stream


def run_stream_trace(model, x_dev, y_dev):
    """Device busy share of one stream epoch, the K3 and K3b device time a
    step, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = model.train_epoch(x_dev, y_dev, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_steps = int(losses.shape[0])
    rows = sorted(device_kernels(prof), reverse=True)
    busy_us = sum(r[0] for r in rows)
    print("trace, stream epoch: %d steps, wall %.1f us/step under the "
          "profiler, %d kernel launches/step" % (
              n_steps, wall_us / n_steps, sum(r[1] for r in rows) // n_steps))
    if busy_us == 0:
        print("trace, stream epoch: device time not measured (the profiler "
              "saw no device kernels)")
        return
    k3 = sum(r[0] for r in rows if "stream_forward_kernel" in r[2])
    k3b = sum(r[0] for r in rows if "stream_backward" in r[2])
    print("trace, stream epoch: device busy %.1f us/step = %.1f%% of wall "
          "(idle %.1f%%); K3 %.1f us/step, K3b %.1f us/step (its two "
          "kernels), the rest %.1f us/step"
          % (busy_us / n_steps, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us, k3 / n_steps, k3b / n_steps,
             (busy_us - k3 - k3b) / n_steps))
    for dev_us, count, key in rows[:8]:
        print("  %8.2f us/step  %3d launches/step  %s"
              % (dev_us / n_steps, count // n_steps, key[:80]))


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


def head_dims(d):
    """(d_qk, d_v) of an ATTN_SHAPES head dim: one int, or the pair."""
    return tuple(d) if isinstance(d, tuple) else (d, d)


def attn_inputs(device, name, seed=0):
    """q, k, v, dO of ``name``'s shape on ``device``, each the strided view
    that split heads makes of a [B, T, heads, d] tensor (v and dO at d_v),
    and the call's keyword arguments."""
    b, h, hkv, tq, tk, d, causal, window, rate = ATTN_SHAPES[name]
    dqk, dv = head_dims(d)
    gen = torch.Generator().manual_seed(seed)

    def heads(n, t, width):
        x = torch.randn((b, t, n, width), generator=gen).to(device)
        return x.permute(0, 2, 1, 3)

    q, k = heads(h, tq, dqk), heads(hkv, tk, dqk)
    v, do = heads(hkv, tk, dv), heads(h, tq, dv)
    kw = dict(causal=causal, scale=1.0 / np.sqrt(dqk), window=window,
              dropout_rate=rate, seed=ATTN_SEED if rate else None)
    return q, k, v, do, kw


def visible_pairs(tq, tk, causal, window):
    """The (query, key) pairs of one head that the masks leave visible."""
    if not causal:
        return tq * tk
    return int(np.minimum(np.arange(tq) + 1, window or tq).sum())


def attention_costs(name):
    """FLOPs and bytes of the forward, the dq kernel, the dk/dv kernel and
    the backward as a whole at ``name``'s shape, on the visible pairs only,
    with S, dQ and dK over d_qk and P.V, dP and dV over d_v (d each where
    they share one). The forward: S and P.V, 4 d FLOPs a pair; q, k, v
    read, o and lse written. dq alone needs S, dP and dS.K (6 d a pair),
    dk/dv alone S, dP, P^T.dO and dS^T.Q (8 d); the backward as a whole
    shares S and dP (10 d a pair). Each reads q, k, v, dO, lse and delta
    and writes its outputs."""
    b, h, hkv, tq, tk, d, causal, window, _ = ATTN_SHAPES[name]
    dqk, dv = head_dims(d)
    vis = b * h * visible_pairs(tq, tk, causal, window)
    q, o = b * h * tq * dqk, b * h * tq * dv
    k, v, rows = b * hkv * tk * dqk, b * hkv * tk * dv, b * h * tq
    reads = q + k + v + o + 2 * rows  # q, k, v, dO, lse and delta
    return {"attention_forward": (2.0 * vis * (dqk + dv),
                                  4.0 * (q + k + v + o + rows)),
            "attention_backward_dq": (2.0 * vis * (2 * dqk + dv),
                                      4.0 * (reads + q)),
            "attention_backward_dkv": (4.0 * vis * (dqk + dv),
                                       4.0 * (reads + k + v)),
            "backward": (2.0 * vis * (3 * dqk + 2 * dv),
                         4.0 * (reads + q + k + v))}


def hold_grad(what, got, want):
    """``got`` within rtol GRAD_RTOL and an atol of GRAD_ATOL of max|want|;
    returns max|got - want|."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * float(np.abs(want).max()),
                               err_msg=what)
    return float(np.max(np.abs(got - want)))


def plain_groups(q, k, rate):
    """None where the plain versions take the shape whole; past
    PLAIN_SCORES score elements the index pairs (batch row and query heads,
    batch row and kv head) of each (batch row, kv head) group."""
    b, h, tq, _ = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if b * h * tq * tk <= PLAIN_SCORES:
        return None
    if rate:
        raise ValueError("the plain keep mask needs every head at once")
    group = h // hkv
    return [((slice(i, i + 1), slice(j * group, (j + 1) * group)),
             (slice(i, i + 1), slice(j, j + 1)))
            for i in range(b) for j in range(hkv)]


def plain_forward(q, k, v, **kw):
    """``attention_forward_reference``, a group at a time past
    PLAIN_SCORES."""
    groups = plain_groups(q, k, kw["dropout_rate"])
    if groups is None:
        return attention.attention_forward_reference(q, k, v, **kw)
    o = q.new_empty(q.shape[:3] + v.shape[3:])
    lse = q.new_empty(q.shape[:3] + (1,))
    for qi, ki in groups:
        o[qi], lse[qi] = attention.attention_forward_reference(
            q[qi], k[ki], v[ki], **kw)
    return o, lse


def plain_backward(q, k, v, do, lse, delta, **kw):
    """``attention_backward_reference``, a group at a time past
    PLAIN_SCORES."""
    groups = plain_groups(q, k, kw["dropout_rate"])
    if groups is None:
        return attention.attention_backward_reference(q, k, v, do, lse,
                                                      delta, **kw)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for qi, ki in groups:
        dq[qi], dk[ki], dv[ki] = attention.attention_backward_reference(
            q[qi], k[ki], v[ki], do[qi], lse[qi], delta[qi], **kw)
    return dq, dk, dv


def check_attention_shape(device, name):
    """The three attention kernels against the plain versions at one shape;
    each rerun must be bit-identical. Returns each kernel's max abs err."""
    q, k, v, do, kw = attn_inputs(device, name)
    o, lse = attention.cuda_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    o_r, lse_r = plain_forward(q, k, v, **kw)
    for what, a, b in (("o", o, o_r), ("lse", lse, lse_r)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   err_msg="%s: %s" % (name, what),
                                   **ATTN_TOL)
    errs = {"attention_forward": float(max((o - o_r).abs().max(),
                                           (lse - lse_r).abs().max()))}
    if not all(torch.equal(a, b) for a, b in zip(
            (o, lse), attention.cuda_attention_forward(q, k, v, **kw))):
        raise AssertionError("%s: two forward runs differ" % name)
    # the backward from the plain forward's o and lse
    delta = (do * o_r).sum(dim=-1)
    runs = []
    wrappers = (attention.cuda_attention_backward_dq,
                attention.cuda_attention_backward_dkv)
    wgmma = [fn.wgmma_launches for fn in wrappers]
    split = [fn.split_launches for fn in wrappers]
    for _ in range(2):
        dq = attention.cuda_attention_backward_dq(q, k, v, do, lse_r, delta,
                                                  **kw)
        dk, dv = attention.cuda_attention_backward_dkv(q, k, v, do, lse_r,
                                                       delta, **kw)
        torch.cuda.synchronize()
        runs.append((dq, dk, dv))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("%s: two backward runs differ" % name)
    # head dims 65-128 take the wgmma dq and dk/dv kernels; split dims dq's
    # <192, 128> template and dk/dv's split wgmma kernel, counted apart
    dqk, dv = q.shape[-1], v.shape[-1]
    designs = (attention.dq_design, attention.dkv_design)
    for what, fn, design, before, split_before in zip(
            ("dq", "dk/dv"), wrappers, designs, wgmma, split):
        on_wgmma = design(dqk, dv) == "wgmma"
        if fn.wgmma_launches - before != (2 if on_wgmma else 0):
            raise AssertionError("%s: %d of the 2 %s launches counted on "
                                 "the wgmma kernel at head dims %d/%d"
                                 % (name, fn.wgmma_launches - before, what,
                                    dqk, dv))
        if fn.split_launches - split_before != (2 if dqk != dv else 0):
            raise AssertionError("%s: %d of the 2 %s launches counted at "
                                 "split head dims %d/%d"
                                 % (name, fn.split_launches - split_before,
                                    what, dqk, dv))
    want = plain_backward(q, k, v, do, lse_r, delta, **kw)
    grads = [hold_grad("%s: %s" % (name, what), a, b)
             for what, a, b in zip(("dq", "dk", "dv"), runs[0], want)]
    errs["attention_backward_dq"] = grads[0]
    errs["attention_backward_dkv"] = max(grads[1:])
    print("  %-16s %s: max abs err o/lse %.3g, dq %.3g, dk %.3g, dv %.3g "
          "(max|plain| dq %.3g, dk %.3g, dv %.3g); reruns bit-identical"
          % (name, ATTN_SHAPES[name], errs["attention_forward"], *grads,
             *(float(w.abs().max()) for w in want)))
    return errs


def attention_f64_hold(device, name):
    """The three attention kernels against a float64 plain version at
    ``name``'s shape: each of o, lse, dq, dk and dv within F64_FACTOR times
    the f32 plain version's max error (TF32 off), and the plain version with
    TF32 allowed past that limit. The backward from the f32 plain forward's
    lse and delta.
    Returns {output: (kernel's, f32's, TF32's max error)}."""
    q, k, v, do, kw = attn_inputs(device, name)
    o, lse = attention.attention_forward_reference(q, k, v, **kw)
    delta = (do * o).sum(dim=-1)
    bwd = (q, k, v, do, lse, delta)

    def kernels_run(args):
        return (attention.cuda_attention_forward(*args[:3], **kw)
                + (attention.cuda_attention_backward_dq(*args, **kw),)
                + attention.cuda_attention_backward_dkv(*args, **kw))

    def plain_run(args):
        return (attention.attention_forward_reference(*args[:3], **kw)
                + attention.attention_backward_reference(*args, **kw))

    got = kernels_run(bwd)
    f32 = plain_run(bwd)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain_run(bwd)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    exact = plain_run([x.double() for x in bwd])
    errs = {}
    for i, what in enumerate(("o", "lse", "dq", "dk", "dv")):
        e = [float((x[i].double() - exact[i]).abs().max())
             for x in (got, f32, tf32)]
        errs[what] = e
        limit = F64_FACTOR * e[1]
        print("  %-16s %-3s against float64: kernel %.3g, f32 plain %.3g, "
              "TF32 plain %.3g; limit %.3g (%gx f32's); kernel/f32 %.2f, "
              "TF32/f32 %.1f" % (name, what, e[0], e[1], e[2], limit,
                                 F64_FACTOR, e[0] / e[1], e[2] / e[1]))
        if e[0] > limit:
            raise AssertionError("%s: %s's float64 error %.3g exceeds %gx "
                                 "the f32 plain version's %.3g"
                                 % (name, what, e[0], F64_FACTOR, e[1]))
        if e[2] <= limit:
            raise AssertionError("%s: %s: TF32's float64 error %.3g is "
                                 "within the limit %.3g: the hold cannot "
                                 "tell 3xTF32 from TF32"
                                 % (name, what, e[2], limit))
    del exact, f32, tf32
    torch.cuda.empty_cache()
    return errs


def sdpa_times(q, k, v, do, kw):
    """PyTorch's scaled_dot_product_attention at the same shape, as a
    yardstick only: (forward ms, backward ms from autograd.grad, the device
    kernels that ran, max|SDPA - plain| of o)."""
    import torch.nn.functional as F

    args = dict(is_causal=kw["causal"], scale=kw["scale"])
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **args)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, **args)
        torch.autograd.grad(out, leaves, do)

    ref, _ = attention.attention_forward_reference(q, k, v, **kw)
    err = float((fwd() - ref).abs().max())
    fwd_bwd()
    f1, b1, b2, f2 = (epoch_ms(fwd, 10), epoch_ms(fwd_bwd, 5),
                      epoch_ms(fwd_bwd, 5), epoch_ms(fwd, 10))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    names = [row[2][:70] for row in sorted(device_kernels(prof),
                                           reverse=True)[:3]]
    fwd_ms = (f1 + f2) / 2
    return fwd_ms, (b1 + b2) / 2 - fwd_ms, names, err


def clock_under(fn, n):
    """The SM clock and power draw (nvidia-smi) while ``n`` back-to-back
    calls of ``fn`` run: the calls are queued, the card is read while it
    works through them, then the queue is drained."""
    for _ in range(n):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    torch.cuda.synchronize()
    return out.stdout.strip().splitlines()[0]


def check_attention(device):
    """The attention kernels against the plain versions at every shape of
    ATTN_SHAPES, then the times at config 6b's and ATTN_TIMED's: each
    kernel, the plain versions, SDPA, the bounds. Returns config 6b's dict
    per kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = dict.fromkeys(("attention_forward", "attention_backward_dq",
                           "attention_backward_dkv"), 0.0)
    print("  shape (B, H, Hkv, Tq, Tk, d, causal, window, dropout); tol o/lse "
          "rtol 1e-4 atol 1e-5, dq/dk/dv rtol 1e-4 atol 1e-4 x max|plain|")
    for name in ATTN_SHAPES:
        for kname, err in check_attention_shape(device, name).items():
            worst[kname] = max(worst[kname], err)
        torch.cuda.empty_cache()
    print("  the three kernels against float64 (3xTF32 on the tensor cores; "
          "limit %gx the f32 plain version's error, which TF32 must miss)"
          % F64_FACTOR)
    for name in ATTN_F64:
        attention_f64_hold(device, name)

    out = time_attention(device, ATTN_MAIN, detail=True)
    for name in out:
        out[name]["max_abs_err"] = worst[name]
    for name in ATTN_TIMED:
        time_attention(device, name)
    for name in ATTN_BWD_TIMED:
        for kernel in ("dq", "dkv"):
            time_backward(device, name, kernel)
    for name in ATTN_SPLIT_TIMED:
        time_forward(device, name)
        for kernel in ("dq", "dkv"):
            time_backward(device, name, kernel)
    return out


def time_forward(device, name):
    """The forward kernel's time a launch at shape ``name`` (CUDA events),
    beside its bound: 2 (d_qk + d_v) FLOPs a visible pair at 3xTF32 on the
    tensor cores."""
    q, k, v, _, kw = attn_inputs(device, name)

    def run():
        return attention.cuda_attention_forward(q, k, v, **kw)

    run()
    k1, k2 = epoch_ms(run, 5), epoch_ms(run, 5)
    ms = (k1 + k2) / 2
    costs = attention_costs(name)["attention_forward"]
    bound_ms, bound_by = bound_3xtf32(*costs)
    print("attention_forward at %s: %.3f ms a launch by CUDA events (turns "
          "%.3f, %.3f); bound %.3f ms (%s-bound: %.4g GFLOP on the visible "
          "pairs); kernel at %.2f%% of it"
          % (name, ms, k1, k2, bound_ms, bound_by, costs[0] / 1e9,
             100.0 * bound_ms / ms))
    torch.cuda.empty_cache()
    return ms, bound_ms


def time_backward(device, name, kernel):
    """The dq or dk/dv kernel's (``kernel``) time a launch at shape
    ``name`` (CUDA events), beside its bound: 6 d FLOPs a visible pair (S,
    dP, dQ) or 8 d (S^T, dP^T, dV, dK) at 3xTF32 on the tensor cores. lse
    and delta come from the kernels' forward (the plain one holds the
    scores whole)."""
    q, k, v, do, kw = attn_inputs(device, name)
    o, lse = attention.cuda_attention_forward(q, k, v, **kw)
    delta = (do * o).sum(dim=-1)
    wrapper, design = {
        "dq": (attention.cuda_attention_backward_dq, attention.dq_design),
        "dkv": (attention.cuda_attention_backward_dkv,
                attention.dkv_design)}[kernel]

    def run():
        return wrapper(q, k, v, do, lse, delta, **kw)

    run()
    k1, k2 = epoch_ms(run, 5), epoch_ms(run, 5)
    ms = (k1 + k2) / 2
    what = "attention_backward_" + kernel
    costs = attention_costs(name)[what]
    bound_ms, bound_by = bound_3xtf32(*costs)
    print("%s at %s (the %s kernel): %.3f ms a launch by CUDA events (turns "
          "%.3f, %.3f); bound %.3f ms (%s-bound: %.4g GFLOP on the visible "
          "pairs); kernel at %.2f%% of it"
          % (what, name, design(q.shape[-1], v.shape[-1]), ms, k1, k2,
             bound_ms, bound_by,
             costs[0] / 1e9, 100.0 * bound_ms / ms))
    del o, lse, delta
    torch.cuda.empty_cache()
    return ms, bound_ms


def time_attention(device, name, detail=False):
    """Each attention kernel's time a launch at shape ``name`` (CUDA
    events, in turns with the plain version), its bound and SDPA's time;
    with ``detail`` also the device time behind a spin and the card's clock
    under 300 back-to-back launches. Each kernel's bound (its ``bound_ms``)
    is at 3xTF32 on the tensor cores, the work it does; the f32 FMA bound is
    printed beside it. Returns a dict per kernel."""
    q, k, v, do, kw = attn_inputs(device, name)
    o, lse = attention.attention_forward_reference(q, k, v, **kw)
    delta = (do * o).sum(dim=-1)
    bwd = (q, k, v, do, lse, delta)
    fns = {
        "attention_forward": (
            lambda: attention.cuda_attention_forward(q, k, v, **kw),
            lambda: attention.attention_forward_reference(q, k, v, **kw)),
        "attention_backward_dq": (
            lambda: attention.cuda_attention_backward_dq(*bwd, **kw),
            lambda: attention.attention_backward_reference(*bwd, **kw)),
        "attention_backward_dkv": (
            lambda: attention.cuda_attention_backward_dkv(*bwd, **kw),
            lambda: attention.attention_backward_reference(*bwd, **kw)),
    }
    costs = attention_costs(name)
    sdpa_fwd, sdpa_bwd, sdpa_kernels, sdpa_err = sdpa_times(q, k, v, do, kw)
    out = {}
    for kname, (kernel, plain) in fns.items():
        kernel()
        plain()
        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (epoch_ms(plain, 2), epoch_ms(kernel, 10),
                          epoch_ms(kernel, 10), epoch_ms(plain, 2))
        ms = (k1 + k2) / 2
        fma_ms, fma_by = bound(*costs[kname])
        fma = " (at f32 FMA %.4f ms, %s-bound; the kernel at %.2f%% of it)" \
            % (fma_ms, fma_by, 100.0 * fma_ms / ms)
        bound_ms, bound_by = bound_3xtf32(*costs[kname])
        out[kname] = dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                          bound_by=bound_by,
                          library_ms=(sdpa_fwd if kname == "attention_forward"
                                      else sdpa_bwd))
        extra = fma
        if detail:
            extra += ("; %.4f ms device time (queued); under 300 "
                      "back-to-back launches the card read (SM clock, max "
                      "SM clock, power) %s" % (device_us(kernel, reps=5) / 1e3,
                                               clock_under(kernel, 300)))
        print("%s at %s: %.4f ms a launch by CUDA events (turns %.4f, "
              "%.4f); plain %.3f ms (turns %.3f, %.3f); bound %.4f ms "
              "(%s-bound: %.4g GFLOP, %.4g MB); kernel at %.2f%% of it%s"
              % (kname, name, ms, k1, k2, out[kname]["plain_ms"], p1, p2,
                 bound_ms, bound_by, costs[kname][0] / 1e9,
                 costs[kname][1] / 1e6, 100.0 * bound_ms / ms, extra))
    pair = out["attention_backward_dq"]["ms"] + \
        out["attention_backward_dkv"]["ms"]
    pair_bound = bound_3xtf32(*costs["backward"])
    pair_fma = bound(*costs["backward"])

    def reduction():
        return (do.float() * o.float()).sum(dim=-1)

    delta_ms = (epoch_ms(reduction, 20) + epoch_ms(reduction, 20)) / 2
    print("backward pair at %s: %.4f ms; the VJP's bound at 3xTF32 %.4f ms "
          "(%s-bound, %.4g GFLOP: S and dP once, three TF32 products each), "
          "the pair at %.2f%% of it; at f32 FMA %.4f ms, the pair at %.2f%% "
          "(the kernels recompute S and dP in each)"
          % (name, pair, pair_bound[0], pair_bound[1],
             costs["backward"][0] / 1e9, 100.0 * pair_bound[0] / pair,
             pair_fma[0], 100.0 * pair_fma[0] / pair))
    print("the pair plus the delta reduction (mha_bwd's rowsum(dO * O), "
          "%.4f ms) at %s: %.4f ms, beside SDPA's whole backward %.4f ms: "
          "%.3fx its time" % (delta_ms, name, pair + delta_ms, sdpa_bwd,
                              (pair + delta_ms) / sdpa_bwd))
    print("SDPA (f32) at %s: forward %.4f ms, backward %.4f ms "
          "(autograd.grad, all of dq, dk, dv); max|SDPA - plain| of o %.3g; "
          "its device kernels: %s" % (name, sdpa_fwd, sdpa_bwd, sdpa_err,
                                      " | ".join(sdpa_kernels)))
    return out


def transformer_data():
    """Config 6b's data as bench_all.py makes it: 256 sequences of 2048
    random tokens and random labels of 16 classes from numpy seed 0; and 32
    held-out sequences from seed 1."""
    rng = np.random.RandomState(0)
    tx = rng.randint(0, TRANSFORMER["vocab"], (T_SAMPLES,
                                               TRANSFORMER["seq_len"]))
    ty = one_hot(rng.randint(0, TRANSFORMER["num_out"], T_SAMPLES),
                 TRANSFORMER["num_out"])
    held = np.random.RandomState(1)
    ex = held.randint(0, TRANSFORMER["vocab"], (T_EVAL,
                                                TRANSFORMER["seq_len"]))
    return tx, ty, ex, held.randint(0, TRANSFORMER["num_out"], T_EVAL)


def transformer_model(device, seed, attn="fused"):
    """Config 6b from ``seed``, its blocks' attention core set to ``attn``,
    in a Model on ``device``."""
    with seeder.scope(seed):
        net = build_tiny_transformer(**TRANSFORMER)
    for layer in net.layers:
        if hasattr(layer, "attn"):
            layer.attn = attn
    return Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3), device=device)


def run_transformer_slice(device):
    """Config 6b's main path: ``Model(build_tiny_transformer(**6b), ...,
    device="cuda").train_epochs(fused="auto")`` from seed 0, an epoch, two
    timed epochs, an evaluate_batch on 32 held-out sequences. Returns the
    model, its staged data, the launch counts and the steps/s."""
    tx, ty, ex, ey = transformer_data()
    model = transformer_model(device, 0)
    x_dev, y_dev = model.stage(tx, ty)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    first = model.train_epoch(x_dev, y_dev, batch_size=T_BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = model.train_epochs(x_dev, y_dev, n_epochs=2, batch_size=T_BATCH)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    train_counts = launch_counts()
    train_tc = kernels.cuda_matmul.tc_launches
    res = model.evaluate_batch(ex, ey, AccEvaluator)
    logits = model.predict(ex)
    counts = launch_counts()
    losses = torch.cat([first[None], rest]).cpu().numpy()
    n_steps = losses.shape[1]
    steps = 3 * n_steps
    rate = 2 * n_steps / timed_s
    depth = TRANSFORMER["depth"]
    print("6b, fused='auto': 3 epochs of %d steps (batch %d, seq %d); epoch "
          "1 %.3f s; epochs 2-3 %.3f s = %.2f steps/s = %.2f ms/step; "
          "epoch-mean losses %s" % (n_steps, T_BATCH, TRANSFORMER["seq_len"],
                                    first_s, timed_s, rate, 1e3 / rate,
                                    np.array2string(losses.mean(axis=1),
                                                    precision=5)))
    print("launches over the %d train steps: %s; K1 %.1f a step (each "
          "block's six Dense products forward, dX and dW, and the head "
          "Dense's three), %.1f a step on the tensor-core tile"
          % (steps, train_counts, train_counts["matmul"] / steps,
             train_tc / steps))
    print("evaluate_batch on %d held-out sequences: accuracy %.4f (random "
          "labels: chance 1/16); two forwards, launches then %s, K1 on the "
          "tensor-core tile %d" % (T_EVAL, res["accuracy"], counts,
                                   kernels.cuda_matmul.tc_launches))
    # per step each of the `depth` blocks runs one forward and one backward
    # of each attention kernel; the two eval forwards one forward a block
    k1, tc = transformer_k1(steps, forwards=2)
    want = only(attention_forward=depth * (steps + 2),
                attention_backward_dq=depth * steps,
                attention_backward_dkv=depth * steps, matmul=k1)
    if counts != want or kernels.cuda_matmul.tc_launches != tc:
        raise AssertionError("launch counts %s and %d on the tensor-core "
                             "tile, expected %s and %d" % (
                                 counts, kernels.cuda_matmul.tc_launches,
                                 want, tc))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    if tuple(logits.shape) != (T_EVAL, TRANSFORMER["num_out"]) or \
            not torch.isfinite(logits.data).all():
        raise AssertionError("bad eval logits")
    return model, x_dev, y_dev, counts, rate


def check_fused_vs_tape(device):
    """From the same seed-1 weights, T_PARITY_STEPS Adam steps with
    attn="fused" (the kernels) and with attn="tape" (batched products, an
    additive -1e9 mask and softmax_ on [B, H, T, T] scores: the cross-check
    path); then one timed attn="tape" epoch. Returns its steps/s."""
    tx, ty, _, _ = transformer_data()
    models = [transformer_model(device, 1, attn) for attn in ("fused",
                                                               "tape")]
    losses = np.array([[float(m.train_step(tx[i * T_BATCH:(i + 1) * T_BATCH],
                                           ty[i * T_BATCH:(i + 1) * T_BATCH]))
                        for i in range(T_PARITY_STEPS)] for m in models])
    rel = np.abs(losses[0] - losses[1]) / np.abs(losses[1])
    print("%d steps from the same weights, fused %s, tape %s: largest "
          "relative difference %.3g (tol rtol %g: f32 sums in other orders, "
          "and -1e9 against -1e30 masking, which both give p = 0)"
          % (T_PARITY_STEPS, np.array2string(losses[0], precision=6),
             np.array2string(losses[1], precision=6), rel.max(), PARITY_RTOL))
    np.testing.assert_allclose(losses[0], losses[1], rtol=PARITY_RTOL,
                               err_msg="fused vs tape losses")
    tape = models[1]
    x_dev, y_dev = tape.stage(tx, ty)
    del models
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    trace = tape.train_epoch(x_dev, y_dev, batch_size=T_BATCH)
    torch.cuda.synchronize()
    tape_s = time.perf_counter() - t0
    counts = launch_counts()
    n_steps = int(trace.shape[0])
    print("attn='tape' epoch: %d steps in %.3f s = %.2f steps/s; peak device "
          "memory %.2f GB; launches %s, K1 on the tensor-core tile %d" % (
              n_steps, tape_s, n_steps / tape_s,
              torch.cuda.max_memory_allocated() / 1e9, counts,
              kernels.cuda_matmul.tc_launches))
    k1, tc = transformer_k1(n_steps)
    if counts != only(matmul=k1) or kernels.cuda_matmul.tc_launches != tc:
        raise AssertionError("the tape epoch launched %s, %d on the "
                             "tensor-core tile; expected K1 %d, %d on the "
                             "tile" % (counts,
                                       kernels.cuda_matmul.tc_launches,
                                       k1, tc))
    if not torch.isfinite(trace).all():
        raise AssertionError("non-finite tape loss")
    return n_steps / tape_s


def run_transformer_trace(model, x_dev, y_dev, steps=10):
    """Device busy share and the attention kernels' device time a step over
    ``steps`` 6b train steps."""
    from torch.profiler import ProfilerActivity, profile

    xs = x_dev[:steps * T_BATCH].reshape(steps, T_BATCH, -1)
    ys = y_dev[:steps * T_BATCH].reshape(steps, T_BATCH, -1)
    model.train_step(xs[0], ys[0])
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
    print("trace, 6b: %d steps, wall %.1f us/step under the profiler, %d "
          "kernel launches/step" % (steps, wall_us / steps,
                                    sum(r[1] for r in rows) // steps))
    if busy_us == 0:
        print("trace, 6b: device time not measured (the profiler saw no "
              "device kernels)")
        return
    attn = {kind: sum(r[0] for r in rows if "attention_%s_kernel" % kind
                      in r[2]) / steps
            for kind in ("forward", "backward_dq", "backward_dkv")}
    print("trace, 6b: device busy %.1f us/step = %.1f%% of wall (idle "
          "%.1f%%); attention forward %.1f, dq %.1f, dk/dv %.1f us/step "
          "(%.1f%% of the device time), the rest %.1f us/step"
          % (busy_us / steps, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us, attn["forward"],
             attn["backward_dq"], attn["backward_dkv"],
             100.0 * sum(attn.values()) * steps / busy_us,
             busy_us / steps - sum(attn.values())))
    for dev_us, count, key in rows[:10]:
        print("  %9.2f us/step  %3d launches/step  %s"
              % (dev_us / steps, count // steps, key[:80]))


def rnn_inputs(device, cell, name, seed=0):
    """The forward's inputs of RNN_SHAPES[name] (the projected inputs, wh
    scaled by 1/sqrt(H) so that the gates stay out of saturation, and the
    initial states: zero at config 8, as the slice has them, random on the
    ragged shape) and an output cotangent, from numpy ``seed``."""
    b, t, h = RNN_SHAPES[name]
    g = rk.GATES[cell]
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device)

    xp = arr(t, b, g * h, scale=0.5)
    wh = arr(h, g * h, scale=1.0 / np.sqrt(h))
    states = name != "config8"
    h0 = arr(b, h, scale=0.5) if states else torch.zeros((b, h),
                                                         device=device)
    c0 = arr(b, h, scale=0.5) if states else torch.zeros((b, h),
                                                         device=device)
    return xp, wh, h0, c0, arr(t, b, h)


def rnn_fns(cell, xp, wh, h0, c0, gt, reverse):
    """{kernel name: (kernel call, plain call)} of the forward and the
    backward of ``cell`` on these inputs (the kernel call takes the wrapper's
    ``phase_ns``); the backwards take the plain forward's outputs."""
    if cell == "lstm":
        fwd = (lambda **kw: rk.cuda_lstm_forward(xp, wh, h0, c0,
                                                 reverse=reverse, **kw),
               lambda: rk.lstm_forward_reference(xp, wh, h0, c0,
                                                 reverse=reverse))
        hs, cs, gates = fwd[1]()
        cprev = (torch.cat([cs[1:], c0[None]]) if reverse
                 else torch.cat([c0[None], cs[:-1]]))
        args = (gt, gates, cs, cprev, wh.T)
        bwd = (lambda **kw: rk.cuda_lstm_backward(*args, reverse=reverse,
                                                  **kw),
               lambda: rk.lstm_backward_reference(*args, reverse=reverse))
    else:
        fwd = (lambda **kw: rk.cuda_gru_forward(xp, wh, h0, reverse=reverse,
                                                **kw),
               lambda: rk.gru_forward_reference(xp, wh, h0,
                                                reverse=reverse))
        hs, gates, un = fwd[1]()
        hprev = (torch.cat([hs[1:], h0[None]]) if reverse
                 else torch.cat([h0[None], hs[:-1]]))
        args = (gt, hprev, gates, un, wh.T)
        bwd = (lambda **kw: rk.cuda_gru_backward(*args, reverse=reverse,
                                                 **kw),
               lambda: rk.gru_backward_reference(*args, reverse=reverse))
    return {"%s_forward" % cell: fwd, "%s_backward" % cell: bwd}


def rnn_costs(cell, b, t, h):
    """FLOPs and bytes of one forward and one backward launch: the hidden
    products (2 B H G H a step; the gate arithmetic, a few percent more, is
    left out), each input read once and each output written once."""
    g = rk.GATES[cell]
    flops = 2.0 * b * h * g * h * t
    seq, gates, w, state = t * b * h, t * b * g * h, g * h * h, b * h
    if cell == "lstm":
        # xp, wh, h0, c0 -> hs, cs, gates; gt, gates, cs, cprev, whT ->
        # dzs, dh0, dc0
        fwd = gates + w + 2 * state + 2 * seq + gates
        bwd = 3 * seq + gates + w + gates + 2 * state
    else:
        # ap, wh, h0 -> hs, gates, un; gt, hprev, gates, un, whT -> das,
        # dus, dh0
        fwd = gates + w + state + 2 * seq + gates
        bwd = 3 * seq + gates + w + 2 * gates + state
    return {"%s_forward" % cell: (flops, 4.0 * fwd),
            "%s_backward" % cell: (flops, 4.0 * bwd)}


def check_rnn_shape(device, cell, name, reverse):
    """The forward and backward kernels of ``cell`` against their plain
    versions at one shape and direction; each rerun bit-identical. Returns
    each kernel's max abs err."""
    fns = rnn_fns(cell, *rnn_inputs(device, cell, name), reverse)
    errs = {}
    for kname, (kernel, plain) in fns.items():
        runs = [kernel(), kernel()]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError("%s at %s: two runs differ" % (kname, name))
        want = plain()
        err = 0.0
        for i, (a, b) in enumerate(zip(runs[0], want)):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            tol = (RNN_TOL if kname.endswith("forward") else dict(
                rtol=GRAD_RTOL, atol=GRAD_ATOL * float(np.abs(b).max())))
            np.testing.assert_allclose(a, b, err_msg="%s at %s, output %d"
                                       % (kname, name, i), **tol)
            err = max(err, float(np.max(np.abs(a - b))))
        errs[kname] = err
    print("  %-4s %-8s %-7s max abs err forward %.3g, backward %.3g; reruns "
          "bit-identical" % (cell, name, "reverse" if reverse else "forward",
                             *errs.values()))
    return errs


def cudnn_layer(cell, wx, wh, b):
    """torch.nn.LSTM/GRU (cuDNN) holding one layer's weights: W_ih = wx^T,
    W_hh = wh^T, b_ih = b, b_hh = 0; PyTorch's GRU orders its gates r, z,
    n, so the z and r blocks swap."""
    d, gh = wx.shape
    h = wh.shape[0]
    cls = torch.nn.LSTM if cell == "lstm" else torch.nn.GRU
    layer = cls(d, h).to(wx.device)
    order = (list(range(4)) if cell == "lstm" else [1, 0, 2])

    def blocks(m):
        return torch.cat([m[..., k * h:(k + 1) * h] for k in order], dim=-1)

    with torch.no_grad():
        layer.weight_ih_l0.copy_(blocks(wx).T)
        layer.weight_hh_l0.copy_(blocks(wh).T)
        layer.bias_ih_l0.copy_(blocks(b)[0])
        layer.bias_hh_l0.zero_()
    return layer


def rnn_layer_times(device, cell):
    """One layer of config 8's second recurrent layer (D = H = 256, input
    needing a gradient) as the port runs it (K1's input projection and the
    forward kernel; the backward kernel and the post-scan products on K1)
    and as cuDNN does (torch.nn.LSTM/GRU, forward, and backward by
    autograd.grad): ms of each, and max|cuDNN - plain| of the hidden
    sequence."""
    b, t, h = RNN_SHAPES["config8"]
    g = rk.GATES[cell]
    rng = np.random.RandomState(3)

    def arr(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device)

    x = arr(b, t, h, scale=1.0)
    wx, wh = arr(h, g * h, scale=0.5 / np.sqrt(h)), arr(
        h, g * h, scale=1.0 / np.sqrt(h))
    bias, gt = arr(1, g * h, scale=0.1), arr(b, t, h, scale=1.0)
    scan = ops.lstm_scan_ if cell == "lstm" else ops.gru_scan_
    leaves = [Tensor(a, requires_grad=True) for a in (x, wx, wh, bias)]

    def port_fwd():
        return scan(*leaves)

    def port_fwd_bwd():
        port_fwd().backward(gt)

    layer = cudnn_layer(cell, wx, wh, bias)
    xt = x.transpose(0, 1).contiguous()
    x_leaf = xt.clone().requires_grad_(True)
    params = [x_leaf] + list(layer.parameters())

    def lib_fwd():
        with torch.no_grad():
            return layer(xt)[0]

    def lib_fwd_bwd():
        torch.autograd.grad(layer(x_leaf)[0], params, gt.transpose(0, 1))

    want = scan(*leaves, impl="plain").data.transpose(0, 1)
    err = float((lib_fwd() - want).abs().max())
    for fn in (port_fwd_bwd, lib_fwd_bwd):
        fn()
    pf1, pb1, lf1, lb1, lb2, lf2, pb2, pf2 = (
        epoch_ms(port_fwd, 10), epoch_ms(port_fwd_bwd, 10),
        epoch_ms(lib_fwd, 10), epoch_ms(lib_fwd_bwd, 10),
        epoch_ms(lib_fwd_bwd, 10), epoch_ms(lib_fwd, 10),
        epoch_ms(port_fwd_bwd, 10), epoch_ms(port_fwd, 10))
    out = dict(port_fwd=(pf1 + pf2) / 2, lib_fwd=(lf1 + lf2) / 2)
    out["port_bwd"] = (pb1 + pb2) / 2 - out["port_fwd"]
    out["lib_bwd"] = (lb1 + lb2) / 2 - out["lib_fwd"]
    print("one %s layer at config 8 (D = H = %d, B %d, T %d): the port "
          "(K1 projection + the forward kernel) %.4f ms forward, (the "
          "backward kernel + dx, dWx, dWh on K1 + db) %.4f ms backward; "
          "cuDNN (torch.nn.%s, f32, TF32 off) %.4f ms forward, %.4f ms "
          "backward (autograd.grad); max|cuDNN - plain| of hs %.3g"
          % (cell.upper(), h, b, t, out["port_fwd"], out["port_bwd"],
             "LSTM" if cell == "lstm" else "GRU", out["lib_fwd"],
             out["lib_bwd"], err))
    if not err < 1e-3:
        raise AssertionError("cuDNN's %s layer is not the port's function: "
                             "max|cuDNN - plain| %.3g" % (cell, err))
    return out


def check_recurrent(device):
    """K5, K5b, K5c and K5d against their plain versions at config 8's
    shape and the ragged one, both directions; then at config 8 each
    kernel's time (CUDA events, in turns with the plain version), its bound,
    and cuDNN's layer beside the port's. Returns a dict per kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    print("  tol: forward rtol 1e-4 atol 1e-5, backward rtol 1e-4 atol 1e-4 "
          "x max|plain|")
    for cell in ("lstm", "gru"):
        for name in RNN_SHAPES:
            for reverse in (False, True):
                for kname, err in check_rnn_shape(device, cell, name,
                                                  reverse).items():
                    worst[kname] = max(worst.get(kname, 0.0), err)
    out = {}
    b, t, h = RNN_SHAPES["config8"]
    for cell in ("lstm", "gru"):
        fns = rnn_fns(cell, *rnn_inputs(device, cell, "config8"), False)
        costs = rnn_costs(cell, b, t, h)
        layer = rnn_layer_times(device, cell)
        for kname, (kernel, plain) in fns.items():
            backward = kname.endswith("backward")
            cluster, rows = rk.plan_on(cell, backward, b, h, device)
            print("%s at config 8: clusters of %d blocks, %d rows each; the "
                  "card holds %d such clusters at once"
                  % (kname, cluster, rows, rk._max_clusters(
                      cell, backward, h, cluster, rows, device)))
            kernel()
            plain()
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (epoch_ms(plain, 2), epoch_ms(kernel, 20),
                              epoch_ms(kernel, 20), epoch_ms(plain, 2))
            ms = (k1 + k2) / 2
            bound_ms, bound_by = bound(*costs[kname])
            side = "fwd" if kname.endswith("forward") else "bwd"
            out[kname] = dict(max_abs_err=worst[kname], ms=ms,
                              plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                              bound_by=bound_by,
                              library_ms=layer["lib_" + side],
                              port_layer_ms=layer["port_" + side])
            print("%s at config 8: %.4f ms a launch by CUDA events (turns "
                  "%.4f, %.4f), %.2f us a step; %.4f ms device time "
                  "(queued); plain %.3f ms (turns %.3f, %.3f); bound %.4f "
                  "ms (%s-bound: %.4g GFLOP, %.4g MB); kernel at %.2f%% of it"
                  % (kname, ms, k1, k2, 1e3 * ms / t,
                     device_us(kernel, reps=5) / 1e3, out[kname]["plain_ms"],
                     p1, p2, bound_ms, bound_by, costs[kname][0] / 1e9,
                     costs[kname][1] / 1e6, 100.0 * bound_ms / ms))
            print_phases(kernel, side, t, device)
    return out


def print_phases(kernel, side, n_steps, device):
    """Block 0's time in each phase of one launch (the kernel's phase
    clock), the set-up in us and the others in us a step."""
    names = rk.PHASES["forward" if side == "fwd" else "backward"]
    phase_ns = torch.zeros(len(names), dtype=torch.int64, device=device)
    kernel(phase_ns=phase_ns)
    torch.cuda.synchronize()
    us = phase_ns.cpu().numpy() / 1e3
    print("  by phase (block 0's globaltimer): %s %.2f us; a step: %s; sum "
          "%.2f us a step" % (names[0], us[0], ", ".join(
              "%s %.2f" % (n, v / n_steps) for n, v in zip(names[1:], us[1:])),
              us[1:].sum() / n_steps))


def rnn_data():
    """Config 8's data as bench_all.py makes it: 2,048 sequences of 128 x 64
    standard-normal features and labels of 16 classes from numpy seed 0; and
    64 held-out sequences from seed 1."""
    rng = np.random.RandomState(0)
    tx = rng.randn(RNN_SAMPLES, RNN_T, RNN["num_in"]).astype(np.float32)
    ty = one_hot(rng.randint(0, RNN["num_out"], RNN_SAMPLES), RNN["num_out"])
    held = np.random.RandomState(1)
    ex = held.randn(RNN_BATCH, RNN_T, RNN["num_in"]).astype(np.float32)
    return tx, ty, ex, held.randint(0, RNN["num_out"], RNN_BATCH)


def rnn_model(device, net=None, seed=0):
    """Config 8 (or ``net``) in a Model with Adam 1e-3 on ``device``, after
    seeding the global stream with ``seed`` as bench_all.py does."""
    seeder.random_seed(seed)
    if net is None:
        net = build_rnn_classifier(**RNN)
    return Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3), device=device)


def bi_lstm_net():
    """A two-layer Bidirectional LSTM classifier at config 8's widths: each
    layer a forward cell of 256 and its reverse twin, then the 512 -> 16
    head."""
    h, d, nout = RNN["hidden"][0], RNN["num_in"], RNN["num_out"]
    return Net([Bidirectional(LSTM(h, num_in=d, return_sequences=True,
                                   seed=11)),
                Bidirectional(LSTM(h, num_in=2 * h, seed=12)),
                Dense(nout, num_in=2 * h, seed=13)])


def run_rnn_epochs(model, x_dev, y_dev, n_epochs, what):
    """``n_epochs`` epochs of ``model`` (``fused="auto"``) with the launch
    counts set to 0 before them: the first timed alone (the kernels' first
    loads), the rest together. Returns the losses, the counts and the rate
    of the epochs after the first (of the first when it is the only one)."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    first = model.train_epoch(x_dev, y_dev, batch_size=RNN_BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rest = first[None][:0]
    if n_epochs > 1:
        t0 = time.perf_counter()
        rest = model.train_epochs(x_dev, y_dev, n_epochs=n_epochs - 1,
                                  batch_size=RNN_BATCH)
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t0
    counts = launch_counts()
    losses = torch.cat([first[None], rest]).cpu().numpy()
    n_steps = losses.shape[1]
    rate = (n_steps * (n_epochs - 1) / timed_s if n_epochs > 1
            else n_steps / first_s)
    print("%s: %d epoch(s) of %d steps (batch %d, T %d); epoch 1 %.3f s; "
          "%s %.2f steps/s = %.3f ms/step; epoch-mean losses %s"
          % (what, n_epochs, n_steps, RNN_BATCH, RNN_T, first_s,
             "then" if n_epochs > 1 else "that is", rate, 1e3 / rate,
             np.array2string(losses.mean(axis=1), precision=5)))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("%s: non-finite loss" % what)
    return losses, counts, rate


def run_rnn_slice(device):
    """Config 8's main path: ``Model(build_rnn_classifier(**config8), ...,
    device="cuda").train_epochs(fused="auto")``, 3 epochs of 32 steps, an
    evaluate_batch on 64 held-out sequences; 5 Adam steps against the same
    steps through impl="plain"; a timed impl="plain" epoch; one GRU epoch
    and one Bidirectional LSTM epoch at the same widths. Returns the config-8
    model with its data, the summed launch counts and the rates."""
    tx, ty, ex, ey = rnn_data()
    model = rnn_model(device)
    x_dev, y_dev = model.stage(tx, ty)
    _, counts, rate = run_rnn_epochs(model, x_dev, y_dev, 3,
                                     "config 8, fused='auto'")
    steps = 3 * (RNN_SAMPLES // RNN_BATCH)
    res = model.evaluate_batch(ex, ey, AccEvaluator)
    logits = model.predict(ex)
    counts = launch_counts()
    # per step: each layer's forward and backward kernel; on K1 the two
    # input projections, dWx and dWh of both layers, the second layer's dx
    # (the first layer's input needs no gradient) and the head Dense's
    # forward, dW and dx. Each of the two eval forwards: 2 forward kernels,
    # 2 projections and the head.
    want = only(lstm_forward=2 * steps + 4, lstm_backward=2 * steps,
                matmul=10 * steps + 6)
    print("launches over the %d train steps and two eval forwards: %s; "
          "evaluate_batch accuracy %.4f (random labels: chance 1/16)"
          % (steps, counts, res["accuracy"]))
    if counts != want:
        raise AssertionError("launch counts %s, expected %s (K5 and K5b "
                             "twice a step, K1 10 a step)" % (counts, want))
    if tuple(logits.shape) != (RNN_BATCH, RNN["num_out"]) or \
            not torch.isfinite(logits.data).all():
        raise AssertionError("bad eval logits")
    total = dict(counts)

    # the same 5 steps through the kernels and through the plain versions
    models = [rnn_model(device) for _ in range(2)]
    for layer in models[1].net.layers[:-1]:
        layer.impl = "plain"
    losses = np.array([[float(m.train_step(tx[i * RNN_BATCH:
                                              (i + 1) * RNN_BATCH],
                                           ty[i * RNN_BATCH:
                                              (i + 1) * RNN_BATCH]))
                        for i in range(RNN_PARITY_STEPS)] for m in models])
    rel = np.abs(losses[0] - losses[1]) / np.abs(losses[1])
    print("%d Adam steps from the same weights, kernels %s, impl='plain' %s:"
          " largest relative difference %.3g (tol rtol %g)"
          % (RNN_PARITY_STEPS, np.array2string(losses[0], precision=6),
             np.array2string(losses[1], precision=6), rel.max(),
             PARITY_RTOL))
    np.testing.assert_allclose(losses[0], losses[1], rtol=PARITY_RTOL,
                               err_msg="kernels vs plain losses")
    plain = models[1]
    del models
    _, plain_counts, plain_rate = run_rnn_epochs(
        plain, x_dev, y_dev, 1, "config 8, impl='plain'")
    if plain_counts != only(matmul=10 * (RNN_SAMPLES // RNN_BATCH)):
        raise AssertionError("the plain epoch launched %s" % plain_counts)
    print("same call, config 8: the kernels %.2f steps/s, impl='plain' %.2f "
          "steps/s (its first epoch), kernels/plain %.2f"
          % (rate, plain_rate, rate / plain_rate))
    for k in total:
        total[k] += plain_counts[k]

    n_steps = RNN_SAMPLES // RNN_BATCH
    gru = rnn_model(device, build_rnn_classifier(**dict(RNN, cell="gru")))
    _, counts, gru_rate = run_rnn_epochs(gru, x_dev, y_dev, 1,
                                         "config 8 as a GRU")
    if counts != only(gru_forward=2 * n_steps, gru_backward=2 * n_steps,
                      matmul=10 * n_steps):
        raise AssertionError("GRU launch counts %s" % counts)
    for k in total:
        total[k] += counts[k]
    bi = rnn_model(device, bi_lstm_net())
    _, counts, bi_rate = run_rnn_epochs(
        bi, x_dev, y_dev, 1, "Bidirectional LSTM, 2 layers of %d + %d units"
        % (RNN["hidden"][0], RNN["hidden"][0]))
    # per step: 4 cells' forward and backward; on K1 4 projections, 4 dWx,
    # 4 dWh, the second layer's two dx and the head's 3
    if counts != only(lstm_forward=4 * n_steps, lstm_backward=4 * n_steps,
                      matmul=17 * n_steps):
        raise AssertionError("Bidirectional launch counts %s" % counts)
    for k in total:
        total[k] += counts[k]
    print("launches over the recurrent slice: %s; steps/s: LSTM %.2f, GRU "
          "%.2f (its first epoch), Bidirectional LSTM %.2f (its first epoch)"
          % (total, rate, gru_rate, bi_rate))
    return model, x_dev, y_dev, total, rate


def run_rnn_trace(model, x_dev, y_dev, steps=10):
    """Device busy share and the recurrent kernels' device time a step over
    ``steps`` config-8 train steps."""
    from torch.profiler import ProfilerActivity, profile

    xs = x_dev[:steps * RNN_BATCH].reshape(steps, RNN_BATCH, RNN_T, -1)
    ys = y_dev[:steps * RNN_BATCH].reshape(steps, RNN_BATCH, -1)
    model.train_step(xs[0], ys[0])
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
    print("trace, config 8: %d steps, wall %.1f us/step under the profiler, "
          "%d kernel launches/step" % (steps, wall_us / steps,
                                       sum(r[1] for r in rows) // steps))
    if busy_us == 0:
        print("trace, config 8: device time not measured (the profiler saw "
              "no device kernels)")
        return
    rec = {kind: sum(r[0] for r in rows if "recurrent_%s_kernel" % kind
                     in r[2]) / steps for kind in ("forward", "backward")}
    k1 = sum(r[0] for r in rows if "matmul" in r[2]) / steps
    print("trace, config 8: device busy %.1f us/step = %.1f%% of wall (idle "
          "%.1f%%); K5 %.1f, K5b %.1f us/step (%.1f%% of the device time), "
          "K1 %.1f us/step, the rest %.1f us/step"
          % (busy_us / steps, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us, rec["forward"],
             rec["backward"], 100.0 * sum(rec.values()) * steps / busy_us,
             k1, busy_us / steps - sum(rec.values()) - k1))
    for dev_us, count, key in rows[:10]:
        print("  %9.2f us/step  %3d launches/step  %s"
              % (dev_us / steps, count // steps, key[:80]))


# --------------------------------------------------------------------------
# P1 (the dropout pass), K2 with Dropout and the seven rules, P2 (the
# optimizer-only probe), 6b with dropout
# --------------------------------------------------------------------------

def dropout_flagship(rate):
    """The flagship widths (784-200-100-70-30-10, ReLU) with Dropout(rate)
    after the two first ReLUs: tpu_check.py's megakernel-dropout net with
    the flagship's depth."""
    widths = [784, 200, 100, 70, 30, 10]
    layer_list = []
    for i, (d_in, d_out) in enumerate(zip(widths, widths[1:])):
        layer_list.append(Dense(d_out, num_in=d_in))
        if i < len(widths) - 2:
            layer_list.append(ReLU())
        if i < 2:
            layer_list.append(Dropout(rate))
    return Net(layer_list)


def dropout_cost(n):
    """(FLOPs, bytes) of P1 on n elements: the survivors' scale product (the
    hash's integer operations have no peak in the H100's table and are left
    out); x read once, the output and the uint8 mask written once."""
    return float(n), 9.0 * n


def check_dropout(device):
    """P1 against ``dropout_reference`` on the card, bit for bit, at every
    DROPOUT_SHAPES shape; tpu_check's statistics on the kernel's output;
    then at the flagship's and 6b's shapes the kernel's, the plain
    version's and torch.nn.functional.dropout's times (different masks,
    the same work), back to back and in device time (``device_us``).
    Returns the kernels-line numbers at 6b's shape, in device time."""
    gen = torch.Generator().manual_seed(0)
    for name, (shape, seed) in sorted(DROPOUT_SHAPES.items()):
        x = torch.randn(shape, generator=gen).to(device)
        out, mask = dropout.cuda_dropout(x, DROPOUT_RATE, seed)
        torch.cuda.synchronize()
        ref, ref_mask = dropout.dropout_reference(x, DROPOUT_RATE, seed)
        if not (torch.equal(mask.bool(), ref_mask) and torch.equal(out, ref)):
            raise AssertionError("%s: P1 differs from its plain version"
                                 % name)
        print("  %-11s %-16s seed %10d: bit-identical to the plain version "
              "(kept %.4f)" % (name, tuple(shape), seed,
                               float(ref_mask.float().mean())))
    masks = {}
    for seed in (1, 2):
        out = dropout.cuda_dropout(torch.ones(256, 256, device=device), 0.5,
                                   seed)[0].cpu().numpy()
        zero_frac = float((out == 0.0).mean())
        if abs(zero_frac - 0.5) >= 0.02 or not np.all(out[out != 0.0] == 2.0):
            raise AssertionError("seed %d: zero fraction %.4f, survivors %s"
                                 % (seed, zero_frac, np.unique(out)))
        masks[seed] = out != 0.0
        print("tpu_check tile, seed %d: zero fraction %.5f (within 0.02 of "
              "0.5), survivors all 2.0" % (seed, zero_frac))
    differ = float((masks[1] != masks[2]).mean())
    print("seeds 1 and 2 differ on %.4f of the cells (> 0.3)" % differ)
    if not differ > 0.3:
        raise AssertionError("seed divergence %.4f" % differ)
    result = None
    for name in ("flagship", "config6b"):
        shape, seed = DROPOUT_SHAPES[name]
        x = torch.randn(shape, generator=gen).to(device)

        def kernel():
            return dropout.cuda_dropout(x, DROPOUT_RATE, seed)

        def plain():
            return dropout.dropout_reference(x, DROPOUT_RATE, seed)

        def library():
            return torch.nn.functional.dropout(x, DROPOUT_RATE, training=True)

        reps = 200 if name == "flagship" else 50
        p1, k1, k2, p2 = (launch_us(f, reps) for f in (plain, kernel, kernel,
                                                        plain))
        lib = launch_us(library, reps)
        dev = [device_us(f) for f in (kernel, plain, library)]
        bound_ms, bound_by = bound(*dropout_cost(x.numel()))
        print("P1 at %s %s: launch us (host dispatch included) kernel %.2f "
              "(turns %.2f, %.2f), plain %.2f, F.dropout %.2f; device us "
              "kernel %.2f, plain %.2f, F.dropout %.2f; bound %.2f us "
              "(%s-bound), kernel's device time at %.1f%% of it"
              % (name, tuple(shape), (k1 + k2) / 2, k1, k2, (p1 + p2) / 2,
                 lib, dev[0], dev[1], dev[2], 1e3 * bound_ms, bound_by,
                 100.0 * 1e3 * bound_ms / dev[0]))
        result = dict(max_abs_err=0.0, ms=dev[0] / 1e3, plain_ms=dev[1] / 1e3,
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=dev[2] / 1e3)
    return result


def k2_state_run(fn, net, opt, spec, xb, yb, t0=0, state=None):
    """One epoch of ``fn`` (the kernel's wrapper or its plain version) from
    ``state`` ((params, slots) trees, updated in place), or from fresh
    copies of the net's weights and zero slots: (losses, leaves)."""
    params, slots = fresh_state(net, opt) if state is None else state
    scalars = torch.from_numpy(opt.step_scalars(t0, xb.shape[0])).to(
        xb.device)
    losses = fn(spec, fused_epoch.dense_leaves(net, params),
                {k: fused_epoch.dense_leaves(net, v) for k, v in slots.items()},
                xb, yb, scalars, t0=t0)
    return losses.cpu().numpy(), [t.cpu().numpy().copy()
                                  for t in leaves_of(params, slots)]


def sign_margins(spec, run):
    """``run()`` (a run of ``fused_epoch_reference``) with, for each
    element, how near its rule's step came to a sign decided by rounding:
    Lion's step is lr sign(u), u = b1 m + (1 - b1) g, and Adam's, from zero
    slots at a large step count, ~3 lr sign(g) until sqrt(v) nears eps. An
    element's margin is the least, over the steps, of the plain version's
    |u| (Lion) or sqrt(v) s1 (Adam's denominator less eps) as a share of
    the largest in its leaf at that step; a step where it is exactly 0 (no
    gradient at all) does not count. Returns run()'s result and the margins
    of each Dense's w and b, as trees: [{"w": ..., "b": ...}]."""
    rule, name = fused_epoch.apply_rule, fused_epoch.OPTIMIZERS[spec.optimizer]
    c0, c1 = spec.consts[:2]
    shares = []

    def apply(spec_, p, g, slots, s0, s1):
        if name == "Lion":
            size = torch.abs(c0 * slots[0] + c1 * g)
        else:  # Adam's v as the rule updates it
            size = torch.sqrt(slots[1] + c1 * (g * g - slots[1])) * s1
        share = size / size.max()
        shares.append(torch.where(size > 0, share, torch.inf))
        rule(spec_, p, g, slots, s0, s1)

    fused_epoch.apply_rule = apply
    try:
        out = run()
    finally:
        fused_epoch.apply_rule = rule
    n = 2 * len(spec.layers)  # the rule's calls a step: each Dense's w, b
    least = [torch.stack(shares[j::n]).amin(0).cpu().numpy()
             for j in range(n)]
    return out, [{"w": least[j], "b": least[j + 1]} for j in range(0, n, 2)]


def hold_k2(what, net, opt, xb, yb, t0=0, marked=False, stepwise=False):
    """K2 against its plain version over the batches of xb: losses and the
    state at K2's gates, and a rerun bit-identical. With ``marked`` (Lion,
    Adam from zero slots at a large step count) the state is held but at
    the elements whose ``sign_margins`` margin is under SIGN_MARGIN: there
    the kernel's and cuBLAS's summation orders can give a step of the other
    sign. With ``stepwise`` each step is held on its own, the kernel and
    the plain version both starting from the plain version's state after
    the step before (Lion: a weight moved 2 lr changes every later
    gradient, and the losses part after a few steps). Printed with
    ``marked``: how many were left out, their largest difference, and the
    largest margin of an element past STATE_TOL. Returns the max abs
    error."""
    spec = fused_epoch.epoch_spec(net, opt)
    plain_state = fresh_state(net, opt) if stepwise else None
    spans = ([(t0 + i, xb[i:i + 1], yb[i:i + 1]) for i in range(len(xb))]
             if stepwise else [(t0, xb, yb)])
    worst, left, left_diff, n_past, past_margin = 0.0, 0, 0.0, 0, 0.0
    checks = []
    for t, x, y in spans:
        got, got_state = k2_state_run(
            fused_epoch.cuda_fused_epoch, net, opt, spec, x, y, t,
            None if plain_state is None else clone_state(*plain_state))

        def plain():
            return k2_state_run(fused_epoch.fused_epoch_reference, net, opt,
                                spec, x, y, t, plain_state)

        if marked:
            (want, want_state), margins = sign_margins(spec, plain)
            margins = leaves_of(margins, {k: margins for k in opt.slot_names})
        else:
            want, want_state = plain()
            margins = [np.full(a.shape, np.inf) for a in got_state]
        masks = [m < SIGN_MARGIN for m in margins]
        past = [np.abs(a - b) > STATE_TOL["atol"] + STATE_TOL["rtol"]
                * np.abs(b) for a, b in zip(got_state, want_state)]
        left += sum(int(m.sum()) for m in masks[:2 * len(spec.layers)])
        left_diff = max([left_diff] + [
            float(np.max(np.abs(a - b)[m], initial=0.0))
            for a, b, m in zip(got_state, want_state, masks)])
        n_past += sum(int(p.sum()) for p in past)
        past_margin = max([past_margin] + [
            float(np.max(m[p], initial=0.0)) for m, p in zip(margins, past)])
        checks.append((" at step %d" % t if stepwise else "", got, want,
                       got_state, want_state, masks))
    if marked:
        print("  %s: %d of %d parameters%s (and their slots) left out of "
              "the state hold (margin under %.3g), their largest difference "
              "%.3g; %d elements past the state gate, their margins %.3g at "
              "most" % (what, left, len(spans) * sum(
                  int(np.prod(w.shape)) + int(np.prod(b.shape))
                  for w, b in fused_epoch.dense_leaves(
                      net, net.params_tree())),
                        " x steps" if stepwise else "", SIGN_MARGIN,
                        left_diff, n_past, past_margin))
    for at, got, want, got_state, want_state, masks in checks:
        np.testing.assert_allclose(got, want, err_msg=what + " losses" + at,
                                   **LOSS_TOL)
        worst = max(worst, float(np.max(np.abs(got - want))))
        for i, (a, b, mask) in enumerate(zip(got_state, want_state, masks)):
            np.testing.assert_allclose(
                a[~mask], b[~mask], err_msg="%s state leaf %d%s"
                % (what, i, at), **STATE_TOL)
            worst = max(worst, float(np.max(np.abs(a - b)[~mask])))
    first, again = (k2_state_run(fused_epoch.cuda_fused_epoch, net, opt,
                                 spec, xb, yb, t0) for _ in range(2))
    if not (np.array_equal(first[0], again[0]) and all(
            np.array_equal(a, b) for a, b in zip(first[1], again[1]))):
        raise AssertionError("%s: two runs from the same state differ" % what)
    return worst


def parity_batches(device, n, seed=PARITY_DATA_SEED):
    (x, y), _ = synthetic_mnist(n * BATCH, 10, seed=seed)
    return (torch.from_numpy(x).to(device).reshape(n, BATCH, 784),
            torch.from_numpy(one_hot(y)).to(device).reshape(n, BATCH, 10))


def check_k2_dropout(device):
    """K2 on the flagship with Dropout(0.3) after the two first ReLUs: against
    its plain version over a 10-step epoch from pinned seed-1 weights (from
    step 0 and from step 3000, where the seeds pass the int32 wrap), reruns
    bit-identical; both timed over a 390-step epoch; the step loop's launches
    and its losses against K2's over 5 steps; then tpu_check.py's run, rate
    0.0 against 0.3 through fused="auto". Returns the max abs error, the
    kernel's ms per epoch, and the launch counts of the main-path runs."""
    with seeder.scope(1):
        net = dropout_flagship(DROPOUT_RATE).to(device)
    opt = Adam(1e-3)
    xb, yb = parity_batches(device, 10)
    worst = 0.0
    # from step 3000 the seeds pass the int32 wrap; there, from zero slots,
    # Adam's steps are ~3 lr signs of the gradients (the bias corrections
    # are ~1): its hold leaves out the elements sign_margins marks
    for t0, step_opt in ((0, opt), (3000, SGD(0.03)), (3000, Adam(1e-3))):
        name = "K2 with Dropout, 10 steps from step %d (%s)" % (
            t0, type(step_opt).__name__)
        err = hold_k2(name, net, step_opt, xb, yb, t0,
                      marked=t0 > 0 and isinstance(step_opt, Adam))
        worst = max(worst, err)
        print("%s: max abs err over losses and state %.3g (tol losses rtol "
              "1e-5 atol 1e-6, state rtol 1e-4 atol 1e-5); rerun "
              "bit-identical" % (name, err))
    spec = fused_epoch.epoch_spec(net, opt)
    (x, y), _ = synthetic_mnist(EPOCH_STEPS * BATCH, 10)
    xe = torch.from_numpy(x).to(device).reshape(EPOCH_STEPS, BATCH, 784)
    ye = torch.from_numpy(one_hot(y)).to(device).reshape(EPOCH_STEPS, BATCH,
                                                           10)
    se_ = torch.from_numpy(opt.step_scalars(0, EPOCH_STEPS)).to(device)
    params, slots = fresh_state(net, opt)
    pairs = (fused_epoch.dense_leaves(net, params),
             {k: fused_epoch.dense_leaves(net, v) for k, v in slots.items()})

    def kernel():
        fused_epoch.cuda_fused_epoch(spec, *pairs, xe, ye, se_)

    def plain():
        fused_epoch.fused_epoch_reference(spec, *pairs, xe, ye, se_)

    kernel()
    p1, k1, k2, p2 = (epoch_ms(plain, 1), epoch_ms(kernel, 3),
                      epoch_ms(kernel, 3), epoch_ms(plain, 1))
    ms = (k1 + k2) / 2
    print("a %d-step epoch with Dropout: kernel %.3f ms (%.2f us/step; turns "
          "%.3f, %.3f), plain %.1f ms (turns %.1f, %.1f)"
          % (EPOCH_STEPS, ms, 1e3 * ms / EPOCH_STEPS, k1, k2,
             (p1 + p2) / 2, p1, p2))

    # the step loop: 14 K1 and 2 P1 launches a step, the losses of K2's
    # steps, since the masks are the same
    n = 5
    xs = xb[:n].reshape(n * BATCH, 784)
    ys = yb[:n].reshape(n * BATCH, 10)
    models = []
    for _ in range(2):
        model = Model(dropout_flagship(DROPOUT_RATE), SoftmaxCrossEntropyLoss(),
                      Adam(1e-3), device=device)
        model.net.set_parameters([{k: v.clone() for k, v in d.items()}
                                  for d in net.params_tree()])
        models.append(model)
    l_k2 = models[0].train_epoch(xs, ys, batch_size=BATCH, shuffle=False,
                                 fused=True).cpu().numpy()
    zero_counts()
    l_loop = models[1].train_epoch(xs, ys, batch_size=BATCH, shuffle=False,
                                   fused=False).cpu().numpy()
    loop_counts = launch_counts()
    print("step loop, %d steps: launches %s (expected 14 K1 and 2 P1 a step); "
          "losses %s, K2's %s, max abs difference %.3g (tol rtol 1e-5 atol "
          "1e-6)" % (n, {k: v for k, v in loop_counts.items() if v},
                     np.array2string(l_loop, precision=6),
                     np.array2string(l_k2, precision=6),
                     float(np.max(np.abs(l_loop - l_k2)))))
    if loop_counts != only(matmul=14 * n, dropout=2 * n):
        raise AssertionError("step loop launches %s" % loop_counts)
    np.testing.assert_allclose(l_loop, l_k2, err_msg="step loop vs K2",
                               **LOSS_TOL)

    # tpu_check.py:74-120: rate 0.0 against 0.3, 5 epochs through
    # fused="auto", synthetic_mnist(12800, 2000), Adam 1e-3
    (tx, ty), (ex, ey) = synthetic_mnist(12800, 2000)
    traces, k2_counts = {}, None
    for rate in (0.0, 0.3):
        seeder.random_seed(0)
        net_r = Net([Dense(200, num_in=784), ReLU(), Dropout(rate),
                     Dense(100, num_in=200), ReLU(), Dropout(rate),
                     Dense(10, num_in=100)])
        model = Model(net_r, SoftmaxCrossEntropyLoss(), Adam(1e-3),
                      device=device)
        x_dev, y_dev = model.stage(tx, one_hot(ty))
        torch.cuda.synchronize()
        zero_counts()
        trace = model.train_epochs(x_dev, y_dev, n_epochs=5,
                                   batch_size=BATCH).cpu().numpy()
        counts = launch_counts()
        if rate:
            k2_counts = counts
        acc = model.evaluate_batch(ex, ey, AccEvaluator)["accuracy"]
        print("tpu_check run, rate %.1f: loss %.4f -> %.4f over 5 epochs of "
              "%d steps; accuracy %.4f; launches %s"
              % (rate, trace[0, 0], trace[-1, -1], trace.shape[1], acc,
                 {k: v for k, v in counts.items() if v}))
        if counts != only(fused_epoch=5):
            raise AssertionError("rate %.1f: launches %s, expected 1 K2 an "
                                 "epoch and nothing else" % (rate, counts))
        if not (np.all(np.isfinite(trace))
                and trace[-1, -1] < 0.5 * trace[0, 0]):
            raise AssertionError("rate %.1f: losses %s -> %s"
                                 % (rate, trace[0, 0], trace[-1, -1]))
        traces[rate] = trace
    if np.allclose(traces[0.0], traces[0.3]):
        raise AssertionError("dropout had no effect inside K2")
    print("rate 0.3 trains differently from rate 0.0 (max abs loss "
          "difference %.3g)" % float(np.max(np.abs(traces[0.3]
                                                     - traces[0.0]))))
    return worst, ms, loop_counts, k2_counts


def sweep_optimizers():
    """examples/mnist/optimizer_sweep.py's table at lr 1e-3, a schedule and
    clip_norm."""
    return {"sgd": SGD(lr=0.03), "momentum": Momentum(lr=0.01, momentum=0.9),
            "adam": Adam(lr=1e-3), "rmsprop": RMSProp(lr=1e-3),
            "adagrad": Adagrad(lr=3e-3), "adadelta": Adadelta(lr=1.0),
            "lion": Lion(lr=1e-4),
            "adam_warmup_cosine": Adam(lr=WarmupCosineLR(
                1e-3, warmup_steps=100, decay_steps=EPOCH_STEPS)),
            "adam_clip_norm": Adam(lr=1e-3, clip_norm=1.0)}


def check_sweep(device):
    """Each rule of the sweep: K2 against its plain version over the 10
    pinned parity steps of the flagship with Dropout (K2's gates, Lion's
    state but at the elements ``sign_margins`` marks, rerun bit-identical);
    then, on the flagship, one epoch through ``fused="auto"`` and a second
    timed by CUDA events, one K2 launch each (counted over both). The first
    epoch's losses are held to the plain version's over the same epoch for
    SWEEP_HELD_STEPS steps at K2's loss gate; its gap over the whole epoch
    is printed beside the gap between two runs of the plain version, on the
    card and on the CPU (two other summation orders). Last, one
    ``fused=False`` epoch from the same weights. Returns the max abs error,
    the K2 launch count, and each rule's (K2 steps/s, step-loop steps/s, K2
    ms an epoch by events)."""
    # the pinned parity weights, with the two Dropout layers: where a ReLU
    # unit's input is within rounding of 0 the two summation orders can
    # leave it active in one run only, and the larger steps of SGD 0.03 and
    # Momentum move units near 0 more often than Adam 1e-3 does; these
    # weights and data have no such unit over the 10 steps for any rule
    with seeder.scope(1):
        pinned = dropout_flagship(DROPOUT_RATE).to(device)
    xb, yb = parity_batches(device, 10)
    lion_batches = parity_batches(device, 10, LION_DATA_SEED)
    seeder.random_seed(0)
    (train_x, train_y), _ = synthetic_mnist()
    with seeder.scope(0):
        start = build_mnist_mlp()
    worst, k2_launches, rates = 0.0, 0, {}
    for name, opt in sweep_optimizers().items():
        lion = name == "lion"
        batches = lion_batches if lion else (xb, yb)
        err = hold_k2(name, pinned, opt, *batches, marked=lion, stepwise=lion)
        worst = max(worst, err)
        models = []
        for _ in range(2):
            model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                          sweep_optimizers()[name], device=device)
            model.net.set_parameters([{k: v.clone() for k, v in d.items()}
                                      for d in start.params_tree()])
            models.append(model)
        x_dev, y_dev = models[0].stage(train_x, one_hot(train_y))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        l_k2 = models[0].train_epoch(x_dev, y_dev, batch_size=BATCH,
                                     shuffle=False).cpu().numpy()
        k2_s = time.perf_counter() - t0
        # a second epoch, between CUDA events: K2's time an epoch
        k2_ms = epoch_ms(lambda: models[0].train_epoch(
            x_dev, y_dev, batch_size=BATCH, shuffle=False), 1)
        counts = launch_counts()
        if counts != only(fused_epoch=2):
            raise AssertionError("%s: two fused='auto' epochs launched %s"
                                 % (name, counts))
        k2_launches += counts["fused_epoch"]
        n_steps = len(l_k2)
        xe = x_dev[:n_steps * BATCH].reshape(n_steps, BATCH, 784)
        ye = y_dev[:n_steps * BATCH].reshape(n_steps, BATCH, 10)
        # the plain version over the same epoch from the same weights, on
        # the card and on the CPU
        l_plain = {}
        for where in (device, torch.device("cpu")):
            net_p = build_mnist_mlp().to(where)
            net_p.set_parameters([{k: v.clone().to(where)
                                   for k, v in d.items()}
                                  for d in start.params_tree()])
            opt_p = sweep_optimizers()[name]
            l_plain[where.type] = k2_state_run(
                fused_epoch.fused_epoch_reference, net_p, opt_p,
                fused_epoch.epoch_spec(net_p, opt_p),
                xe.to(where).contiguous(), ye.to(where).contiguous())[0]
        np.testing.assert_allclose(
            l_k2[:SWEEP_HELD_STEPS], l_plain["cuda"][:SWEEP_HELD_STEPS],
            err_msg="%s: the main path's epoch against the plain version"
            % name, **LOSS_TOL)
        gap = np.abs(l_k2 - l_plain["cuda"])
        witness = np.abs(l_plain["cpu"] - l_plain["cuda"])
        worst = max(worst, float(gap[:SWEEP_HELD_STEPS].max()))
        t0 = time.perf_counter()
        l_loop = models[1].train_epoch(x_dev, y_dev, batch_size=BATCH,
                                       shuffle=False, fused=False)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        rates[name] = (n_steps / k2_s, n_steps / loop_s, k2_ms)
        print("  %-19s pinned steps: max abs err %.3g; epoch of %d steps: K2 "
              "%.1f steps/s (epoch 2 %.3f ms by events), fused=False %.1f "
              "steps/s (%.1fx); losses over the epoch, max abs diff over "
              "steps 0-%d (held, rtol 1e-5 atol 1e-6) / 0-99 / all: K2 vs "
              "plain %.3g / %.3g / %.3g, plain on the card vs on the CPU "
              "%.3g / %.3g / %.3g; last losses K2 %.5f, plain %.5f, plain "
              "on the CPU %.5f, step loop %.5f"
              % (name, err, n_steps, rates[name][0], k2_ms,
                 rates[name][1], rates[name][0] / rates[name][1],
                 SWEEP_HELD_STEPS - 1, gap[:SWEEP_HELD_STEPS].max(),
                 gap[:100].max(), gap.max(),
                 witness[:SWEEP_HELD_STEPS].max(), witness[:100].max(),
                 witness.max(), l_k2[-1], l_plain["cuda"][-1],
                 l_plain["cpu"][-1], float(l_loop[-1])))
        if not (np.isfinite(l_k2).all() and torch.isfinite(l_loop).all()):
            raise AssertionError("%s: non-finite loss" % name)
    return worst, k2_launches, rates


def check_mega_probe(device, k2_optimizer_us):
    """P2 against ``mega_probe_reference`` after 100 steps (rtol 1e-5) for
    each of the seven rules; then bench_mega_probe_torch.py's four timings
    (N_STEPS steps a launch, the median of three) with their bounds, beside
    K2's optimizer phase and torch.optim.Adam(fused=True)'s step. Returns
    the launch counts of the timed runs and the kernels-line numbers (Adam,
    per step)."""
    worst = 0.0
    for name in ("SGD", "Momentum", "RMSProp", "Adam", "Adagrad", "Adadelta",
                 "Lion"):
        opt = {"SGD": SGD, "Momentum": Momentum, "RMSProp": RMSProp,
               "Adam": Adam, "Adagrad": Adagrad, "Adadelta": Adadelta,
               "Lion": Lion}[name](lr=1e-3)
        (kp, ks), (rp, rs) = (probe_bench.start_state(opt, device)
                              for _ in range(2))
        mega_probe.cuda_mega_probe(opt, kp, ks, 1, 100)
        torch.cuda.synchronize()
        mega_probe.mega_probe_reference(opt, rp, rs, 1, 100)
        pairs = list(zip(kp, rp)) + [pair for n in opt.slot_names
                                     for pair in zip(ks[n], rs[n])]
        err = 0.0
        for i, (a, b) in enumerate(pairs):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9,
                                       err_msg="%s leaf %d" % (name, i))
            err = max(err, float(np.max(np.abs(a - b))))
        worst = max(worst, err)
        print("  %-9s 100 steps: max abs err %.3g (tol rtol 1e-5 atol 1e-9)"
              % (name, err))
    zero_counts()
    out, adam = {}, None
    for name, make in probe_bench.PROBES:
        opt = make()
        us = probe_bench.time_probe(opt, device, probe_bench.N_STEPS,
                                    probe_bench.REPEATS)
        n_bytes = probe_bench.bytes_per_step(opt)
        # at most 12 f32 operations an element (Adam's rule)
        bound_ms, bound_by = bound(12.0 * n_bytes / 8, n_bytes)
        out[name] = us
        print("  mega_opt_%s_us_per_step %.4f; bound %.4f us (%s-bound, %.2f "
              "MB a step); at %.1f%% of it"
              % (name, us, 1e3 * bound_ms, bound_by, n_bytes / 1e6,
                 100.0 * 1e3 * bound_ms / us))
        if name == "adam":
            adam = (us, bound_ms, bound_by, opt)
    counts = launch_counts()
    for name in ("momentum", "rmsprop", "adam"):
        print("  mega_opt_%s_delta_vs_sgd_us %.4f"
              % (name, out[name] - out["sgd"]))
    print("K2's optimizer phase with Adam (block 0's clock, barrier "
          "included): %.2f us/step; the probe's Adam step %.2f us"
          % (k2_optimizer_us, out["adam"]))
    # the plain version's step, and torch.optim.Adam(fused=True)'s: one call
    # that computes the same update (gradients set to 1e-3 p beforehand)
    us, bound_ms, bound_by, opt = adam
    params, slots = probe_bench.start_state(opt, device)
    plain_us = launch_us(lambda: mega_probe.mega_probe_reference(
        opt, params, slots, 1, 1), reps=50)
    leaves = [p.clone().requires_grad_(True) for p in params]
    for p in leaves:
        p.grad = 1e-3 * p.detach()
    torch_adam = torch.optim.Adam(leaves, lr=1e-3, fused=True)
    lib_us = launch_us(torch_adam.step, reps=200)
    print("Adam step: probe kernel %.3f us (CUDA events over %d steps in one "
          "launch), plain version %.1f us and "
          "torch.optim.Adam(fused=True).step %.2f us (back to back, host "
          "dispatch included)" % (us, probe_bench.N_STEPS, plain_us, lib_us))
    return counts, dict(max_abs_err=worst, ms=us / 1e3, plain_ms=plain_us / 1e3,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_us / 1e3)


# Mellum 2's attention as its cell runs it (32:4 GQA of head dim 128, three
# layers banded to 1,024 keys and a full YaRN layer) in a cut net for the
# main path's launches: hidden 512, 2 held experts of width 64 (top-8 of
# 64), a 1,024-id vocabulary, 2 x 2,048 ids a step
MELLUM2_SLICE = dict(
    vocab=1024, dim=512, heads=32, kv_heads=4, head_dim=128,
    layer_types=("sliding_attention",) * 3 + ("full_attention",),
    window=1024, num_experts=64, top_k=8, expert_width=64,
    experts_held=range(2), rope_theta=500000.0,
    yarn=dict(rope_type="yarn", rope_theta=500000, factor=16,
              original_max_position_embeddings=8192, beta_fast=32,
              beta_slow=1, attention_factor=1.2772588722239782))
MELLUM2_SLICE_STEPS, MELLUM2_SLICE_IDS = 3, (2, 2048)


def run_mellum2_slice(device):
    """``Model(build_moe_lm(**MELLUM2_SLICE), ..., device="cuda")
    .train_step`` from seed 0, 3 steps: each attention kernel once a layer
    a step, every dq and dk/dv launch on the wgmma kernels (head dim 128),
    counted in each wrapper's ``wgmma_launches``; finite losses. Returns
    the launch counts."""
    from tinynn_autograd_tpu_torch.models import build_moe_lm
    from tinynn_autograd_tpu_torch.nn.losses import (
        SparseSoftmaxCrossEntropyLoss,
    )

    with seeder.scope(0):
        net = build_moe_lm(**MELLUM2_SLICE)
    model = Model(net, SparseSoftmaxCrossEntropyLoss(), Adam(1e-6),
                  device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    b, t = MELLUM2_SLICE_IDS
    ids = torch.randint(0, MELLUM2_SLICE["vocab"], (b, t + 1),
                        generator=gen, device=device)
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    torch.cuda.synchronize()
    zero_counts()
    wrappers = (attention.cuda_attention_backward_dq,
                attention.cuda_attention_backward_dkv)
    wgmma = [fn.wgmma_launches for fn in wrappers]
    t0 = time.perf_counter()
    losses = [float(model.train_step(x, y))
              for _ in range(MELLUM2_SLICE_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MELLUM2_SLICE_STEPS
    counts = launch_counts()
    wgmma = [fn.wgmma_launches - n for fn, n in zip(wrappers, wgmma)]
    calls = len(MELLUM2_SLICE["layer_types"]) * MELLUM2_SLICE_STEPS
    print("Mellum 2 slice (32:4 GQA of head dim 128, window 1,024 on 3 layers "
          "of 4; hidden 512, 2 held experts): %d steps of %d x %d ids, %.3f s "
          "a step; losses %s; attention launches forward %d, dq %d (%d on "
          "the wgmma kernel), dk/dv %d (%d on the wgmma kernel)"
          % (MELLUM2_SLICE_STEPS, b, t, step_s,
             ", ".join("%.5f" % x for x in losses),
             counts["attention_forward"], counts["attention_backward_dq"],
             wgmma[0], counts["attention_backward_dkv"], wgmma[1]))
    got = (counts["attention_forward"], counts["attention_backward_dq"],
           wgmma[0], counts["attention_backward_dkv"], wgmma[1])
    if got != (calls,) * 5:
        raise AssertionError("Mellum 2 slice: attention launches (forward, "
                             "dq, dq on wgmma, dk/dv, dk/dv on wgmma) %s, "
                             "expected %d each" % (got, calls))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("Mellum 2 slice: non-finite loss")
    return counts


# Moonlight's attention as its cell runs it (multi-head latent attention: 16
# heads of 192-wide queries and keys and 128-wide values, a 512 latent,
# causal) in a cut net for the main path's launches: hidden 512, a dense
# layer of 256, then an expert layer of 2 held experts of width 64 (top-6 of
# 64, sigmoid) and a shared expert of 128, a 1,024-id vocabulary, 2 x 2,048
# ids a step
MOONLIGHT_SLICE = dict(
    vocab=1024, dim=512, heads=16, qk_nope_dim=128, qk_rope_dim=64,
    v_dim=128, kv_rank=512, n_layers=2, first_dense=1, dense_width=256,
    num_experts=64, top_k=6, expert_width=64, shared_width=128,
    experts_held=range(2), routed_scaling=2.446, rope_theta=50000.0,
    eps=1e-5)
MOONLIGHT_SLICE_STEPS, MOONLIGHT_SLICE_IDS = 3, (2, 2048)


def run_moonlight_slice(device):
    """``Model(build_mla_moe_lm(**MOONLIGHT_SLICE), ..., device="cuda")
    .train_step`` from seed 0, 3 steps: each attention kernel once a layer
    a step, every launch at the split head dims (each wrapper's
    ``split_launches`` equal to its launches), every dk/dv launch on the
    split wgmma kernel and no dq launch on wgmma; finite losses. Returns the
    launch counts."""
    from tinynn_autograd_tpu_torch.models import build_mla_moe_lm
    from tinynn_autograd_tpu_torch.nn.losses import (
        SparseSoftmaxCrossEntropyLoss,
    )

    with seeder.scope(0):
        net = build_mla_moe_lm(**MOONLIGHT_SLICE)
    model = Model(net, SparseSoftmaxCrossEntropyLoss(), Adam(1e-6),
                  device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    b, t = MOONLIGHT_SLICE_IDS
    ids = torch.randint(0, MOONLIGHT_SLICE["vocab"], (b, t + 1),
                        generator=gen, device=device)
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    torch.cuda.synchronize()
    zero_counts()
    wrappers = (attention.cuda_attention_forward,
                attention.cuda_attention_backward_dq,
                attention.cuda_attention_backward_dkv)
    split = [fn.split_launches for fn in wrappers]
    wgmma = [fn.wgmma_launches for fn in wrappers[1:]]
    t0 = time.perf_counter()
    losses = [float(model.train_step(x, y))
              for _ in range(MOONLIGHT_SLICE_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOONLIGHT_SLICE_STEPS
    counts = launch_counts()
    split = [fn.split_launches - n for fn, n in zip(wrappers, split)]
    wgmma = [fn.wgmma_launches - n for fn, n in zip(wrappers[1:], wgmma)]
    calls = MOONLIGHT_SLICE["n_layers"] * MOONLIGHT_SLICE_STEPS
    print("Moonlight slice (16 heads of 192/128, latent 512, causal; hidden "
          "512, a dense layer, 2 held experts and a shared one): %d steps "
          "of %d x %d ids, %.3f s a step; losses %s; attention launches "
          "forward %d, dq %d, dk/dv %d; at split dims %s; on wgmma %s"
          % (MOONLIGHT_SLICE_STEPS, b, t, step_s,
             ", ".join("%.5f" % x for x in losses),
             counts["attention_forward"], counts["attention_backward_dq"],
             counts["attention_backward_dkv"], split, wgmma))
    got = (counts["attention_forward"], counts["attention_backward_dq"],
           counts["attention_backward_dkv"])
    if got != (calls,) * 3 or split != [calls] * 3 or wgmma != [0, calls]:
        raise AssertionError("Moonlight slice: attention launches (forward, "
                             "dq, dk/dv) %s, at split dims %s, on wgmma "
                             "(dq, dk/dv) %s; expected %d each at split dims,"
                             " the dk/dv ones on wgmma"
                             % (got, split, wgmma, calls))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("Moonlight slice: non-finite loss")
    return counts


def run_transformer_dropout(device):
    """Config 6b with dropout=0.1 and attn_dropout=0.1 for one epoch from
    seed 0: per step P1 twice a block (the residual sites; the attention
    probabilities drop inside K4 and K4d), each attention kernel once a
    block, K1 39 times (36 on the tensor-core tile). Returns the launch
    counts and the steps/s."""
    tx, ty, _, _ = transformer_data()
    with seeder.scope(0):
        net = build_tiny_transformer(dropout=0.1, attn_dropout=0.1,
                                     **TRANSFORMER)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3), device=device)
    x_dev, y_dev = model.stage(tx, ty)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = model.train_epoch(x_dev, y_dev, batch_size=T_BATCH)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = launch_counts()
    steps = int(losses.shape[0])
    depth = TRANSFORMER["depth"]
    print("6b with dropout 0.1 and attn_dropout 0.1: %d steps in %.3f s = "
          "%.2f steps/s; losses %.5f -> %.5f; "
          "launches %s, K1 on the tensor-core tile %d"
          % (steps, epoch_s, steps / epoch_s, float(losses[0]),
             float(losses[-1]), {k: v for k, v in counts.items() if v},
             kernels.cuda_matmul.tc_launches))
    k1, tc = transformer_k1(steps)
    want = only(attention_forward=depth * steps,
                attention_backward_dq=depth * steps,
                attention_backward_dkv=depth * steps,
                matmul=k1, dropout=2 * depth * steps)
    if counts != want or kernels.cuda_matmul.tc_launches != tc:
        raise AssertionError("launch counts %s and %d on the tensor-core "
                             "tile, expected %s and %d" % (
                                 counts, kernels.cuda_matmul.tc_launches,
                                 want, tc))
    if not torch.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    return counts, steps / epoch_s


def check_block(device):
    """K7 through the probe's entry point, ``probe_shape``, at its four
    shapes, each shape's launch counts set to 0 before it and read after
    it: K7 at least once and nothing but K7 and the tape forward's
    attention kernel and K1 (its six Dense products a call); the kernel
    held to its plain version and to the tape forward, the library call to
    the plain version (the probe's tolerance); the timed shapes' times
    beside the bound. Then two more launches at each shape, bit-identical,
    each counted once. Returns K7's launches in the probe's runs and the
    kernels-line numbers (at 6b's block)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, launches = {}, 0
    for name in block_bench.CONFIGS:
        zero_counts()
        rows[name] = block_bench.probe_shape(name, device,
                                             timed=name in BLOCK_TIMED)
        counts = launch_counts()
        print("  %s" % json.dumps(rows[name]))
        others = {k: v for k, v in counts.items() if v and k not in (
            "block_forward", "attention_forward", "matmul")}
        if counts["block_forward"] < 1 or others or counts["matmul"] < 6 \
                or counts["matmul"] % 6:
            raise AssertionError("%s: launch counts %s" % (name, counts))
        launches += counts["block_forward"]
    for name in BLOCK_TIMED:
        row = rows[name]
        print("%s (%s): K7 %.2f us, %.1f%% of its %.2f us bound (%s); the "
              "tape forward %.2f us (vs_tape %.3f), TransformerEncoderLayer "
              "%.2f us, the plain version %.2f us"
              % (name, row["shape"], row["kernel_us"],
                 100.0 * row["bound_us"] / row["kernel_us"], row["bound_us"],
                 row["bound_by"], row["tape_us"], row["vs_tape"],
                 row["library_us"], row["plain_us"]))
    for name, (b, t, d, heads, causal) in block_bench.CONFIGS.items():
        _, params, x = block_bench.build(b, t, d, heads, causal, device)
        before = block_kernel.cuda_block_fwd.launches
        first = block_kernel.cuda_block_fwd(x, params, heads, causal=causal)
        second = block_kernel.cuda_block_fwd(x, params, heads, causal=causal)
        torch.cuda.synchronize()
        if block_kernel.cuda_block_fwd.launches != before + 2:
            raise AssertionError("%s: two calls, %d launches counted"
                                 % (name, block_kernel.cuda_block_fwd.launches
                                    - before))
        if not torch.equal(first, second):
            raise AssertionError("%s: a rerun differs" % name)
    for name in BLOCK_TIMED:
        b, t, d, heads, causal = block_bench.CONFIGS[name]
        _, params, x = block_bench.build(b, t, d, heads, causal, device)
        phase_ns = torch.zeros(len(block_kernel.PHASES), dtype=torch.int64,
                               device=device)
        block_kernel.cuda_block_fwd(x, params, heads, causal=causal,
                                    phase_ns=phase_ns)
        torch.cuda.synchronize()
        us = phase_ns.cpu().numpy() / 1e3
        print("K7 at %s by phase (block 0's globaltimer, one launch): %s; "
              "sum %.2f us" % (name, ", ".join(
                  "%s %.2f" % kv for kv in zip(block_kernel.PHASES, us)),
                  us.sum()))
    for hd in sorted({d // heads for _, _, d, heads, _
                      in block_bench.CONFIGS.values()}):
        per_sm, sms, smem = block_kernel.kernel_grid(hd)
        print("K7 grid at head dim %d: %d blocks/SM x %d SMs, %d bytes of "
              "shared memory a block" % (hd, per_sm, sms, smem))
    print("K7 reruns bit-identical at the four shapes, one launch a call; "
          "%d launches in the probe's runs" % launches)
    main = rows[BLOCK_MAIN]
    return launches, dict(
        max_abs_err=max(r["max_abs_err_vs_plain"] for r in rows.values()),
        ms=main["kernel_us"] / 1e3, plain_ms=main["plain_us"] / 1e3,
        bound_ms=main["bound_us"] / 1e3, bound_by=main["bound_by"],
        library_ms=main["library_us"] / 1e3)


# --------------------------------------------------------------------------
# data parallel: K6 (the ranked K2's gradient ring) and P3 (the ring alone)
# --------------------------------------------------------------------------

def ring_cost(n, length):
    """(FLOPs, bytes) of the all-reduce of n buffers of ``length`` floats:
    each rank's n - 1 adds; each input read once, each output written
    once."""
    return float(n * (n - 1) * length), 8.0 * n * length


def dp_epoch_cost(spec, n_steps, local_batch, n_ranks):
    """(FLOPs, bytes) of a ranked whole-epoch launch: the products of a
    global batch of n_ranks x local_batch (as ``epoch_cost``) and the
    ring's adds and scaling; the batches, each rank's losses, and each
    rank's parameters and slots read once and written once."""
    flops, _ = epoch_cost(spec, n_steps, n_ranks * local_batch)
    leaves = sum(d_in * d_out + d_out for d_in, d_out, *_ in spec.layers)
    flops += float(n_steps * n_ranks * n_ranks * leaves)
    n_state = 1 + len(spec.slot_names)
    n_bytes = 4.0 * (n_steps * n_ranks * local_batch
                     * (spec.layers[0][0] + spec.layers[-1][1])
                     + n_ranks * n_steps + n_ranks * 2 * n_state * leaves)
    return flops, n_bytes


def check_ring(device):
    """P3: the ring at the JAX test's shape (8 ranks of [8, 128], arange)
    against the sum (rtol 1e-6) and its plain version bit for bit; at the
    flagship's gradients (186,610 floats) over 2, 3, 4 and 16 ranks against
    its plain version bit for bit; each rerun with one rank held back
    RING_SKEW_US before its arrival, bit-identical. Then at each of those
    rank counts the kernel's, the plain version's and
    torch.stack(xs).sum(0)'s device times, and the main path:
    ``ring_all_reduce`` at the JAX shape and the flagship's 4 ranks,
    counted. Returns the launch counts and the kernels-line numbers
    (flagship shape, 4 ranks)."""
    n, shape = RING_JAX
    x = torch.arange(n * int(np.prod(shape)), dtype=torch.float32,
                     device=device).reshape((n,) + shape)
    jax_xs = list(x.unbind(0))
    n_grad = sum(d_in * d_out + d_out for d_in, d_out in LAYERS)
    gen = torch.Generator().manual_seed(0)
    grad_xs = {r: [(1e-3 * torch.randn(n_grad, generator=gen)).to(device)
                   for _ in range(r)] for r in (2, 3, DP_RANKS, 16)}
    cases = [("JAX's 8 x [8, 128]", jax_xs, 3)] + [
        ("the flagship's %d x [186610]" % r, xs, r // 2)
        for r, xs in grad_xs.items()]
    for what, xs, skew_rank in cases:
        got = ring_allreduce.cuda_ring_all_reduce(xs)
        skewed = ring_allreduce.cuda_ring_all_reduce(
            xs, skew=(skew_rank, RING_SKEW_US))
        torch.cuda.synchronize()
        want = ring_allreduce.ring_all_reduce_reference(xs)
        total = torch.stack(xs).sum(0)
        for r in range(len(xs)):
            if not torch.equal(got[r], want[r]):
                raise AssertionError("%s: rank %d differs from the plain "
                                     "version" % (what, r))
            if not torch.equal(skewed[r], got[r]):
                raise AssertionError("%s: rank %d differs with rank %d held "
                                     "back" % (what, r, skew_rank))
            np.testing.assert_allclose(got[r].cpu().numpy(),
                                       total.cpu().numpy(), rtol=1e-6,
                                       atol=1e-9 * len(xs),
                                       err_msg="%s rank %d" % (what, r))
        spread = max(float((g - got[0]).abs().max()) for g in got)
        print("  %s: bit for bit with the plain version, and with rank %d "
              "held back %.0f us; largest |rank r - rank 0| %.3g, |rank 0 - "
              "torch.stack(xs).sum(0)| %.3g (rtol 1e-6)"
              % (what, skew_rank, RING_SKEW_US, spread,
                 float((got[0] - total).abs().max())))
    main = None
    for r, xs in grad_xs.items():
        # in turns: plain, kernel, kernel, plain
        fns = (lambda: ring_allreduce.ring_all_reduce_reference(xs),
               lambda: ring_allreduce.cuda_ring_all_reduce(xs))
        us = [device_us(fns[i]) for i in (0, 1, 1, 0)]
        kernel_us, plain_us = (us[1] + us[2]) / 2, (us[0] + us[3]) / 2
        lib_us = device_us(lambda: torch.stack(xs).sum(0))
        bound_ms, bound_by = bound(*ring_cost(r, n_grad))
        print("  %d x [%d]: kernel %.2f us (turns %.2f, %.2f), plain %.2f "
              "us, torch.stack(xs).sum(0) %.2f us (device time, CUDA "
              "events, whole calls); bound %.3f us (%s-bound), kernel at "
              "%.1f%% of it, %.2fx the library call's time"
              % (r, n_grad, kernel_us, us[1], us[2], plain_us, lib_us,
                 1e3 * bound_ms, bound_by,
                 100.0 * 1e3 * bound_ms / kernel_us, kernel_us / lib_us))
        if r == DP_RANKS:
            main = dict(max_abs_err=0.0, ms=kernel_us / 1e3,
                        plain_ms=plain_us / 1e3, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib_us / 1e3)
    zero_counts()
    ring_allreduce.ring_all_reduce(jax_xs)
    ring_allreduce.ring_all_reduce(grad_xs[DP_RANKS])
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != only(ring_all_reduce=2):
        raise AssertionError("ring_all_reduce made %s launches" % counts)
    return counts, main


def rank_shards(xb, yb):
    """Each global batch of [n_steps, 128, ...] split into DP_RANKS shards
    of DP_LOCAL rows: [DP_RANKS, n_steps, DP_LOCAL, ...]."""
    def split(t):
        return t.reshape((t.shape[0], DP_RANKS, DP_LOCAL)
                         + tuple(t.shape[2:])).transpose(0, 1).contiguous()

    return split(xb), split(yb)


def k6_state_run(fn, net, opt, spec, xs, ys, t0=0, **kw):
    """One ranked epoch of ``fn`` (the kernel's wrapper or its plain
    version), every rank from fresh copies of the net's weights and zero
    slots: (losses [R, n_steps], each rank's leaves)."""
    states = [fresh_state(net, opt) for _ in range(xs.shape[0])]
    scalars = torch.from_numpy(opt.step_scalars(t0, xs.shape[1])).to(
        xs.device)
    losses = fn(spec, [fused_epoch.dense_leaves(net, p) for p, _ in states],
                [{k: fused_epoch.dense_leaves(net, v) for k, v in s.items()}
                 for _, s in states], xs, ys, scalars, t0=t0, **kw)
    return losses.cpu().numpy(), [[t.cpu().numpy().copy()
                                   for t in leaves_of(*state)]
                                  for state in states]


def hold_k6(what, net, opt, xs, ys):
    """The ranked kernel against its plain version over the batches of xs
    (every rank's losses and state at K2's gates), a rerun and a rerun with
    one rank held back, both bit-identical. Returns the max abs error and
    the kernel's largest |rank r - rank 0| over the state."""
    spec = fused_epoch.epoch_spec(net, opt)
    got, got_state = k6_state_run(fused_epoch.cuda_fused_epoch_ranks, net,
                                  opt, spec, xs, ys)
    want, want_state = k6_state_run(fused_epoch.fused_epoch_reference, net,
                                    opt, spec, xs, ys)
    np.testing.assert_allclose(got, want, err_msg=what + " losses",
                               **LOSS_TOL)
    worst = float(np.max(np.abs(got - want)))
    for r, (ranks_a, ranks_b) in enumerate(zip(got_state, want_state)):
        for i, (a, b) in enumerate(zip(ranks_a, ranks_b)):
            np.testing.assert_allclose(a, b, err_msg="%s rank %d state leaf "
                                       "%d" % (what, r, i), **STATE_TOL)
            worst = max(worst, float(np.max(np.abs(a - b))))
    spread = max(float(np.max(np.abs(a - b))) for state in got_state[1:]
                 for a, b in zip(state, got_state[0]))
    for kw in ({}, {"skew": (1, RING_SKEW_US)}):
        again, again_state = k6_state_run(
            fused_epoch.cuda_fused_epoch_ranks, net, opt, spec, xs, ys, **kw)
        if not (np.array_equal(got, again) and all(
                np.array_equal(a, b) for sa, sb in zip(got_state, again_state)
                for a, b in zip(sa, sb))):
            raise AssertionError("%s: a rerun%s differs" % (
                what, " with rank 1 held back" if kw else ""))
    print("  %s, %d ranks x %d steps of %d rows: max abs err %.3g over every "
          "rank's losses, parameters and slots (tol losses rtol 1e-5 atol "
          "1e-6, state rtol 1e-4 atol 1e-5); reruns bit-identical, also with "
          "rank 1 held back %.0f us a step; largest |rank r - rank 0| %.3g"
          % (what, xs.shape[0], xs.shape[1], xs.shape[2], worst,
             RING_SKEW_US, spread))
    return worst, spread


def check_k6(device, k2_ms):
    """K2 with the K6 exchange on the card: 4 ranks of 32 rows over the 10
    pinned parity steps (seed-1 weights, data seed 5), the flagship and the
    Dropout flagship, against the plain version; one rank through the
    ranked wrapper equal to K2 bit for bit; then at the main path's shape
    (4 ranks x 390 steps of 32) the kernel's and the plain version's ms an
    epoch beside single-rank K2's and the bound, and the kernel's time by
    phase. Returns the max abs error and the kernels-line numbers."""
    with seeder.scope(1):
        net = build_mnist_mlp().to(device)
    with seeder.scope(1):
        drop_net = dropout_flagship(DROPOUT_RATE).to(device)
    opt = Adam(1e-3)
    xb, yb = parity_batches(device, 10)
    xs, ys = rank_shards(xb, yb)
    err, spread = hold_k6("flagship", net, opt, xs, ys)
    drop_err, _ = hold_k6("Dropout flagship", drop_net, opt, *rank_shards(
        *parity_batches(device, 10, K6_DROPOUT_DATA_SEED)))
    spec = fused_epoch.epoch_spec(net, opt)
    one, one_state = k6_state_run(fused_epoch.cuda_fused_epoch_ranks, net,
                                  opt, spec, xb[None], yb[None])
    single, single_state = k2_state_run(fused_epoch.cuda_fused_epoch, net,
                                        opt, spec, xb, yb)
    if not (np.array_equal(one[0], single) and all(
            np.array_equal(a, b) for a, b in zip(one_state[0],
                                                 single_state))):
        raise AssertionError("one rank through the ranked wrapper differs "
                             "from K2")
    print("  one rank of 128 rows through the ranked wrapper: bit for bit "
          "with K2 over the 10 steps")

    (x, y), _ = synthetic_mnist(EPOCH_STEPS * BATCH, 10)
    xg = torch.from_numpy(x).to(device).reshape(EPOCH_STEPS, BATCH, 784)
    yg = torch.from_numpy(one_hot(y)).to(device).reshape(EPOCH_STEPS, BATCH,
                                                          10)
    xe, ye = rank_shards(xg, yg)
    se = torch.from_numpy(opt.step_scalars(0, EPOCH_STEPS)).to(device)
    states = [fresh_state(net, opt) for _ in range(DP_RANKS)]
    params = [fused_epoch.dense_leaves(net, p) for p, _ in states]
    slots = [{k: fused_epoch.dense_leaves(net, v) for k, v in s.items()}
             for _, s in states]

    def kernel(**kw):
        fused_epoch.cuda_fused_epoch_ranks(spec, params, slots, xe, ye, se,
                                           **kw)

    def plain():
        fused_epoch.fused_epoch_reference(spec, params, slots, xe, ye, se)

    kernel()  # warm-up
    p1, k1, k2, p2 = (epoch_ms(plain, 1), epoch_ms(kernel, 3),
                      epoch_ms(kernel, 3), epoch_ms(plain, 1))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    bound_ms, bound_by = bound(*dp_epoch_cost(spec, EPOCH_STEPS, DP_LOCAL,
                                              DP_RANKS))
    print("  a %d-step epoch on %d ranks of %d rows: kernel %.3f ms (%.2f "
          "us/step; turns %.3f, %.3f), plain %.1f ms (turns %.1f, %.1f); "
          "single-rank K2 at batch 128 %.3f ms; bound %.3f ms (%s-bound), "
          "kernel at %.2f%% of it"
          % (EPOCH_STEPS, DP_RANKS, DP_LOCAL, ms, 1e3 * ms / EPOCH_STEPS, k1,
             k2, plain_ms, p1, p2, k2_ms, bound_ms, bound_by,
             100.0 * bound_ms / ms))
    names = fused_epoch.phase_names(spec, DP_RANKS)
    print("  " + plan_line(spec, DP_LOCAL, DP_RANKS))
    phase_ns = torch.zeros(len(names), dtype=torch.int64, device=device)
    kernel(phase_ns=phase_ns)
    per_step = phase_ns.cpu().numpy() / 1e3 / EPOCH_STEPS
    print("  by phase, us/step (rank 0's block 0, barrier wait included): "
          + ", ".join("%s %.2f" % (name, t) for name, t in
                      zip(names, per_step)) + "; sum %.2f" % per_step.sum())
    ring_us = per_step[names.index("ring all-reduce")]
    ring_bound_us = 1e3 * bound(*ring_cost(DP_RANKS, sum(
        d_in * d_out + d_out for d_in, d_out, *_ in spec.layers)))[0]
    print("  the ring phase (the all-rank arrival, every wait between ranks "
          "included, and the pass): %.2f us/step, with the last backward "
          "%.2f, against the all-reduce's bound of %.3f us"
          % (ring_us, ring_us + per_step[names.index("backward 0")],
             ring_bound_us))
    return max(err, drop_err), dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=None)


def dp_model(device, net=None):
    """The flagship (or ``net``) from seed 0, Adam 1e-3, wrapped for DP_RANKS
    ranks that share ``device``."""
    seeder.random_seed(0)
    model = Model(build_mnist_mlp() if net is None else net(),
                  SoftmaxCrossEntropyLoss(), Adam(1e-3), device=device)
    return DataParallel(model, mesh=make_mesh(devices=[device] * DP_RANKS))


def run_dp_slice(device):
    """The data-parallel main path: ``DataParallel(...).train_epochs(
    fused="auto")`` on 4 ranks sharing the card, global batch 128, synthetic
    MNIST 50,000/10,000 (390 steps an epoch): one ranked K2 launch an epoch
    and nothing else; an evaluate_batch after the first epoch (accuracy
    above 0.9; 5 K1 launches), the replica spread, then two more epochs,
    timed. Then, from the same seed, one epoch of the step tier
    (``fused=False``, 14 K1 launches a rank a step) and one epoch of the
    Dropout flagship through K2 with K6. Returns the launch counts of the
    ranked-K2 runs and of the step tier, and the steps/s of both tiers."""
    (train_x, train_y), (test_x, test_y) = synthetic_mnist()
    dp = dp_model(device)
    x_dev, y_dev = dp.stage(train_x, one_hot(train_y))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = dp.train_epoch(x_dev, y_dev, batch_size=BATCH, fused="auto")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    after_epoch = launch_counts()
    acc = dp.model.evaluate_batch(test_x, test_y, AccEvaluator)["accuracy"]
    spread = dp.replica_spread()
    t0 = time.perf_counter()
    more = dp.train_epochs(x_dev, y_dev, 2, batch_size=BATCH, fused="auto")
    torch.cuda.synchronize()
    more_s = time.perf_counter() - t0
    counts = launch_counts()
    n_steps = int(losses.shape[0])
    trace = torch.cat([losses, more.reshape(-1)]).cpu().numpy()
    mega_rate = 2 * n_steps / more_s
    print("  fused='auto' on %d ranks: epoch 1 %d steps in %.4f s; epochs "
          "2-3 %.4f s = %.1f steps/s = %.2f us/step (%.1f steps/s over all "
          "three)" % (DP_RANKS, n_steps, first_s, more_s, mega_rate,
                      1e6 * more_s / (2 * n_steps),
                      3 * n_steps / (first_s + more_s)))
    print("  losses: first %.5f, end of epoch 1 %.5f, end of epoch 3 %.5f; "
          "accuracy after epoch 1 %.4f; largest |rank r - rank 0| over the "
          "parameters after epoch 1 %.3g, after epoch 3 %.3g"
          % (trace[0], trace[n_steps - 1], trace[-1], acc, spread,
             dp.replica_spread()))
    if after_epoch != only(fused_epoch_ring=1):
        raise AssertionError("the first epoch made %s launches" % after_epoch)
    if counts != only(fused_epoch_ring=3, matmul=5):
        raise AssertionError("launch counts %s" % counts)
    if not np.all(np.isfinite(trace)) or not trace[-1] < trace[0]:
        raise AssertionError("losses %s -> %s" % (trace[0], trace[-1]))
    if not acc > 0.9:
        raise AssertionError("test accuracy %.4f <= 0.9" % acc)

    step_dp = dp_model(device)
    xs_dev, ys_dev = step_dp.stage(train_x, one_hot(train_y))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    step_losses = step_dp.train_epoch(xs_dev, ys_dev, batch_size=BATCH)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts = launch_counts()
    step_acc = step_dp.model.evaluate_batch(test_x, test_y,
                                            AccEvaluator)["accuracy"]
    step_rate = n_steps / step_s
    gap = np.abs(step_losses.cpu().numpy() - trace[:n_steps])
    print("  fused=False (the step tier) on %d ranks: %d steps in %.4f s = "
          "%.1f steps/s; accuracy %.4f; its losses against the megakernel "
          "tier's (same weights, same shards): max abs difference %.3g over "
          "steps 0-9, %.3g over all" % (DP_RANKS, n_steps, step_s, step_rate,
                                        step_acc, gap[:10].max(), gap.max()))
    expected = 14 * DP_RANKS * n_steps
    if step_counts != only(matmul=expected):
        raise AssertionError("the step tier made %s launches, expected "
                             "matmul %d" % (step_counts, expected))
    if abs(acc - step_acc) > 0.02:
        raise AssertionError("accuracies %.4f (K2 with K6) and %.4f (step "
                             "tier) differ by more than 0.02"
                             % (acc, step_acc))

    drop_dp = dp_model(device, lambda: dropout_flagship(DROPOUT_RATE))
    xd, yd = drop_dp.stage(train_x, one_hot(train_y))
    torch.cuda.synchronize()
    zero_counts()
    drop_losses = drop_dp.train_epoch(xd, yd, batch_size=BATCH,
                                      fused="auto").cpu().numpy()
    torch.cuda.synchronize()
    drop_counts = launch_counts()
    drop_acc = drop_dp.model.evaluate_batch(test_x, test_y,
                                            AccEvaluator)["accuracy"]
    print("  the Dropout flagship (rate %.1f) on %d ranks, one fused='auto' "
          "epoch: losses %.5f -> %.5f, accuracy %.4f, launches %s"
          % (DROPOUT_RATE, DP_RANKS, drop_losses[0], drop_losses[-1],
             drop_acc, {k: v for k, v in drop_counts.items() if v}))
    if drop_counts != only(fused_epoch_ring=1):
        raise AssertionError("the Dropout epoch made %s launches"
                             % drop_counts)
    if not (np.all(np.isfinite(drop_losses))
            and drop_losses[-1] < drop_losses[0]):
        raise AssertionError("Dropout losses %s -> %s"
                             % (drop_losses[0], drop_losses[-1]))
    ring_counts = {k: counts[k] + drop_counts[k] for k in counts}
    return ring_counts, step_counts, mega_rate, step_rate


def hold_parent_attention(parent):
    """``bench_vs_parent.py --mode same`` against the checkout at
    ``parent``: the three attention kernels at head dims 32, 64 and 128
    (q, k and v sharing one) bit-identical to the parent's on the same
    inputs, with both kernels' times in turns."""
    import bench_vs_parent

    if bench_vs_parent.main(["--parent", parent, "--mode", "same"]) != 0:
        raise AssertionError("the attention kernels at one head dim differ "
                             "from the parent's at %s" % parent)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent",
                        help="a parent checkout (git archive): also hold the "
                             "attention kernels at one head dim bit-identical"
                             " to its")
    parent = parser.parse_args(argv).parent
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
    names = ("matmul", "fused_epoch", "streaming_epoch", "attention",
             "recurrent", "dropout", "mega_probe", "block_fwd",
             "ring_allreduce")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(kernels.build_library, names))
    print("built the %d libraries in %.2f s (one nvcc each, in parallel)"
          % (len(names), time.perf_counter() - t0))
    for path, log in built:
        print("  %s" % path.name)
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print("    ptxas: %s" % line.split("'")[1][-60:])
            elif "registers" in line or "spill" in line:
                print("    ptxas: %s" % line.strip())
    for ranked in (False, True):
        grid = fused_epoch.kernel_grid(ranked)
        print("fused_epoch grid%s: %d clusters of %d blocks of 256 threads "
              "co-resident = %d blocks (%d blocks/SM x %d SMs = %d)"
              % (" (ranked)" if ranked else "", grid.clusters, grid.cluster,
                 grid.clusters * grid.cluster, grid.blocks_per_sm, grid.sms,
                 grid.blocks_per_sm * grid.sms))

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
    k2_err, k2_ms, k2_plain_ms, spec, k2_opt_us = check_fused_epoch(device)
    k2_bound_ms, k2_bound_by = bound(*epoch_cost(spec, EPOCH_STEPS, BATCH))

    phase("dropout pass vs plain")
    p1 = check_dropout(device)

    phase("K2 with Dropout")
    k2d_err, _, loop_counts, k2d_counts = check_k2_dropout(device)

    phase("K2 optimizer sweep")
    sweep_err, sweep_launches, _ = check_sweep(device)

    phase("optimizer probe vs plain")
    probe_counts, p2 = check_mega_probe(device, k2_opt_us)

    phase("stream kernels vs plain")
    stream = check_stream_kernels(device)

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

    phase("data parallel: K6 and P3 vs plain")
    p3_counts, p3 = check_ring(device)
    k6_err, k6 = check_k6(device, k2_ms)
    dp_counts, dp_step_counts, dp_rate, dp_step_rate = run_dp_slice(device)
    print("same call, the flagship at global batch 128: %d ranks through K2 "
          "with K6 %.1f steps/s, the DP step tier %.1f steps/s, single-rank "
          "K2 %.1f steps/s" % (DP_RANKS, dp_rate, dp_step_rate, f_rate))

    phase("deep slice")
    deep_launches, (dmodel, dx, dy, _) = check_deep_slice(device)

    phase("attention kernels vs plain")
    attn = check_attention(device)
    if parent:
        phase("attention kernels vs the parent's")
        hold_parent_attention(parent)

    phase("transformer slice")
    tmodel, tx_dev, ty_dev, t_launches, t_rate = run_transformer_slice(device)
    tape_rate = check_fused_vs_tape(device)
    print("same call, 6b: attn='fused' (the kernels) %.2f steps/s, "
          "attn='tape' %.2f steps/s, fused/tape %.2f"
          % (t_rate, tape_rate, t_rate / tape_rate))

    phase("transformer slice with dropout")
    td_counts, _ = run_transformer_dropout(device)

    phase("Mellum 2 slice")
    run_mellum2_slice(device)

    phase("Moonlight slice")
    run_moonlight_slice(device)

    phase("recurrent kernels vs plain")
    rec = check_recurrent(device)

    phase("recurrent slice")
    rmodel, rx_dev, ry_dev, r_launches, _ = run_rnn_slice(device)

    phase("block forward vs plain")
    block_counts, k7 = check_block(device)

    phase("trace")
    run_trace(smodel, sx, sy)
    run_fused_trace(fmodel, fx, fy)
    run_stream_trace(dmodel, dx, dy)
    run_transformer_trace(tmodel, tx_dev, ty_dev)
    run_rnn_trace(rmodel, rx_dev, ry_dev)

    phase("parity gpu vs cpu")
    run_parity(device)

    print(card)
    print(json.dumps({"kernels": [
        {"name": "matmul", "route": "cuda",
         "source": "tinynn_autograd_tpu_torch/csrc/matmul.cu",
         "replaces": "tinynn_autograd_tpu/ops/kernels.py:122",
         "launches": (f_launches["matmul"] + s_launches["matmul"]
                      + deep_launches["matmul"] + t_launches["matmul"]
                      + r_launches["matmul"] + loop_counts["matmul"]
                      + td_counts["matmul"] + dp_counts["matmul"]
                      + dp_step_counts["matmul"]),
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by,
         "library_ms": k1_plain_ms},
        {"name": "fused_epoch", "route": "cuda",
         "source": "tinynn_autograd_tpu_torch/csrc/fused_epoch.cu",
         "replaces": "tinynn_autograd_tpu/ops/fused_epoch.py:159",
         "launches": (f_launches["fused_epoch"] + s_launches["fused_epoch"]
                      + deep_launches["fused_epoch"]
                      + k2d_counts["fused_epoch"] + sweep_launches),
         "max_abs_err": max(k2_err, k2d_err, sweep_err), "ms": k2_ms,
         "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_ms, "bound_by": k2_bound_by,
         "library_ms": None}] + [
        dict({"name": name, "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/streaming_epoch.cu",
              "replaces": "tinynn_autograd_tpu/ops/streaming_epoch.py:%d"
                          % line,
              "launches": deep_launches[name], "library_ms": None},
             **stream[name])
        for name, line in (("streaming_forward", 151),
                           ("streaming_backward", 192))] + [
        dict({"name": name, "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/attention.cu",
              "replaces": "tinynn_autograd_tpu/ops/attention.py:%d" % line,
              "launches": t_launches[name] + td_counts[name]}, **attn[name])
        for name, line in (("attention_forward", 250),
                           ("attention_backward_dq", 650),
                           ("attention_backward_dkv", 690))] + [
        dict({"name": name, "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/recurrent.cu",
              "replaces": "tinynn_autograd_tpu/ops/recurrent_kernel.py:%d"
                          % line,
              "launches": r_launches[name]},
             **{k: v for k, v in rec[name].items() if k != "port_layer_ms"})
        for name, line in (("lstm_forward", 71), ("lstm_backward", 137),
                           ("gru_forward", 226), ("gru_backward", 288))] + [
        dict({"name": "dropout", "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/dropout.cu",
              "replaces": "tpu_check.py:30",
              "launches": loop_counts["dropout"] + td_counts["dropout"]},
             **p1),
        dict({"name": "mega_probe", "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/mega_probe.cu",
              "replaces": "bench_mega_probe.py:36",
              "launches": probe_counts["mega_probe"]}, **p2),
        dict({"name": "block_forward", "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/block_fwd.cu",
              "replaces": "tinynn_autograd_tpu/ops/block_kernel.py:51",
              "launches": block_counts}, **k7),
        dict({"name": "ring_all_reduce", "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/ring_allreduce.cu",
              "replaces": "tests/test_dp_megakernel.py:60",
              "launches": p3_counts["ring_all_reduce"]}, **p3),
        dict({"name": "fused_epoch_ring", "route": "cuda",
              "source": "tinynn_autograd_tpu_torch/csrc/fused_epoch.cu",
              "replaces": "tinynn_autograd_tpu/ops/fused_epoch.py:114",
              "launches": dp_counts["fused_epoch_ring"],
              "max_abs_err": k6_err}, **k6)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
