#!/usr/bin/env python3
"""This tree's kernels beside an earlier checkout's, on one CUDA card.

Builds a parent checkout's kernel source in the same process as this
tree's, binds it as its wrapper bound it, and times the two in turns
(this, parent, parent, this; CUDA events).

``--mode k2`` (the default): the whole-epoch kernel (K2; with ranks K6 in
it), against a parent whose ``csrc/fused_epoch.cu`` has the interface of
commit 2c17618 (one block a 32x32 tile, no plan; a shim hands it this
tree's call):

- single-rank K2, a 390-step epoch of the flagship (784-200-100-70-30-10,
  batch 128, Adam 1e-3, pinned seed-1 weights), and K2 with K6 on 4 ranks
  of 32 rows, each by CUDA events in turns (this, parent, parent, this,
  this, parent), then each by phase (block 0's clock, ``phase_ns``), and
  the plan this tree launches;
- the flagship's ``Model.train_epoch(fused="auto")`` steps/s with each
  library, by the host's clock in turns.

``--mode attention``: the attention kernels (K4's forward, K4b-d's dq and
dk/dv) against a parent's ``csrc/attention.cu`` (the same C interface):

- the forward at config 6b's shape (B 4, H 8, T 2048, d 64, causal), the
  TPU's K4b shape (T 512, causal) and its K4c shape (T 2048, non-causal),
  each held to the plain version at the attention gate (rtol 1e-4, atol
  1e-5), beside SDPA's forward (device time the same way) and the
  forward's bounds (3xTF32 on the tensor cores; f32 FMA);
- the pair (dq + dk/dv) at the same shapes, each kernel held to the plain
  version at the attention gate (rtol 1e-4, atol 1e-4 of the largest plain
  value), beside SDPA's whole backward and the pair's bounds;
- config 6b's training through ``Model.train_epoch`` (64 steps of batch 4,
  the attention kernels twice a step each) with this tree's attention
  library and the parent's, steps/s by the host's clock.

``--mode same``: the three attention kernels where q, k and v share one
head dim (``SAME_SHAPES``: d = 32, 64 and 128, the last at Mellum 2's two
layer kinds), this tree's and the parent's on the same inputs: every
output bit-identical (``torch.equal``), and each kernel's time in turns
(this, parent, parent, this). Exits 1 where an output differs.

``--mode dkv`` and ``--mode dq``: the dk/dv or the dq kernel alone at
Mellum 2's two layer kinds (``chip_smoke.ATTN_BWD_TIMED``: 32:4 GQA of
head dim 128 over 4 x 8,192 tokens, banded to 1,024 keys and full), and
dk/dv also at Moonlight's split head dims (``chip_smoke.ATTN_SPLIT_TIMED``:
16 heads of 192/128 over 2 x 8,192 causal tokens), in turns (this,
parent, parent, this, this, parent), beside its bound and the largest
difference of its outputs from the parent's. lse and delta come from this
tree's forward.

The parent's kernel is the one that parent launches: its entry points get
the design its own ``dq_design`` and ``dkv_design`` choose (read from its
``ops/attention.py``), and a parent whose dq or dk/dv entry point has no
design argument (a tree before them; read from its source) gets none. Nor
need the parent's entry points take v's head dim apart (``int dv``, a tree
before the split head dims): its calls then leave it out.

Commit a9c3485 has the CUDA-core forward (64 x 64 score tiles of 256
threads) and the tensor-core pair of this tree; ec60c57 has CUDA-core
kernels throughout. Unpack the parent into a git-ignored directory and
point --parent there:

    mkdir -p _parent && git archive <commit> | tar -x -C _parent
    python3 bench_vs_parent.py --parent _parent   # K2, ~1 min
    python3 bench_vs_parent.py --parent _parent --mode attention  # ~2 min
    python3 bench_vs_parent.py --parent _parent --mode dkv  # ~1 min
    python3 bench_vs_parent.py --parent _parent --mode dq  # ~1 min
    python3 bench_vs_parent.py --parent _parent --mode same  # ~1 min

Without a CUDA device it exits 1.
"""

import argparse
import ctypes
import functools
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
from tinynn_autograd_tpu_torch.ops import attention, fused_epoch, kernels  # noqa: E402
from tinynn_autograd_tpu_torch.utils import seeder  # noqa: E402
from tinynn_autograd_tpu_torch.utils.datasets import one_hot, synthetic_mnist  # noqa: E402
from tinynn_autograd_tpu_torch.utils.timing import device_us  # noqa: E402

SHAPES = ("config6b", "k4b_t512", "k4c_noncausal")
# one head dim for q, k and v: d = 32 (config 6), 64 (6b, GQA, dropout) and
# 128 (GQA with dropout, Mellum 2's banded and full layers)
SAME_SHAPES = ("config6", "config6b", "gqa_8q_2kv", "dropout",
               "d128_gqa_dropout", "mellum2_sliding", "mellum2_full")
# the C entry points' pointer arguments, before b, h, hkv, tq, tk, d, dv
ENTRY_POINTERS = {"tinynn_attention_forward": 5,
                  "tinynn_attention_backward_dq": 7,
                  "tinynn_attention_backward_dkv": 8}


def build_parent(root, name, bind):
    """The parent checkout's ``csrc/<name>.cu``, built into this tree's
    git-ignored build directory and bound by ``bind(lib, ctypes)`` (what
    ``bind`` returns, if anything, stands for the library)."""
    source = Path(root) / "tinynn_autograd_tpu_torch" / "csrc" / (
        "%s.cu" % name)
    out = kernels.BUILD_DIR / ("libtinynn_parent_%s.so" % name)
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    proc = subprocess.run(
        kernels.nvcc_command(kernels._find_nvcc(), source, out),
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed building the parent's %s:\n%s"
                           % (name, proc.stderr))
    lib = ctypes.CDLL(str(out))
    return bind(lib, ctypes) or lib


def bind_parent_k2(lib, ctypes):
    """The C interface of 2c17618's fused_epoch.cu."""
    ptr, i32, u32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_float, ctypes.c_longlong)
    lib.tinynn_fused_epoch.argtypes = (
        [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(u32),
         ctypes.POINTER(f32), ctypes.POINTER(ptr)] + [ptr] * 8
        + [i32, ptr, i64, i64, ptr] + [i32, i32, u32, i32] + [f32] * 6
        + [i32, i32, i64, ptr, ptr])
    lib.tinynn_fused_epoch.restype = i32
    lib.tinynn_fused_epoch_grid.argtypes = [ctypes.POINTER(i32)] * 2
    lib.tinynn_fused_epoch_grid.restype = i32
    lib.tinynn_fused_epoch_table_bytes.argtypes = []
    lib.tinynn_fused_epoch_table_bytes.restype = i64


class ParentFusedEpoch:
    """The parent's K2 behind this tree's wrapper: it takes the call
    ``ops/fused_epoch.py`` makes and gives the parent's kernel the
    arguments it took: four dims and 12 pointers a layer (no row pitch, no
    weight copy wp; the parent reads the first batch x dout floats of each
    padded activation buffer as its own [batch, dout] rows), a row-loss
    scratch and a partial-sum scratch of its own grid, and no plan. The
    grid query is this tree's (the wrapper plans with it); the table's size
    is the parent's."""

    def __init__(self, lib, mine):
        self.lib = lib
        self.tinynn_fused_epoch_grid = mine.tinynn_fused_epoch_grid
        self.tinynn_fused_epoch_table_bytes = \
            lib.tinynn_fused_epoch_table_bytes

    def tinynn_fused_epoch(self, n_ranks, blocks, n_layers, dims, plan, drops,
                           scales, ptrs, tables, xb, x_pitch, yb, cw,
                           scalars, losses, partial, partial_len, grads,
                           n_grad, grad_stride, sync, batch, *rest):
        dims4 = [dims[5 * l + i] for l in range(n_layers) for i in range(4)]
        if x_pitch != dims4[0]:
            raise ValueError("the parent takes unpadded inputs")
        ptrs12 = [ptrs[13 * j + i] for j in range(len(ptrs) // 13)
                  for i in range(12)]
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        self.lib.tinynn_fused_epoch_grid(ctypes.byref(per_sm),
                                         ctypes.byref(sms))
        row_loss = torch.empty((n_ranks, batch), device="cuda")
        own_partial = torch.empty(per_sm.value * sms.value, device="cuda")
        # the scratch stays alive until the launch is queued; later work on
        # the stream may reuse it
        return self.lib.tinynn_fused_epoch(
            n_ranks, n_layers, (ctypes.c_int * len(dims4))(*dims4), drops,
            scales, (ctypes.c_void_p * len(ptrs12))(*ptrs12), tables, xb, yb,
            cw, scalars, losses, row_loss.data_ptr(), own_partial.data_ptr(),
            own_partial.numel(), grads, n_grad, grad_stride, sync, batch,
            *rest)


class parent_k2:
    """Within it, ``fused_epoch``'s wrappers launch the parent's K2."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        fused_epoch.kernel_grid()  # this tree's library, loaded
        self.saved = kernels._loaded["fused_epoch"]
        kernels._loaded["fused_epoch"] = ParentFusedEpoch(self.lib,
                                                          self.saved)

    def __exit__(self, *exc):
        kernels._loaded["fused_epoch"] = self.saved


def entries_without(root, argument, names):
    """The entry points ``names`` of a parent's ``csrc/attention.cu`` whose
    parameters do not include ``argument``."""
    source = (Path(root) / "tinynn_autograd_tpu_torch" / "csrc"
              / "attention.cu").read_text()
    return [name for name in names if argument not in source.split(
        'extern "C" int %s(' % name)[1].split(")")[0]]


def parent_designs(root):
    """The parent's design functions (``dq_design``, ``dkv_design``) by
    entry point, from its ``ops/attention.py``; None where it has none."""
    import importlib.util

    path = Path(root) / "tinynn_autograd_tpu_torch" / "ops" / "attention.py"
    spec = importlib.util.spec_from_file_location("parent_attention", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return {name: getattr(module, fn, None) for name, fn in (
        ("tinynn_attention_backward_dq", "dq_design"),
        ("tinynn_attention_backward_dkv", "dkv_design"))}


def bind_parent_attention(lib, ctypes, root):
    """The C interface of a parent's ``csrc/attention.cu``: this tree's,
    less the design argument of the entry points that take none (a tree
    before ``dq_design`` or ``dkv_design``) and v's head dim of those that
    take none (a tree before the split head dims)."""
    attention._bind(lib, ctypes)
    undesigned = entries_without(root, "int wgmma",
                                 list(ENTRY_POINTERS)[1:])
    one_dim = entries_without(root, "int dv,", list(ENTRY_POINTERS))
    designs = {name: fn for name, fn in parent_designs(root).items()
               if name not in undesigned and fn is not None}
    for name in ENTRY_POINTERS:
        fn = getattr(lib, name)
        types = list(fn.argtypes)
        if name in undesigned:
            del types[-2]
        if name in one_dim:
            del types[ENTRY_POINTERS[name] + 6]
        fn.argtypes = types
    return ParentAttention(lib, undesigned, one_dim, designs)


class ParentAttention:
    """Such a parent's library behind this tree's wrappers: their calls of
    the entry points in ``designs`` with the design the parent's own design
    function picks, of those in ``undesigned`` without the design argument
    (the kernel is the one that parent launches at that head dim), and of
    those in ``one_dim`` without v's head dim (the wrappers' calls there
    have d_v == d_qk)."""

    def __init__(self, lib, undesigned, one_dim, designs):
        self.lib = lib
        self.undesigned = undesigned
        self.one_dim = one_dim
        self.designs = designs

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in self.undesigned and name not in self.one_dim \
                and name not in self.designs:
            return fn

        def call(*args):
            args = list(args)
            d, dv = args[ENTRY_POINTERS[name] + 5:ENTRY_POINTERS[name] + 7]
            if name in self.designs:
                design = self.designs[name]
                args[-2] = int((design(d) if d == dv else design(d, dv))
                               == "wgmma")
            if name in self.undesigned:
                del args[-2]
            if name in self.one_dim:
                at = ENTRY_POINTERS[name] + 6
                if args[at] != args[at - 1]:
                    raise ValueError("the parent's %s takes one head dim"
                                     % name)
                del args[at]
            return fn(*args)

        return call


class uses:
    """Within it, the attention wrappers launch ``lib``'s kernels."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = kernels._loaded.get("attention")
        kernels._loaded["attention"] = self.lib

    def __exit__(self, *exc):
        kernels._loaded["attention"] = self.saved


def forward_fn(lib, q, k, v, kw):
    def run():
        with uses(lib):
            return attention.cuda_attention_forward(q, k, v, **kw)
    return run


def pair_fn(lib, bwd, kw):
    def run():
        with uses(lib):
            dq = attention.cuda_attention_backward_dq(*bwd, **kw)
            dk, dv = attention.cuda_attention_backward_dkv(*bwd, **kw)
        return dq, dk, dv
    return run


def in_turns(mine, parents):
    """(mine's mean, the parent's mean) of ``device_us``, in turns mine,
    parent's, parent's, mine."""
    t = [device_us(f, reps=20) for f in (mine, parents, parents, mine)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def bench_forward(libs, device):
    print("== the forward (K4), device us a launch: this tree's and the "
          "parent's in turns")
    import torch.nn.functional as F

    for name in SHAPES:
        q, k, v, _, kw = smoke.attn_inputs(device, name)
        want = attention.attention_forward_reference(q, k, v, **kw)
        mine, parents = (forward_fn(libs[w], q, k, v, kw)
                         for w in ("this", "parent"))
        for who, fn in (("this tree's", mine), ("the parent's", parents)):
            errs = []
            for what, a, b in zip(("o", "lse"), fn(), want):
                np.testing.assert_allclose(
                    a.cpu().numpy(), b.cpu().numpy(),
                    err_msg="%s %s %s" % (name, who, what), **smoke.ATTN_TOL)
                errs.append(float((a - b).abs().max()))
            print("  %s %s: max abs err against the plain version o %.3g, "
                  "lse %.3g" % (name, who, *errs))
        this_us, parent_us, turns = in_turns(mine, parents)

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=kw["causal"], scale=kw["scale"])

        sdpa_us = device_us(sdpa, reps=20)
        costs = smoke.attention_costs(name)["attention_forward"]
        fma_ms, _ = smoke.bound(*costs)
        tc_ms, tc_by = smoke.bound_3xtf32(*costs)
        print("%s: the forward %.1f us (turns %.1f, %.1f), the parent's "
              "%.1f us (turns %.1f, %.1f): %.2fx faster; SDPA's forward "
              "%.1f us (this tree's at %.3fx its time); the bound %.1f us "
              "at 3xTF32 (%s-bound; this tree's at %.2f%%, the parent's at "
              "%.2f%%), %.1f us at f32 FMA (this tree's at %.2f%%, the "
              "parent's at %.2f%%)"
              % (name, this_us, turns[0], turns[3], parent_us, turns[1],
                 turns[2], parent_us / this_us, sdpa_us, this_us / sdpa_us,
                 1e3 * tc_ms, tc_by, 1e5 * tc_ms / this_us,
                 1e5 * tc_ms / parent_us, 1e3 * fma_ms,
                 1e5 * fma_ms / this_us, 1e5 * fma_ms / parent_us))
        del want
        torch.cuda.empty_cache()


def bench_pair(libs, device):
    print("== the backward pair (dq + dk/dv), device us a pair: this tree's "
          "and the parent's in turns")
    for name in SHAPES:
        q, k, v, do, kw = smoke.attn_inputs(device, name)
        o, lse = attention.attention_forward_reference(q, k, v, **kw)
        delta = (do * o).sum(dim=-1)
        bwd = (q, k, v, do, lse, delta)
        want = attention.attention_backward_reference(*bwd, **kw)
        mine, parents = (pair_fn(libs[w], bwd, kw) for w in ("this", "parent"))
        for who, fn in (("this tree's", mine), ("the parent's", parents)):
            errs = [smoke.hold_grad("%s %s %s" % (name, who, what), a, b)
                    for what, a, b in zip(("dq", "dk", "dv"), fn(), want)]
            print("  %s %s: max abs err against the plain version dq %.3g, "
                  "dk %.3g, dv %.3g" % (name, who, *errs))
        this_us, parent_us, turns = in_turns(mine, parents)
        costs = smoke.attention_costs(name)
        fma_ms, _ = smoke.bound(*costs["backward"])
        tc_ms, tc_by = smoke.bound_3xtf32(*costs["backward"])
        _, sdpa_bwd, _, _ = smoke.sdpa_times(q, k, v, do, kw)
        print("%s: the pair %.1f us (turns %.1f, %.1f), the parent's %.1f us "
              "(turns %.1f, %.1f): %.2fx faster; SDPA's whole backward "
              "%.1f us; the VJP's bound %.1f us at 3xTF32 (%s-bound; the "
              "pair at %.2f%%, the parent's at %.2f%%), %.1f us at f32 FMA "
              "(the pair at %.2f%%, the parent's at %.2f%%)"
              % (name, this_us, turns[0], turns[3], parent_us, turns[1],
                 turns[2], parent_us / this_us, 1e3 * sdpa_bwd, 1e3 * tc_ms,
                 tc_by, 1e5 * tc_ms / this_us, 1e5 * tc_ms / parent_us,
                 1e3 * fma_ms, 1e5 * fma_ms / this_us,
                 1e5 * fma_ms / parent_us))
        del bwd, want
        torch.cuda.empty_cache()


def bench_backward_kernel(libs, device, kernel):
    """``kernel`` ("dq" or "dkv") alone at Mellum 2's shapes, and dk/dv at
    Moonlight's, this tree's and the parent's in turns."""
    fn, outs = {"dq": (attention.cuda_attention_backward_dq, ("dq",)),
                "dkv": (attention.cuda_attention_backward_dkv,
                        ("dk", "dv"))}[kernel]
    shapes = smoke.ATTN_BWD_TIMED + (
        smoke.ATTN_SPLIT_TIMED if kernel == "dkv" else ())
    print("== the %s kernel alone at %s, device us a launch: this tree's "
          "and the parent's in turns"
          % ("/".join(outs), ", ".join("%s %s" % (name, smoke.ATTN_SHAPES[
              name]) for name in shapes)))
    for name in shapes:
        q, k, v, do, kw = smoke.attn_inputs(device, name)
        o, lse = attention.cuda_attention_forward(q, k, v, **kw)
        bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
        del o

        def launch(lib):
            def run():
                with uses(lib):
                    return fn(*bwd, **kw)
            return run

        mine, parents = launch(libs["this"]), launch(libs["parent"])
        got, want = mine(), parents()
        if kernel == "dq":
            got, want = (got,), (want,)
        diffs = [float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(got, want)]
        del got, want
        t = [device_us(f, reps=5) for f in (mine, parents, parents, mine,
                                            mine, parents)]
        this_us = (t[0] + t[3] + t[4]) / 3
        parent_us = (t[1] + t[2] + t[5]) / 3
        bound_ms, bound_by = smoke.bound_3xtf32(*smoke.attention_costs(name)[
            "attention_backward_" + kernel])
        print("%s: this tree's %.1f us (turns %s), the parent's %.1f us "
              "(turns %s): %.2fx faster; bound %.1f us (%s-bound), this "
              "tree's at %.2f%%, the parent's at %.2f%%; max |this - "
              "parent| over max |parent|: %s"
              % (name, this_us, ", ".join("%.1f" % t[i] for i in (0, 3, 4)),
                 parent_us, ", ".join("%.1f" % t[i] for i in (1, 2, 5)),
                 parent_us / this_us, 1e3 * bound_ms, bound_by,
                 1e5 * bound_ms / this_us, 1e5 * bound_ms / parent_us,
                 ", ".join("%s %.2e" % x for x in zip(outs, diffs))))
        del bwd
        torch.cuda.empty_cache()


def bench_same(libs, device):
    """The three kernels at ``SAME_SHAPES``, this tree's and the parent's
    on the same inputs: outputs bit-identical, times in turns. Returns
    whether every output agreed."""
    print("== the attention kernels where q, k and v share one head dim: "
          "this tree's and the parent's on the same inputs, device us a "
          "launch in turns")
    same = True
    for name in SAME_SHAPES:
        q, k, v, do, kw = smoke.attn_inputs(device, name)
        o, lse = attention.cuda_attention_forward(q, k, v, **kw)
        bwd = (q, k, v, do, lse, (do * o).sum(dim=-1))
        del o
        fns = {"forward": lambda: attention.cuda_attention_forward(
                   q, k, v, **kw),
               "dq": lambda: (attention.cuda_attention_backward_dq(
                   *bwd, **kw),),
               "dkv": lambda: attention.cuda_attention_backward_dkv(
                   *bwd, **kw)}
        parts = []
        for kernel, fn in fns.items():
            def launch(lib, fn=fn):
                def run():
                    with uses(lib):
                        return fn()
                return run

            mine, parents = launch(libs["this"]), launch(libs["parent"])
            equal = all(torch.equal(a, b) for a, b in zip(mine(), parents()))
            same &= equal
            reps = 5 if name.startswith("mellum2") else 20
            t = [device_us(f, reps=reps) for f in (mine, parents, parents,
                                                   mine)]
            parts.append("%s %s, %.1f / %.1f us (turns %s)"
                         % (kernel, "bit-identical" if equal else "DIFFER",
                            (t[0] + t[3]) / 2, (t[1] + t[2]) / 2,
                            ", ".join("%.1f" % x for x in t)))
        print("%s %s: %s" % (name, smoke.ATTN_SHAPES[name], "; ".join(parts)),
              flush=True)
        del bwd
        torch.cuda.empty_cache()
    print("every output bit-identical to the parent's: %s" % same)
    return same


def by_phase(what, names, run, device, n_steps):
    phase_ns = torch.zeros(len(names), dtype=torch.int64, device=device)
    run(phase_ns=phase_ns)
    per_step = phase_ns.cpu().numpy() / 1e3 / n_steps
    print("  %s by phase, us/step: " % what
          + ", ".join("%s %.2f" % (name, t) for name, t in
                      zip(names, per_step))
          + "; sum %.2f" % per_step.sum())


def bench_epochs(lib, device):
    steps = smoke.EPOCH_STEPS
    print("== single-rank K2 and K2 with K6 (%d ranks of %d rows): a %d-step "
          "epoch of the flagship, this tree's kernel and the parent's in "
          "turns" % (smoke.DP_RANKS, smoke.DP_LOCAL, steps))
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

    def single(**kw):
        fused_epoch.cuda_fused_epoch(spec, *pairs, xg, yg, se, **kw)

    def ranked(**kw):
        fused_epoch.cuda_fused_epoch_ranks(spec, params, slots, xe, ye, se,
                                           **kw)

    def parents(fn):
        def run(**kw):
            with parent_k2(lib):
                fn(**kw)
        return run

    for what, fn, n_ranks, batch in (
            ("single-rank K2", single, 1, smoke.BATCH),
            ("K2 with K6", ranked, smoke.DP_RANKS, smoke.DP_LOCAL)):
        fn()  # warm-up
        parents(fn)()
        # in turns: mine, parent's, parent's, mine, mine, parent's
        t = [smoke.epoch_ms(f, 3) for f in (fn, parents(fn), parents(fn),
                                            fn, fn, parents(fn))]
        mine, theirs = [t[i] for i in (0, 3, 4)], [t[i] for i in (1, 2, 5)]
        print("%s: this tree's %.3f ms (%.2f us/step; turns %s), the "
              "parent's %.3f ms (%.2f us/step; turns %s): %.2fx faster"
              % (what, np.mean(mine), 1e3 * np.mean(mine) / steps,
                 ", ".join("%.3f" % v for v in mine), np.mean(theirs),
                 1e3 * np.mean(theirs) / steps,
                 ", ".join("%.3f" % v for v in theirs),
                 np.mean(theirs) / np.mean(mine)))
        print("  " + smoke.plan_line(spec, batch, n_ranks))
        names = fused_epoch.phase_names(spec, n_ranks)
        for side, run in (("this tree's", fn), ("the parent's", parents(fn))):
            by_phase("%s, %s" % (what, side), names, run, device, steps)


def bench_train_epoch(lib, device):
    print("== the flagship's Model.train_epoch(fused='auto'): this tree's "
          "K2 and the parent's in turns (the host's clock)")
    seeder.random_seed(0)
    (train_x, train_y), _ = synthetic_mnist()
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3),
                  device=device)
    x_dev, y_dev = model.stage(train_x, one_hot(train_y))
    steps = len(train_x) // smoke.BATCH

    def mine():
        model.train_epoch(x_dev, y_dev, batch_size=smoke.BATCH)

    def parents():
        with parent_k2(lib):
            mine()

    mine()  # warm-up
    parents()
    # in turns: mine, parent's, parent's, mine, mine, parent's
    t = [wall_s(f, 1) for f in (mine, parents, parents, mine, mine,
                                parents)]
    this_t, parent_t = [t[i] for i in (0, 3, 4)], [t[i] for i in (1, 2, 5)]
    print("train_epoch: this tree's %.1f steps/s (turns %s), the parent's "
          "%.1f steps/s (turns %s)"
          % (steps / np.mean(this_t),
             ", ".join("%.1f" % (steps / x) for x in this_t),
             steps / np.mean(parent_t),
             ", ".join("%.1f" % (steps / x) for x in parent_t)))


def wall_s(fn, reps):
    """Seconds a call of ``fn``, by the host's clock over ``reps`` calls
    between two ``torch.cuda.synchronize``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def bench_6b(libs, device):
    print("== config 6b's training (Model.train_epoch, batch 4, T 2048): "
          "this tree's attention library and the parent's in turns")
    tx, ty, _, _ = smoke.transformer_data()
    model = smoke.transformer_model(device, 0)
    x_dev, y_dev = model.stage(tx, ty)
    steps = len(tx) // smoke.T_BATCH

    def epoch(lib):
        def run():
            with uses(lib):
                model.train_epoch(x_dev, y_dev, batch_size=smoke.T_BATCH)
        return run

    mine, parents = epoch(libs["this"]), epoch(libs["parent"])
    mine()  # warm-up
    parents()
    # in turns: mine, parent's, parent's, mine, mine, parent's
    t = [wall_s(f, 1) for f in (mine, parents, parents, mine, mine,
                                parents)]
    this_t, parent_t = [t[i] for i in (0, 3, 4)], [t[i] for i in (1, 2, 5)]
    print("6b: this tree's %.2f steps/s (turns %s), the parent's %.2f steps/s "
          "(turns %s); %.3f ms a step saved"
          % (steps / np.mean(this_t),
             ", ".join("%.2f" % (steps / x) for x in this_t),
             steps / np.mean(parent_t),
             ", ".join("%.2f" % (steps / x) for x in parent_t),
             1e3 * (np.mean(parent_t) - np.mean(this_t)) / steps))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the parent checkout (git archive)")
    parser.add_argument("--mode",
                        choices=("k2", "attention", "dkv", "dq", "same"),
                        default="k2",
                        help="the kernel to compare (default k2)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(smoke.card_line())
    name, bind = (("fused_epoch", fused_epoch._bind) if args.mode == "k2"
                  else ("attention", attention._bind))
    parent_bind = (bind_parent_k2 if args.mode == "k2" else
                   functools.partial(bind_parent_attention, root=args.parent))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        mine = pool.submit(kernels.load_library, name, bind)
        parent = pool.submit(build_parent, args.parent, name, parent_bind)
        libs = {"this": mine.result(), "parent": parent.result()}
    print("built this tree's and the parent's %s in %.2f s (one nvcc each, "
          "in parallel)" % (name, time.perf_counter() - t0))
    if args.mode == "k2":
        bench_epochs(libs["parent"], device)
        bench_train_epoch(libs["parent"], device)
    elif args.mode in ("dkv", "dq"):
        bench_backward_kernel(libs, device, args.mode)
    elif args.mode == "same":
        return 0 if bench_same(libs, device) else 1
    else:
        bench_forward(libs, device)
        bench_pair(libs, device)
        bench_6b(libs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
