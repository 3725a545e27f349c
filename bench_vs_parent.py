#!/usr/bin/env python3
"""The attention kernels (K4's forward, K4b-d's dq and dk/dv) beside an
earlier checkout's, on one CUDA card.

Builds a parent checkout's ``csrc/attention.cu`` in the same process as this
tree's (the C interface is the same) and times the two in turns (this,
parent, parent, this; CUDA events behind a spin, ``device_us``):

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

Commit a9c3485 has the CUDA-core forward (64 x 64 score tiles of 256
threads) and the tensor-core pair of this tree; ec60c57 has CUDA-core
kernels throughout. Unpack the parent into a git-ignored directory and
point --parent there:

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
from tinynn_autograd_tpu_torch.ops import attention, kernels  # noqa: E402
from tinynn_autograd_tpu_torch.utils.timing import device_us  # noqa: E402

SHAPES = ("config6b", "k4b_t512", "k4c_noncausal")


def build_parent(root):
    """The parent checkout's attention library, built into this tree's
    git-ignored build directory and bound as this tree's wrappers bind
    theirs."""
    source = Path(root) / "tinynn_autograd_tpu_torch" / "csrc" / "attention.cu"
    out = kernels.BUILD_DIR / "libtinynn_parent_attention.so"
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    proc = subprocess.run(
        kernels.nvcc_command(kernels._find_nvcc(), source, out),
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed building the parent's attention:\n%s"
                           % proc.stderr)
    lib = ctypes.CDLL(str(out))
    attention._bind(lib, ctypes)
    return lib


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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(smoke.card_line())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        mine = pool.submit(kernels.load_library, "attention", attention._bind)
        parent = pool.submit(build_parent, args.parent)
        libs = {"this": mine.result(), "parent": parent.result()}
    print("built this tree's and the parent's attention in %.2f s (one nvcc "
          "each, in parallel)" % (time.perf_counter() - t0))
    bench_forward(libs, device)
    bench_pair(libs, device)
    bench_6b(libs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
