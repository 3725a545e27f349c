"""The optimizer-only megakernel probe on the card (the PyTorch package's
counterpart of bench_mega_probe.py, P2).

One cooperative launch of N_STEPS steps (csrc/mega_probe.cu), each applying
only the optimizer's per-leaf update to the flagship MLP's 10 leaves with a
fake gradient g = 1e-3 p, then one grid barrier: K2's structure with its
optimizer phase alone. The differences between optimizers isolate the slot
math and traffic; SGD's time is the cost of the structure itself.

For sgd, momentum, rmsprop and adam (bench_mega_probe.py's table): params
randn * 0.05 from numpy seed 0, zero slots, t0 = 1; a warm-up launch, then
the median of REPEATS timed launches (CUDA events), each from the same start.
Prints one JSON line per optimizer (its us/step, its bytes bound a step) and
then ``mega_opt_<name>_us_per_step`` and ``mega_opt_<name>_delta_vs_sgd_us``
as JSON lines. Writes no file.

Run on the card:  python bench_mega_probe_torch.py
(--device cpu runs the plain version at --steps steps, to rehearse the
script; its times are the CPU's, not a device metric.)
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch.nn import optimizer as opt  # noqa: E402
from tinynn_autograd_tpu_torch.ops import mega_probe  # noqa: E402

REPEATS = 3
N_STEPS = 20000
PEAK_BYTES = 3.35e12  # the H100 SXM's HBM3 rate (NVIDIA data sheet)
PROBES = [("sgd", lambda: opt.SGD(1e-2)),
          ("momentum", lambda: opt.Momentum(1e-2)),
          ("rmsprop", lambda: opt.RMSProp(1e-3)),
          ("adam", lambda: opt.Adam(1e-3))]


def start_state(optimizer, device):
    rng = np.random.RandomState(0)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.05).to(
        device) for s in mega_probe.LEAF_SHAPES]
    return params, {n: [torch.zeros_like(p) for p in params]
                    for n in optimizer.slot_names}


def bytes_per_step(optimizer):
    """Each parameter and each of its slots read and written once a step."""
    n = sum(int(np.prod(s)) for s in mega_probe.LEAF_SHAPES)
    return 2 * 4 * n * (1 + len(optimizer.slot_names))


def time_probe(optimizer, device, n_steps, repeats):
    """Median us/step of ``repeats`` runs from the same start, after a
    warm-up run."""
    run = (mega_probe.cuda_mega_probe if device.type == "cuda"
           else mega_probe.mega_probe_reference)
    params, slots = start_state(optimizer, device)
    run(optimizer, params, slots, 1, n_steps)  # build, load, warm up
    times = []
    for _ in range(repeats):
        params, slots = start_state(optimizer, device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run(optimizer, params, slots, 1, n_steps)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            run(optimizer, params, slots, 1, n_steps)
            ms = 1e3 * (time.perf_counter() - t0)
        times.append(1e3 * ms / n_steps)
    return statistics.median(times)


def main(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": device.type, "card": card,
                      "n_steps": args.steps, "repeats": args.repeats}),
          flush=True)
    out = {}
    for name, make in PROBES:
        optimizer = make()
        us = time_probe(optimizer, device, args.steps, args.repeats)
        n_bytes = bytes_per_step(optimizer)
        out["mega_opt_%s_us_per_step" % name] = us
        print(json.dumps({"probe": name, "us_per_step": us,
                          "bytes_per_step": n_bytes,
                          "bound_us_per_step": 1e6 * n_bytes / PEAK_BYTES}),
              flush=True)
    base = out["mega_opt_sgd_us_per_step"]
    for name in ("momentum", "rmsprop", "adam"):
        out["mega_opt_%s_delta_vs_sgd_us" % name] = (
            out["mega_opt_%s_us_per_step" % name] - base)
    for key, value in out.items():
        print(json.dumps({key: value}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--steps", default=N_STEPS, type=int)
    parser.add_argument("--repeats", default=REPEATS, type=int)
    main(parser.parse_args())
