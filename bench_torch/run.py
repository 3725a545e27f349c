"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cell's CUDA
devices. Set-up (imports, the kernels' build or load, data and weights
made on the device from the seed, the check's first steps, one warm unit
of the cell's own shapes) is timed as ``setup_s``; then the cell's traffic
runs for ``--seconds``. With ``--trace 1`` a fixed stretch of the same
traffic runs under the profiler after the window, and the line carries
the per-layer metrics, the device's busy and window seconds and the
breakdown. After the window the program is freed and the plain reference
follows the check's steps; each number compared is printed beside its
limit on standard error, and under "checks", last, in the result line,
which is the last line of standard output.

Exits 2, printing no result, without enough CUDA devices, 3 where the
checkout lacks the program, and 4 where, once the window has closed, the
process holds JAX, its libraries or the JAX package (``FORBIDDEN``, by
whole top-level names).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "tinynn_autograd_tpu_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tinynn_autograd_tpu"})


def forbidden_modules():
    """The top-level names in ``sys.modules`` that ``FORBIDDEN`` lists."""
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & FORBIDDEN)


def power_limit():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    # kernel caches of the program at fixed paths inside the checkout, so
    # that only a checkout's first run builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    from harness import manifest

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("no result: %s needs %d CUDA device(s), this machine has %d"
              % (args.workload, cell["chips"],
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 2
    if not (ROOT / PROGRAM / "__init__.py").exists():
        print("no result: the checkout at %s holds no %s package"
              % (ROOT, PROGRAM), file=sys.stderr)
        return 3

    from harness import runner

    result = runner.run(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print("no result: the process holds %s" % ", ".join(found),
              file=sys.stderr)
        return 4
    if args.trace:
        result["device"]["power_limit_w"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print("check %s %.6g limit %.6g" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
