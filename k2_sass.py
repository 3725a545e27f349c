#!/usr/bin/env python3
"""How the whole-epoch kernel (K2) feeds its products, read from its SASS.

Builds ``csrc/fused_epoch.cu`` (this tree's, or with ``--parent DIR`` also
an older checkout's) with nvcc, disassembles it with ``cuobjdump -sass``
and, in each stretch of the one-rank kernel between two block barriers
(``BAR.SYNC``), counts the global loads into registers (``LDG``), the
asynchronous copies to shared memory (``LDGSTS``, cp.async) and the loads
whose register is stored to shared memory (``STS``) before the next load
is issued: each of those waits for its load's round trip before the next
load starts, so a stretch with n of them costs n round trips. Prints the
stretches with the most such serial loads.

    python3 k2_sass.py                   # this tree's kernel
    python3 k2_sass.py --parent _parent  # and an older checkout's

Needs nvcc and cuobjdump (the CUDA toolkit); no card.
"""

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tinynn_autograd_tpu_torch.ops import kernels  # noqa: E402

INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                         r"\s*([^;]*);")
REGISTER = re.compile(r"\bR(\d+)\b")


def sass_of(source, lib):
    """The SASS of the one-rank kernel built from ``source`` into ``lib``."""
    nvcc = kernels._find_nvcc()
    cmd = kernels.nvcc_command(nvcc, Path(source), lib)
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    functions = re.split(r"\n\s*Function : ", out)
    one_rank = [f for f in functions if "fused_epoch_kernelILb0E" in
                f.split("\n", 1)[0]]
    if not one_rank:
        raise RuntimeError("no one-rank fused_epoch_kernel in %s" % lib)
    return one_rank[0]


def stretches(sass):
    """For each stretch between two BAR.SYNC: (its first address, global
    loads, cp.async copies, loads stored to shared memory before the next
    load)."""
    out = []
    start, loads, copies, serial, pending = None, 0, 0, 0, {}
    for match in INSTRUCTION.finditer(sass):
        address, _, op, operands = match.groups()
        if start is None:
            start = int(address, 16)
        if op.startswith("BAR.SYNC"):
            out.append((start, loads, copies, serial))
            start, loads, copies, serial, pending = None, 0, 0, 0, {}
        elif op.startswith("LDGSTS"):
            copies += 1
        elif op.startswith("LDG"):
            loads += 1
            pending = {}  # an earlier load still unstored overlaps this one
            regs = REGISTER.findall(operands.split(",")[0])
            if regs:
                width = 4 if ".128" in op else (2 if ".64" in op else 1)
                first = int(regs[0])
                pending = {first + i for i in range(width)}
        elif op.startswith("STS") and pending:
            data = REGISTER.findall(operands.split(",")[-1])
            if data and int(data[0]) in pending:
                serial += 1
                pending = {}
    out.append((start or 0, loads, copies, serial))
    return out


def report(name, sass):
    parts = stretches(sass)
    worst = sorted(parts, key=lambda p: -p[3])[:3]
    print("%s: %d stretches between block barriers; %d cp.async copies, "
          "%d global loads, %d of them stored to shared memory before the "
          "next load" % (name, len(parts), sum(p[2] for p in parts),
                         sum(p[1] for p in parts), sum(p[3] for p in parts)))
    for start, loads, copies, serial in worst:
        if serial:
            print("  stretch at 0x%x: %d global loads, %d stored before the "
                  "next load (serial round trips), %d cp.async"
                  % (start, loads, serial, copies))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="root of an older checkout")
    args = parser.parse_args(argv)
    sources = [("this tree's K2", kernels.CSRC_DIR / "fused_epoch.cu")]
    if args.parent:
        sources.append(("the parent's K2", Path(args.parent)
                        / "tinynn_autograd_tpu_torch" / "csrc"
                        / "fused_epoch.cu"))
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        for i, (name, source) in enumerate(sources):
            report(name, sass_of(source, Path(tmp) / ("k2_%d.so" % i)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
