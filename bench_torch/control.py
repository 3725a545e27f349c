"""The readings that a cell's correctness limits are set from, at the
cell's own size, on many seeds in one process:

- "program": the program's check steps (the set-up part of a run) against
  the plain reference: the lower readings;
- "control": the reference itself computed one precision lower (TF32
  products) in the program's place;
- each fault of ``reference.common.FAULTS`` that the cell can have,
  planted in the reference put in the program's place.

    python3 bench_torch/control.py --workload <cell> --seeds 1,2,3 \
        [--out readings.json]

Prints one JSON line a seed and side, then the summary: for each number
the largest program reading and the smallest control and fault readings.
The benchmark's runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import check, inputs, manifest  # noqa: E402
from reference.common import FAULTS  # noqa: E402


def sides(traffic):
    """The readings' sides: the program, the control, and each fault the
    cell can have (an eval's wrong answer only where it evaluates)."""
    return ["program", "control"] + [
        f for f in FAULTS if f != "wrong_answer" or traffic.get("eval")]


def readings(bench, cell_name, seed, device, config=None, traffic=None):
    """{side: the numbers compared} of one seed."""
    from harness import program

    cell = manifest.cell(bench, cell_name)
    config = config or manifest.config(bench, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    ref = check.reference_module(config)
    params = inputs.make_params(ref.param_spec(config, traffic), seed, device)
    data = inputs.make_data(config, traffic, seed, device)
    model = program.build(config, traffic, params, seed, device)
    got = check.program_readings(model, data, traffic, config)
    del model, data, params
    check.free_device()
    want = check.reference_readings(config, traffic, seed, device)
    out = {"program": check.compare(got, want)}
    for side in sides(traffic)[1:]:
        stand_in = check.reference_readings(
            config, traffic, seed, device,
            precision="tf32" if side == "control" else "f32",
            fault=None if side == "control" else side)
        out[side] = check.compare(stand_in, want)
    return out


def summary(table):
    """For each number: the program's largest reading and each stand-in's
    smallest."""
    out = {}
    for side in table[0]:
        agg = max if side == "program" else min
        out[side] = {k: agg(row[side][k] for row in table)
                     for k in table[0][side]}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args()
    bench = manifest.load()
    table = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = readings(bench, args.workload, seed, args.device)
        table.append(row)
        for side, numbers in row.items():
            print(json.dumps({"seed": seed, "side": side, **numbers}),
                  flush=True)
    result = {"workload": args.workload, "summary": summary(table),
              "seeds": args.seeds}
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"table": table, **result}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
