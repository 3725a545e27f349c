"""The routing flips of a cell of the ``moonlight`` family, beside the
readings its correctness limits are set from: ``routing_flips.py``'s
readings and flips, with the reference's selection taken from
``reference/moonlight.py``'s ``route`` and the flips counted over the
expert layers (the leading dense layers route nothing).

    python3 bench_torch/moonlight_flips.py --workload <cell> --seeds 1,2,3 \
        [--out readings.json] [--device cpu --small]

Prints one JSON line a seed, then the summary, as ``routing_flips.py``
does. The benchmark's runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import control  # noqa: E402
import routing_flips  # noqa: E402
from harness import check, manifest  # noqa: E402


def flip_config(config):
    """What ``routing_flips.flips`` reads, for the expert layers."""
    return {"layers": config["layers"] - config["first_k_dense_replace"],
            "num_experts": config["n_routed_experts"],
            "experts_held": config["experts_held"]}


def readings(bench, cell_name, seed, device, small=False):
    """{side: numbers} of ``control.readings``, with the program's and the
    control's flips against the reference."""
    import pytest

    from harness import program as program_side
    from reference import moonlight
    from tinynn_autograd_tpu_torch import ops

    cell = manifest.cell(bench, cell_name)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    if small:
        config, traffic = program_side.family(config).small(config, traffic)
    program, reference = [], []
    with pytest.MonkeyPatch.context() as monkeypatch:
        routing_flips.capture(monkeypatch, ops, "top_k_", program)
        routing_flips.capture(monkeypatch, moonlight, "route", reference)
        row = control.readings(bench, cell_name, seed, device, config,
                               traffic)
    flips = flip_config(config)
    per_run = flips["layers"] * check.N_STEPS
    want = reference[:per_run]
    row["flips"] = {
        "program": routing_flips.flips(program, want, flips),
        "control": routing_flips.flips(reference[per_run:2 * per_run], want,
                                       flips)}
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true",
                        help="at the family's CPU cut")
    parser.add_argument("--out")
    args = parser.parse_args()
    bench = manifest.load()
    table = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = readings(bench, args.workload, seed, args.device, args.small)
        print(json.dumps({"seed": seed, **row}), flush=True)
        table.append({k: v for k, v in row.items() if k != "flips"})
    result = {"workload": args.workload, "seeds": args.seeds,
              "summary": control.summary(table)}
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"table": table, **result}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
