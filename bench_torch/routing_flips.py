"""The routing flips of a cell of an expert family (``mellum2``), beside
the readings its correctness limits are set from (``control.py``), on many
seeds in one process:

- a flip is a token whose top-k set of experts differs between two sides
  in one expert layer of one of the check's three steps; a held flip, one
  whose set differs in a held expert (it moves a held expert's rows, and
  so its leaves, where other flips move only a top-k denominator by
  rounding);
- the sides: the program against the reference (each routing its own
  scores), and the control (the reference in TF32) against the reference.

    python3 bench_torch/routing_flips.py --workload <cell> --seeds 1,2,3 \
        [--out readings.json] [--device cpu --small]

Prints one JSON line a seed: the flips and held flips by step (each summed
over the layers) and each side's numbers (``control.readings``); then the
summary of the numbers, as ``control.py`` gives it. The benchmark's runs do
not run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

import control  # noqa: E402
from harness import check, manifest  # noqa: E402


def capture(monkeypatch, module, name, into):
    """Wrap ``module.name`` (a routing function whose result is the top-k
    indices) so that each result is appended to ``into`` on the host."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        top = fn(*args, **kwargs)
        into.append(top.cpu())
        return top

    monkeypatch.setattr(module, name, wrapped)


def flips(got, want, config):
    """{"flips", "held_flips"}: per step, summed over its layers, of two
    sides' routings (one [tokens, k] tensor a layer a step, in order). The
    held experts are the first ``experts_held``."""
    n_layers, held = config["layers"], config["experts_held"]

    def members(top):
        return torch.zeros(top.shape[0], config["num_experts"],
                           dtype=torch.bool).scatter_(1, top, True)

    out = {"flips": [], "held_flips": []}
    for step in range(check.N_STEPS):
        n = n_held = 0
        for a, b in zip(got[step * n_layers:(step + 1) * n_layers],
                        want[step * n_layers:(step + 1) * n_layers]):
            differ = members(a) != members(b)
            n += int(differ.any(dim=-1).sum())
            n_held += int(differ[:, :held].any(dim=-1).sum())
        out["flips"].append(n)
        out["held_flips"].append(n_held)
    return out


def readings(bench, cell_name, seed, device, small=False):
    """{side: numbers} of ``control.readings``, with the program's and the
    control's flips against the reference; ``small``: at the family's CPU
    cut."""
    import pytest

    from harness import program as program_side
    from reference import mellum2
    from tinynn_autograd_tpu_torch import ops

    cell = manifest.cell(bench, cell_name)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    if small:
        config, traffic = program_side.family(config).small(config, traffic)
    program, reference = [], []
    with pytest.MonkeyPatch.context() as monkeypatch:
        capture(monkeypatch, ops, "top_k_", program)
        capture(monkeypatch, mellum2, "route", reference)
        row = control.readings(bench, cell_name, seed, device, config,
                               traffic)
    per_run = config["layers"] * check.N_STEPS
    want = reference[:per_run]
    row["flips"] = {"program": flips(program, want, config),
                    "control": flips(reference[per_run:2 * per_run], want,
                                     config)}
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
