"""One cell of the checkout this file lies in, on the CPU at the tests'
small sizes (``small.py``): the sound run, the readings of the control and
of each fault the cell can have put in the program's place
(``control.readings``), and a run with each such fault planted in the
program (``plant.py``). Prints them as one JSON object on the last line.

    python3 bench_torch/tests/cpu_run.py --workload <cell> --seed <n>

The program's package has to be importable (``PYTHONPATH``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS), str(TESTS.parent), str(TESTS.parents[1])]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args()

    import pytest

    import control
    from harness import manifest, runner
    from plant import plant
    from small import BENCH, sizes

    config, traffic = sizes(args.workload)

    def run():
        return runner.run(BENCH, args.workload, args.seed, 0.2, False, "cpu",
                          time.perf_counter(), config=config, traffic=traffic)

    out = {"limits": manifest.limits(args.workload), "sound": run(),
           "readings": control.readings(BENCH, args.workload, args.seed,
                                        "cpu", config, traffic),
           "planted": {}}
    for fault in control.sides(traffic)[2:]:
        with pytest.MonkeyPatch.context() as monkeypatch:
            plant(fault, monkeypatch)
            out["planted"][fault] = run()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
