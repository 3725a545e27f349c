"""The comparison that decides ``correct``, on the CPU at small sizes: a
sound run is correct; the control (the reference in TF32 in the
program's place) and each fault the cell can have, planted in the program
under a run that skips the look for a chip, are not."""

import time

import pytest

import control
from harness import check, manifest, runner
from plant import plant
from small import BENCH, sizes

CELLS = [c["name"] for c in BENCH["workloads"]]
SEED = 2 ** 31 + 977


def _run(cell):
    config, traffic = sizes(cell)
    return runner.run(BENCH, cell, SEED, 0.2, False, "cpu",
                       time.perf_counter(), config=config, traffic=traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(manifest.limits(cell))
    assert result["failed"] == 0 and result["attempted"] > 0
    # a short window on a loaded host may hold too few evals for a p95
    want = {m["name"] for m in manifest.metrics(BENCH, cell, 0)}
    assert {"setup_s"} < set(result["metrics"]) <= want


FAULT_CASES = [(cell, fault) for cell in CELLS
               for fault in control.sides(sizes(cell)[1])[2:]]


@pytest.mark.parametrize("cell, fault", FAULT_CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    plant(fault, monkeypatch)
    result = _run(cell)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_stand_ins_are_not_correct(cell):
    """The control, and each fault planted in the reference put in the
    program's place, fail a number; the program's readings pass."""
    config, traffic = sizes(cell)
    table = control.readings(BENCH, cell, SEED, "cpu", config, traffic)
    limits = manifest.limits(cell)
    assert check.judge(table["program"], limits)[1]
    for side in control.sides(traffic)[1:]:
        assert not check.judge(table[side], limits)[1], (side, table[side])
