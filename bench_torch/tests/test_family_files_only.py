"""A model family added as new files only. A copy of the benchmark gains a
toy next-token language model (``lm_probe/files/``: its configuration,
traffic, limits, family, data kind and reference, whose targets are
token ids) and entries in the copy's ``BENCHMARK.json``; no file that the
benchmark has changes. Run from the copy in a process of its own, on the
CPU, the new cell's sound run is correct, and the control and each fault
the cell can have are not."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import check, manifest

PROBE = manifest.BENCH_DIR / "tests" / "lm_probe"
SEED = 2 ** 31 + 4049


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def make_checkout(root):
    """A checkout at ``root``: a copy of the benchmark with the probe's
    files added and its entries in ``BENCHMARK.json``. Returns the new
    cell's name."""
    bench_dir = root / manifest.BENCH_DIR.name
    shutil.copytree(manifest.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, data in _files(PROBE / "files").items():
        target = bench_dir / rel
        assert not target.exists(), rel
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(data)
    entries = json.loads((PROBE / "entries.json").read_text())
    bench = manifest.load()
    bench["configs"] += entries["configs"]
    bench["workloads"] += entries["workloads"]
    cell = entries["workloads"][0]["name"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if metric["name"] in entries["joins"]:
            metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return cell


def run_cell(root, cell, seed):
    """``tests/cpu_run.py`` of the checkout at ``root`` on ``cell``."""
    path = os.pathsep.join(filter(None, [str(manifest.ROOT),
                                         os.environ.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, str(root / manifest.BENCH_DIR.name / "tests"
                             / "cpu_run.py"),
         "--workload", cell, "--seed", str(seed)],
        cwd=root, env=dict(os.environ, PYTHONPATH=path),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return root, make_checkout(root)


@pytest.fixture(scope="module")
def outcome(checkout):
    """The cell's run from the copy; every file of the benchmark, the
    harness's among them, is then as the tree has it."""
    root, cell = checkout
    result = run_cell(root, cell, SEED)
    copy = _files(root / manifest.BENCH_DIR.name)
    for rel, data in _files(manifest.BENCH_DIR).items():
        assert copy[rel] == data, rel
    return result


def test_sound_run_is_correct(checkout, outcome):
    _, cell = checkout
    result = outcome["sound"]
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(outcome["limits"])
    assert result["failed"] == 0 and result["attempted"] > 0
    assert {"setup_s", "train_tokens_per_s"} <= set(result["metrics"])
    assert check.judge(outcome["readings"]["program"], outcome["limits"])[1]


def test_control_and_faults_in_the_reference_fail(outcome):
    sides = [s for s in outcome["readings"] if s != "program"]
    assert sides == ["control", "frozen", "half_batch", "wrong_label",
                     "fresh_state", "wrong_beta2"]
    for side in sides:
        within = check.judge(outcome["readings"][side], outcome["limits"])[1]
        assert not within, (side, outcome["readings"][side])


def test_faults_planted_in_the_program_fail(outcome):
    assert sorted(outcome["planted"]) == sorted(
        ["frozen", "half_batch", "wrong_label", "fresh_state", "wrong_beta2"])
    for fault, result in outcome["planted"].items():
        assert not result["correct"], (fault, result["checks"])
