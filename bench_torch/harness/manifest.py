"""The benchmark's manifest: ``BENCHMARK.json`` at the checkout's root, and
the files it names, found by name.

- a configuration: ``bench_torch/configs/<config>.json`` (the entry's
  ``file``), its sizes and its ``family``;
- a family, by the configuration's ``family``: the program side,
  ``bench_torch/families/<family>.py`` with ``net(config, traffic)`` (the
  port's ``Net``, built through the port's own model functions),
  ``loss(config)`` (the port's loss object, which takes the targets as the
  data kind makes them) and ``small(config, traffic)`` (the CPU tests'
  cut); and the plain reference, ``bench_torch/reference/<family>.py``
  with ``param_spec(config, traffic)``, ``forward(params, config, x,
  precision)`` and, where its targets are not one-hot rows, ``loss(logits,
  y)`` (``reference/common.py``'s ``cross_entropy`` otherwise);
- a traffic mix: ``bench_torch/traffic/<traffic>.json``, the parameters
  that the one general generator (``harness/loop.py``) reads;
- a data kind, by the traffic's ``data["kind"]``:
  ``bench_torch/data/<kind>.py`` with ``make(gen, config, traffic,
  device)``, which draws the data from the seed's generator on the device;
  its targets ``y`` may be one-hot rows or class ids of any shape, such as
  next-token ids [n, T];
- a cell's correctness limits: ``bench_torch/workloads/<cell>.json``;
- a metric, end to end or per layer: ``bench_torch/metrics/<name>.py``, a
  reader with ``read(ctx) -> float | None`` and, where it reads kernel
  times, ``KERNELS``: kernel name -> (module, wrapper) of the program,
  whose ``.launches`` counts that kernel's launches. A metric split by
  cells (``<base>.<part>``) whose parts read alike shares the reader
  ``bench_torch/metrics/<base>.py``, taken where no file of its own name
  exists.

A later cell, metric, configuration, family or data kind is a set of new
files and new entries here; no file of the harness changes. A new cell
joins a metric that has a ``workloads`` list by having its name appended
to that list.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError("BENCHMARK.json has no %s named %r" % (what, name))


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(bench, name):
    return _by_name(bench["workloads"], name, "workload")


def config(bench, name, root=ROOT):
    return _json(Path(root) / _by_name(bench["configs"], name,
                                       "configuration")["file"])


def traffic(name):
    return _json(BENCH_DIR / "traffic" / ("%s.json" % name))


def limits(cell_name):
    return _json(BENCH_DIR / "workloads" / ("%s.json" % cell_name))["limits"]


def applies(metric, cell_name, reported):
    """Whether ``metric`` is reported in the cell: the cells its
    ``workloads`` key lists, else, for a per-layer metric, every cell that
    reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def metrics(bench, cell_name, trace):
    """The metrics a run of the cell prints: its end-to-end metrics with
    ``trace`` 0, its per-layer metrics with ``trace`` 1."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell_name, ())]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if applies(m, cell_name, names)]


def reader(name):
    """The module of ``bench_torch/metrics/<name>.py``, else of the shared
    ``<base>.py`` of a split metric ``<base>.<part>``."""
    path = BENCH_DIR / "metrics" / ("%s.py" % name)
    if not path.exists():
        path = BENCH_DIR / "metrics" / ("%s.py" % name.split(".", 1)[0])
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
