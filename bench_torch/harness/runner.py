"""One run of one cell: set-up, the measured window, the traced stretch,
then the comparison with the plain reference. Returns the result line
and the numbers compared."""

import gc
import sys
import time
import types

import torch

from harness import check, costs, inputs, manifest, program, trace
from harness.loop import Loop


def _metric_values(specs, ctx):
    out = {}
    for spec in specs:
        value = manifest.reader(spec["name"]).read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def _wrappers(specs):
    wrappers = {}
    for spec in specs:
        wrappers.update(getattr(manifest.reader(spec["name"]), "KERNELS", {}))
    return wrappers


def device_info(device, peak):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def run(bench, cell_name, seed, seconds, traced, device, t_start,
        config=None, traffic=None):
    """One run; ``config`` and ``traffic`` stand in for the cell's files
    where given (the CPU tests' small sizes)."""
    cell = manifest.cell(bench, cell_name)
    config = config or manifest.config(bench, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell_name)
    specs = manifest.metrics(bench, cell_name, traced)
    cuda = torch.device(device).type == "cuda"

    marks = [("start", time.perf_counter() - t_start)]
    ref = check.reference_module(config)
    params = inputs.make_params(ref.param_spec(config, traffic), seed, device)
    data = inputs.make_data(config, traffic, seed, device)
    model = program.build(config, traffic, params, seed, device)
    del params
    marks.append(("inputs", time.perf_counter() - t_start))
    readings = check.program_readings(model, data, traffic, config)
    marks.append(("check_steps", time.perf_counter() - t_start))
    loop = Loop(model, data, traffic, seed, device, program.EVALUATOR)
    loop.run(units=traffic["warmup_units"])
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm", setup_s))
    print("set-up (s from process start): %s" % ", ".join(
        "%s %.3f" % m for m in marks), file=sys.stderr)

    loop.reset()
    window = loop.records(loop.run(seconds=seconds))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    stretch = None
    if traced:
        stretch = trace.profile_stretch(loop, traffic["trace_units"],
                                        _wrappers(specs))
    ctx = types.SimpleNamespace(config=config, traffic=traffic,
                                cell=cell_name, setup_s=setup_s,
                                window=window, stretch=stretch, costs=costs)
    metrics = _metric_values(specs, ctx)
    del loop, model, data
    gc.collect()
    check.free_device()

    numbers = check.compare(readings, check.reference_readings(
        config, traffic, seed, device))
    checks, within = check.judge(numbers, limits)
    failed = window["failed"]
    result = {"correct": bool(within and failed == 0),
              "attempted": window["steps"] + window["evals"],
              "failed": failed, "metrics": metrics,
              "device": device_info(device, peak)}
    if stretch is not None:
        result["device"].update(busy_s=stretch["busy_s"],
                                window_s=stretch["window_s"])
        result["breakdown"] = stretch["breakdown"]
        result["trace_check"] = {"tries": stretch["tries"],
                                 "profiler": {k: v[0] for k, v in
                                              stretch["kernels"].items()},
                                 "counters": stretch["counted"]}
    result["checks"] = checks
    return result
