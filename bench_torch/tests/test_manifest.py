"""The manifest: BENCHMARK.json against the benchmark's contract, and the
loader finding each cell's and each metric's files by name."""

import importlib
import math
import re
import sys
from pathlib import Path

import pytest

from harness import check, manifest, program
from reference import mlp, transformer

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200
        assert c["file"].startswith("bench_torch/")


def test_each_cell_finds_its_files():
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1
        config = manifest.config(BENCH, cell["config"])
        traffic = manifest.traffic(cell["traffic"])
        limits = manifest.limits(cell["name"])
        family = program.family(config)
        assert all(callable(getattr(family, f))
                   for f in ("net", "loss", "small"))
        ref = check.reference_module(config)
        assert callable(ref.param_spec) and callable(ref.forward)
        kind = importlib.import_module("data.%s" % traffic["data"]["kind"])
        assert callable(kind.make)
        assert traffic["entry"] in ("train_epoch", "train_step")
        assert {"grad", "state"} <= set(limits)
        assert ("logits" in limits) == bool(traffic.get("eval"))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports(cell):
    e2e = [m["name"] for m in manifest.metrics(BENCH, cell, 0)]
    layer = manifest.metrics(BENCH, cell, 1)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)
    for m in manifest.metrics(BENCH, cell, 0) + layer:
        assert callable(manifest.reader(m["name"]).read)


def test_loader_by_name():
    assert manifest.cell(BENCH, "transformer_6b.train_t256")["traffic"] == \
        "train_t256"
    with pytest.raises(KeyError):
        manifest.cell(BENCH, "no_such_cell")
    names = [m["name"] for m in manifest.metrics(BENCH,
                                                 "mlp_mnist.epochs_eval", 1)]
    assert names == ["mfu.mlp", "eval_ms_p95", "k2_roofline",
                     "k1_roofline.eval", "device_idle.mlp", "epoch_host_ms",
                     "eval_host_ms", "k2_phase_us.forward",
                     "k2_phase_us.backward", "k2_phase_us.optimizer"]
    reader = manifest.reader("k2_roofline")
    assert "fused_epoch_kernel" in reader.KERNELS


def test_split_metrics_share_a_reader():
    """``device_idle.mlp`` and ``device_idle.transformer`` have no file of
    their own and read through ``device_idle.py``; a part with a file of
    its own takes it."""
    shared = manifest.reader("device_idle.transformer")
    assert shared.__file__.endswith("device_idle.py")
    own = manifest.reader("k1_roofline.eval")
    assert own.__file__.endswith("k1_roofline.eval.py")


def test_t256_metrics_read_as_their_namesakes():
    """t256's throughput and per-layer metrics are the t2048 cell's
    readings under names of their own (``<name>.t256``), so that t256's
    throughput takes a bound of its own."""
    by_name = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    parts = [n for n in by_name if n.endswith(".t256")]
    assert len(parts) == 8
    for name in parts:
        base = by_name[name[:-len(".t256")]]
        assert by_name[name]["workloads"] == ["transformer_6b.train_t256"]
        assert base["workloads"] == ["transformer_6b.train_t2048"]
        assert by_name[name].get("moves") == (
            base["moves"] + ".t256" if "moves" in base else None)
        mine, theirs = manifest.reader(name), manifest.reader(base["name"])
        assert mine.read.__code__.co_filename == \
            theirs.read.__code__.co_filename
        assert getattr(mine, "KERNELS", {}) == getattr(theirs, "KERNELS", {})


def test_parameter_counts():
    cfg = manifest.config(BENCH, "transformer_6b")
    spec = transformer.param_spec(cfg, manifest.traffic("train_t2048"))
    assert sum(math.prod(s) for _, s, _ in spec) == \
        cfg["parameters_at_seq_len"]
    spec = mlp.param_spec(manifest.config(BENCH, "mlp_mnist"), {})
    assert sum(math.prod(s) for _, s, _ in spec) == 186_200 + 410


def test_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tinynn_autograd_tpu)\b"
                         r"(?!_torch)", re.M)
    for path in manifest.BENCH_DIR.rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_forbidden_modules(monkeypatch):
    import run

    clean = {name: module for name, module in sys.modules.items()
             if name.split(".", 1)[0] not in run.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", clean)
    assert run.forbidden_modules() == []
    for name in ("jax.numpy", "flax", "tinynn_autograd_tpu.ops",
                 "tinynn_autograd_tpu_torch_x", "jaxtyping"):
        clean[name] = None
    assert run.forbidden_modules() == ["flax", "jax", "tinynn_autograd_tpu"]


def test_references_import_no_program():
    for path in (manifest.BENCH_DIR / "reference").glob("*.py"):
        assert "tinynn_autograd_tpu" not in path.read_text(), path
