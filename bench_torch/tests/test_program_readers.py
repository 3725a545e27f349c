"""The readers of the program's own spans and counters: None on an empty
table or a program without the profiler module, the mean per occurrence
(or per step) on a table built by hand, and the same mean where the
traced stretch took three tries (count and ns tripled)."""

import pytest

from harness import manifest, program

# a table as ``profiler.totals`` gives it after one try of a stretch
TABLE = {
    "tinynn.epoch": {"count": 8, "ns": 80_000_000, "self_ns": 20_000_000},
    "tinynn.eval": {"count": 8, "ns": 24_000_000, "self_ns": 1_000_000},
    "tinynn.eval.readback": {"count": 8, "ns": 8_000_000,
                             "self_ns": 8_000_000},
    "tinynn.step": {"count": 12, "ns": 84_000_000, "self_ns": 1_200_000},
    "k2.steps": 3120,
    "k2.phase_ns": {"forward 0": 31_200_000, "forward 1": 31_200_000,
                    "loss": 15_600_000, "backward 1": 62_400_000,
                    "backward 0": 31_200_000, "clip norm": 9_360_000,
                    "optimizer": 21_840_000},
}
EXPECTED = {"epoch_host_ms": 10.0, "eval_host_ms": 2.0, "step_host_ms": 7.0,
            "k2_phase_us.forward": 25.0, "k2_phase_us.backward": 30.0,
            "k2_phase_us.optimizer": 10.0}


def _tripled(table):
    return {name: (3 * row if isinstance(row, int)
                   else {k: 3 * v for k, v in row.items()})
            for name, row in table.items()}


def _serve(monkeypatch, table):
    monkeypatch.setattr(program, "counter",
                        lambda module, attr: (lambda: table))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_an_empty_table(monkeypatch, name):
    _serve(monkeypatch, {})
    assert manifest.reader(name).read(None) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_the_profiler_module(monkeypatch, name):
    def missing(module, attr):
        raise ModuleNotFoundError("No module named %r" % module)

    monkeypatch.setattr(program, "counter", missing)
    assert manifest.reader(name).read(None) is None


@pytest.mark.parametrize("tries", [1, 3])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_mean(monkeypatch, name, tries):
    _serve(monkeypatch, TABLE if tries == 1 else _tripled(TABLE))
    assert manifest.reader(name).read(None) == pytest.approx(EXPECTED[name])


def test_readers_are_in_the_manifest():
    bench = manifest.load()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        assert names[name]["workloads"]
        assert callable(manifest.reader(name).read)
