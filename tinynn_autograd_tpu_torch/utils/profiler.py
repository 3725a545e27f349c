"""Spans and counters at the port's layer boundaries.

The facade (``nn/model.py``), the tape's step and the whole-epoch kernel's
host path open named spans here, and the kernel's phase clock adds into a
device counter. Everything is off by default: ``span`` then returns one
shared null context after a single flag check, and ``count`` does nothing.

Spans are on while torch's profiler records (``torch.profiler.profile``):
each span then opens ``torch.profiler.record_function(name)``, so it lands
on the profiler's timeline (and in its exported Chrome trace) on the clock
of the device's kernels, and its count, total ns and self ns (total less
what its child spans cover) add into an in-memory table. ``recording()``
turns the table on without the profiler, for the totals alone.

    with torch.profiler.profile():     # or: with profiler.recording():
        model.train_epoch(x, y)
    profiler.totals()["tinynn.epoch"]  # {"count": 1, "ns": .., "self_ns": ..}

Span names start with ``tinynn.``. The paths that open spans are
single-threaded: the parent of a span is the top of one plain stack.
"""

import contextlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_spans = {}     # name -> [count, ns, self_ns]
_counts = {}    # name -> int
_device = {}    # name -> {(keys, device): int64 tensor}
_stack = []     # the open spans, innermost last
_recording = 0  # depth of open recording() blocks


def enabled():
    """Whether spans and counters record now."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


class _Span:
    __slots__ = ("name", "annotation", "child_ns", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.child_ns = 0
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start
        _stack.pop()
        if _stack:
            _stack[-1].child_ns += ns
        row = _spans.setdefault(self.name, [0, 0, 0])
        row[0] += 1
        row[1] += ns
        row[2] += ns - self.child_ns
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name):
    """A context manager timing the block as span ``name`` while on."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Spans and counters on inside the block, with or without the
    profiler; with it off, spans open no ``record_function``."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count(name, n=1):
    """Adds ``n`` to host counter ``name`` while on."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def device_counter(name, keys, device):
    """An int64 tensor on ``device`` with one entry per key, zero at first,
    that a kernel adds into; the same tensor for the same name, keys and
    device until ``reset``. Read only by ``totals``."""
    keys = tuple(keys)
    per_name = _device.setdefault(name, {})
    key = (keys, torch.device(device))
    if key not in per_name:
        per_name[key] = torch.zeros(len(keys), dtype=torch.int64,
                                    device=device)
    return per_name[key]


def totals():
    """The table: each span's {"count", "ns", "self_ns"}, each host
    counter's value and each device counter's {key: value}, by name.
    Reading a device counter waits for the kernels that add into it."""
    out = {name: {"count": c, "ns": ns, "self_ns": self_ns}
           for name, (c, ns, self_ns) in _spans.items()}
    out.update(_counts)
    for name, per_name in _device.items():
        summed = {}
        for (keys, _), tensor in per_name.items():
            for k, v in zip(keys, tensor.tolist()):
                summed[k] = summed.get(k, 0) + v
        out[name] = summed
    return out


def reset():
    """Clears every span, counter and device counter."""
    _spans.clear()
    _counts.clear()
    _device.clear()
