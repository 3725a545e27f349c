"""The traced stretch: a fixed number of the traffic loop's units under
``torch.profiler``, and what is read from its device trace.

- ``window_s``: the stretch's wall, from its host span ("bench.stretch",
  which ends after the device is done);
- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) within it;
- by kernel name: launches and device seconds, each port kernel's launches
  checked against its wrapper's ``.launches`` counter over the same units
  (the profiler has missed whole kernels on that machine): a kernel whose
  counts differ is marked, and a reader never uses its times;
- the breakdown: the device operations that took most time, and the idle
  gaps summed by what the host was doing meanwhile (the innermost host
  operation under the harness's span around the call).
"""

import bisect
import collections

import torch

from harness import program

TOP = 10
TRIES = 3


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


def _device_events(events, lo, hi):
    out = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if e.is_user_annotation() or e.name().startswith("bench."):
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if end > lo and start < hi:
            out.append((start, end, e.name()))
    return out


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class _Host:
    """Host operations of one thread, to name what ran at an instant."""

    def __init__(self, events):
        events = sorted(events)
        self.starts = [e[0] for e in events]
        self.events = events

    def innermost(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            start, end, name = self.events[i]
            if end >= t:
                return name
            i -= 1
        return None


def read_trace(events, kernels):
    """The stretch's numbers from a finished profile's events
    (``prof.profiler.kineto_results.events()``); ``kernels`` the names of
    the port kernels to count."""
    stretch = [e for e in events if e.name() == "bench.stretch"
               and e.device_type() == torch.autograd.DeviceType.CPU]
    if not stretch:
        raise RuntimeError("the profile holds no bench.stretch span")
    lo = stretch[0].start_ns()
    hi = lo + stretch[0].duration_ns()
    thread = stretch[0].start_thread_id()
    ops = _device_events(events, lo, hi)
    merged = _merge([(max(s, lo), min(e, hi)) for s, e, _ in ops])
    busy = sum(e - s for s, e in merged)

    by_name = collections.defaultdict(lambda: [0, 0])
    for s, e, name in ops:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    counts = {k: [0, 0.0] for k in kernels}
    for name, (n, ns) in by_name.items():
        for k in kernels:
            if k in name:
                counts[k][0] += n
                counts[k][1] += ns * 1e-9

    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU
            and e.start_thread_id() == thread
            and e.name() != "bench.stretch"]
    spans = _Host([h for h in host if h[2].startswith("bench.")])
    inner = _Host(host)
    gaps = collections.defaultdict(float)
    edges = [lo] + [t for s, e in merged for t in (s, e)] + [hi]
    for start, end in zip(edges[::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) // 2
        label = "%s > %s" % (spans.innermost(mid) or "-",
                             inner.innermost(mid) or "-")
        gaps[label] += (end - start) * 1e-9

    top_ops = sorted(((name[:160], ns * 1e-9)
                      for name, (_, ns) in by_name.items()),
                     key=lambda r: -r[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda r: -r[1])[:TOP]
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": {k: tuple(v) for k, v in counts.items()},
            "launches": sum(n for name, (n, _) in by_name.items()
                            if not _is_copy(name)),
            "breakdown": {"device_ops": [list(r) for r in top_ops],
                          "idle_gaps": [list(r) for r in top_gaps]}}


def profile_stretch(loop, units, wrappers):
    """Profile ``units`` of ``loop`` from a fresh epoch; ``wrappers`` maps
    each port kernel's name to its wrapper's (module, attribute). Retakes
    the stretch, up to ``TRIES`` times, while a kernel's count in the
    trace differs from its counter. Returns the stretch's numbers with
    ``loop``'s records of it, ``checked`` (kernel -> whether its counts
    agreed) and ``tries``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    counters = {k: program.counter(*w) for k, w in wrappers.items()}
    for attempt in range(1, TRIES + 1):
        loop.reset()
        before = {k: c.launches for k, c in counters.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("bench.stretch"):
                wall = loop.run(units=units, span=record_function)
        out = read_trace(prof.profiler.kineto_results.events(),
                         list(wrappers))
        out["counted"] = {k: c.launches - before[k]
                          for k, c in counters.items()}
        out["checked"] = {k: out["kernels"][k][0] == out["counted"][k]
                          for k in wrappers}
        out["tries"] = attempt
        out["records"] = loop.records(wall)
        if all(out["checked"].values()):
            break
    return out
