"""Device time of a call on a CUDA card, by CUDA events.

``device_us`` times calls queued back to back behind a spin kernel, so the
card runs them with no wait for the host between them: the time the card
spends on the call, whatever the host's dispatch costs. Used by
``chip_smoke.py`` and the probe scripts.
"""

import gc
import time

import torch

# the spin's clock: the H100's top SM clock, 1,980 MHz; a lower clock only
# makes the spin longer
SPIN_CYCLES_PER_S = 1.98e9

# the spin's margin over the host's time to queue a group: it starts at
# PAD_S and doubles, up to MAX_PAD_S, each time the card catches up
PAD_S = 1e-3
MAX_PAD_S = 0.5


def device_us(fn, reps=50, attempts=12):
    """Device time per call: CUDA events around groups of calls, each group
    queued behind a spin kernel (``torch.cuda._sleep``) that lasts until
    the host has queued it all, so the card runs the calls back to back
    with no wait for the host between them. A group whose first call the
    card reached before the host had queued its last is dropped and taken
    again, with the spin's margin doubled (a pause of the host's) and the
    groups cut to a quarter (the host waits when the card's launch queue
    is full); the measurement fails after ``attempts`` such groups. The
    garbage collector is off while the groups are queued, so its pauses do
    not stall the host behind the spin. (torch.profiler, used here before,
    missed whole kernels on the H100 machine: over 5 calls its device time
    read 19-99% of the events' time, near whole fifths, and in one run it
    saw no kernel at all.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / reps
    group, pad_s, caught = reps, PAD_S, 0
    total_ms, done = 0.0, 0
    collecting = gc.isenabled()
    gc.disable()
    try:
        while done < reps:
            n = min(group, reps - done)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int((2.0 * n * call_s + pad_s)
                                  * SPIN_CYCLES_PER_S))
            start.record()
            for _ in range(n):
                fn()
            end.record()
            caught_up = start.query()
            torch.cuda.synchronize()
            if caught_up:
                caught += 1
                if caught >= attempts:
                    raise AssertionError(
                        "the card caught up with the host in %d groups"
                        % caught)
                group = max(1, group // 4)
                pad_s = min(2.0 * pad_s, MAX_PAD_S)
                continue
            total_ms += start.elapsed_time(end)
            done += n
    finally:
        if collecting:
            gc.enable()
    return total_ms * 1000.0 / reps
