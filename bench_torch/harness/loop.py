"""The one traffic generator: a closed loop of a user's training epochs,
read from a traffic file.

``entry`` "train_epoch": each epoch is one ``Model.train_epoch(x, y,
batch_size, fused=...)`` over the training set staged on the device (the
program shuffles it on the device), then the last loss read back, as
``examples/mnist/run_torch.py`` does.

``entry`` "train_step": each epoch draws a permutation of the staged rows
on the device from the seed, gathers them, and calls ``Model.train_step``
on each batch of ``batch`` rows in turn; then the last loss is read back.

With ``eval``, each epoch ends with ``Model.evaluate_batch`` on the test
rows staged once. Steps are timed between CUDA events recorded at their
boundaries (no added synchronisation), evaluations between events
recorded around the call; both on the device's clock.
"""

import contextlib
import time

import torch

from harness import inputs


class Loop:

    def __init__(self, model, data, traffic, seed, device, evaluator):
        self.model = model
        self.data = data
        self.traffic = traffic
        self.device = torch.device(device)
        self.evaluator = evaluator
        self.batch = traffic["batch"]
        self.steps_per_epoch = len(data["x"]) // self.batch
        self.cuda = self.device.type == "cuda"
        self._gen = inputs.generator(seed, inputs.ORDER, device)
        self._labels_host = (data["labels_test"].cpu().numpy()
                             if traffic.get("eval") else None)
        self._pos = None
        self.reset()

    def reset(self):
        """Clear the records; the next unit starts a new epoch."""
        self.steps = 0
        self.evals = 0
        self._pairs, self._eval_pairs, self._losses = [], [], []
        self._pos = None

    def _event(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _evaluate(self, span):
        with span("bench.evaluate_batch"):
            start = self._event()
            self.model.evaluate_batch(self.data["x_test"], self._labels_host,
                                      self.evaluator)
            self._eval_pairs.append((start, self._event()))
        self.evals += 1

    def _end_epoch(self, span):
        with span("bench.readback"):
            float(self._losses[-1].reshape(-1)[-1])
        if self.traffic.get("eval"):
            self._evaluate(span)

    def _start_epoch(self, span):
        with span("bench.shuffle"):
            n = len(self.data["x"])
            used = self.steps_per_epoch * self.batch
            perm = torch.randperm(n, generator=self._gen,
                                  device=self.device)[:used]
            self._xs = self.data["x"][perm].reshape(
                (self.steps_per_epoch, self.batch)
                + tuple(self.data["x"].shape[1:]))
            self._ys = self.data["y"][perm].reshape(
                (self.steps_per_epoch, self.batch)
                + tuple(self.data["y"].shape[1:]))
        self._prev = self._event()
        self._pos = 0

    def unit(self, span):
        """One unit of work: an epoch (``train_epoch``) or a step
        (``train_step``, with the epoch's end and start around it where
        they fall)."""
        if self.traffic["entry"] == "train_epoch":
            with span("bench.train_epoch"):
                self._losses.append(self.model.train_epoch(
                    self.data["x"], self.data["y"], batch_size=self.batch,
                    fused=self.traffic["fused"]))
            self.steps += self.steps_per_epoch
            self._end_epoch(span)
            return
        if self._pos == self.steps_per_epoch:
            self._end_epoch(span)
        if self._pos is None or self._pos == self.steps_per_epoch:
            self._start_epoch(span)
        with span("bench.train_step"):
            loss = self.model.train_step(self._xs[self._pos],
                                         self._ys[self._pos])
            ev = self._event()
        self._losses.append(loss)
        self._pairs.append((self._prev, ev))
        self._prev = ev
        self._pos += 1
        self.steps += 1

    def run(self, seconds=None, units=None, span=None):
        """Units until ``seconds`` have passed on the host's clock, or
        ``units`` are done; then waits for the device. Returns the wall
        seconds."""
        span = span or (lambda name: contextlib.nullcontext())
        self.sync()
        t0 = time.perf_counter()
        done = 0
        while True:
            self.unit(span)
            done += 1
            if units is not None and done >= units:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        return time.perf_counter() - t0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _elapsed_ms(self, pairs):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]

    def records(self, wall_s):
        """The window's records, after ``run``."""
        losses = torch.cat([l.reshape(-1) for l in self._losses]) \
            if self._losses else torch.zeros(0)
        rows = self.steps * self.batch
        return {"wall_s": wall_s, "steps": self.steps, "evals": self.evals,
                "rows": rows,
                "tokens": rows * self.traffic.get("seq_len", 1),
                "step_ms": self._elapsed_ms(self._pairs),
                "eval_ms": self._elapsed_ms(self._eval_pairs),
                "failed": int((~torch.isfinite(losses)).sum())}
