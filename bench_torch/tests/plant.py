"""The faults a cell can have, planted in the program under a run that
skips the look for a chip (``reference.common.FAULTS`` names them; the
reference's own plants mirror these)."""

from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.optimizer import Adam


def _lose_state_on_second_call(cls, name, monkeypatch, calls):
    """Wrap the entry ``name`` so that the second call into either entry
    starts from a fresh optimizer state."""
    call = getattr(cls, name)

    def planted(self, *args, **kwargs):
        calls.append(name)
        if len(calls) == 2:
            self.optimizer.reset()
        return call(self, *args, **kwargs)

    monkeypatch.setattr(cls, name, planted)


def plant(fault, monkeypatch):
    """Plant ``fault`` in the program through ``monkeypatch``, which undoes
    it."""
    if fault == "frozen":
        monkeypatch.setattr(Model, "_apply_grads", lambda self, grads: None)
        return
    if fault == "fresh_state":
        calls = []
        for name in ("train_epochs", "train_step"):
            _lose_state_on_second_call(Model, name, monkeypatch, calls)
        return
    if fault == "wrong_beta2":
        init = Adam.__init__

        def wrong(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self._b2 = 0.99

        monkeypatch.setattr(Adam, "__init__", wrong)
        return
    if fault == "wrong_answer":
        predict = Model.predict

        def wrong(self, x):
            out = predict(self, x)
            out.data[0] = out.data[1].clone()
            return out

        monkeypatch.setattr(Model, "predict", wrong)
        return
    step, calls = Model._step, []

    def planted(self, xb, yb):
        if fault == "half_batch":
            return step(self, xb[:len(xb) // 2], yb[:len(yb) // 2])
        if not calls:
            # the last row's targets rolled by one: a one-hot row's class,
            # or a row of ids shifted along it
            yb = yb.clone()
            yb[-1] = yb[-1].roll(1)
        calls.append(1)
        return step(self, xb, yb)

    monkeypatch.setattr(Model, "_step", planted)
