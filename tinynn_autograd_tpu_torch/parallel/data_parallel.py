"""Data parallelism over a mesh of ranks that share one device.

PyTorch counterpart of the JAX package's parallel/data_parallel.py
(BASELINE.json configuration 5). The JAX wrapper runs one program a device
under ``shard_map``: each device takes its shard of every global batch, and
the gradients are averaged over the mesh axis between the backward and the
update. Here one process drives every rank (see parallel/mesh.py), in two
tiers:

- the step tier (``train_step``; ``train_epochs(fused=False)``): one
  parameter set, as the JAX package's replicated ``pmean`` step keeps. Each
  rank runs the tape on its shard (on the card through K1, and P1 with
  Dropout); the gradients are summed in rank order and multiplied by 1/n
  (the ``pmean``, an XLA all-reduce outside any kernel there, plain torch
  ops here), then one optimizer update.
- the megakernel tier (``train_epochs(fused=True or "auto")``): each epoch
  is ONE launch of the whole-epoch kernel with one rank a batch shard, K2
  with its in-kernel gradient ring (K6, ``ops/fused_epoch.py``); on the CPU
  its plain version. Each rank keeps its own replica and optimizer slots
  across epochs, as each TPU device keeps its shard of the "replicated"
  parameters: every rank sums the ring in its own order, so the replicas
  drift apart by rounding (``replica_spread``). Rank 0's replica is the
  model's own parameters and slots; any update outside this tier (a step
  tier step, ``load``) makes the other ranks copy rank 0's again.

Each shard's loss divides by the LOCAL batch, so the mean of the shard
gradients is the gradient of the global-mean loss; the reported loss is the
mean over ranks of each rank's local mean. Dropout: rank r draws, in the
step whose optimizer counter is t, with step seed ``t + 7919 r`` (the JAX
megakernel's rule), in both tiers. The JAX step tier draws threefry masks,
which the port does not reproduce. Shuffling permutes each rank's shard on
the device with the model's generator (the JAX package folds each rank's
index into a threefry key, which cannot be reproduced either).
"""

import torch

from tinynn_autograd_tpu_torch.core.tensor import Tensor
from tinynn_autograd_tpu_torch.ops.fused_epoch import rank_step
from tinynn_autograd_tpu_torch.parallel.mesh import make_mesh, same_device


class DataParallel:
    """Wrap a Model for data-parallel training over the ranks of a mesh.

    Usage::

        model = Model(net, loss, optimizer, device="cuda")
        dp = DataParallel(model, mesh=make_mesh(
            devices=[torch.device("cuda")] * 4))
        loss = dp.train_step(x, y)              # global batch in, loss out
        losses = dp.train_epochs(x, y, 3, fused="auto")
    """

    def __init__(self, model, mesh=None, n_devices=None, axis_name="data"):
        self.model = model
        self.mesh = (mesh if mesh is not None
                     else make_mesh(n_devices, axis_name))
        self.axis_name = axis_name
        self.n_devices = self.mesh.size
        if not same_device(self.mesh.device, model.device):
            raise ValueError("the mesh's ranks share %s, the model lives on "
                             "%s" % (self.mesh.device, model.device))
        # the megakernel tier's replicas of ranks 1..n-1: (params, slots)
        self._replicas = None

    @property
    def net(self):
        return self.model.net

    def stage(self, x, y=None):
        """Move data to the device once; every rank reads its shard of it
        there. Feed the result to train_epoch/train_step."""
        return self.model.stage(x, y)

    def _check_batch(self, n):
        if n % self.n_devices:
            raise ValueError("Global batch %d not divisible by mesh size %d"
                             % (n, self.n_devices))

    def _ensure_state(self, input_shape):
        self.model._ensure_init(input_shape)
        if self.model.get_phase() != "TRAIN":
            self.model.set_phase("TRAIN")
        return self.model.optimizer.live_state(self.net.params_tree())

    # ------------------------------------------------------------ step tier

    def _step(self, xs, ys):
        """One data-parallel step: ``xs``/``ys`` hold each rank's local
        batch. Returns the mean over ranks of the local losses."""
        net, n = self.net, self.n_devices
        t = self.model.optimizer.step_count
        rank_grads, losses = [], []
        for r in range(n):
            for param in net.get_parameters():
                for p in param.values():
                    p.grad = None
            pred = net.forward(Tensor(xs[r]), rng=rank_step(t, r))
            loss_t = self.model.loss.loss(pred, Tensor(ys[r]))
            loss_t.backward()
            rank_grads.append(net.collect_grads())
            losses.append(loss_t.data)
        # the pmean: summed in rank order, then times 1/n
        grads = []
        for i, layer in enumerate(rank_grads[0]):
            summed = {}
            for k, g in layer.items():
                for other in rank_grads[1:]:
                    g = g + other[i][k]
                summed[k] = g * (1.0 / n)
            grads.append(summed)
        self.model._apply_grads(grads)
        self._replicas = None  # ranks 1..n-1 copy rank 0's at the next epoch
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        return total / n

    def train_step(self, x, y, accum_steps=1):
        """One data-parallel step on a GLOBAL batch (its leading dim must
        divide by the mesh size); rank r takes rows [r m, (r + 1) m).
        Returns the global mean loss as a device scalar."""
        if accum_steps != 1:
            raise NotImplementedError(
                "accum_steps > 1 is not ported to the PyTorch package yet "
                "(see ROADMAP.md, queue 1)")
        x, y = self.stage(x, y)
        self._check_batch(x.shape[0])
        m = x.shape[0] // self.n_devices
        self._ensure_state((m,) + tuple(x.shape[1:]))
        return self._step(x.split(m), y.split(m))

    # ---------------------------------------------------------- epoch tiers

    def train_epoch(self, x_all, y_all, batch_size=128, shuffle=True,
                    fused=False):
        """One data-parallel epoch; ``batch_size`` is the GLOBAL batch.
        Returns the per-step global-mean losses [n_steps]."""
        return self.train_epochs(x_all, y_all, n_epochs=1,
                                 batch_size=batch_size, shuffle=shuffle,
                                 fused=fused)[0]

    def train_epochs(self, x_all, y_all, n_epochs, batch_size=128,
                     shuffle=True, fused=False):
        """``n_epochs`` data-parallel epochs; rank r trains on its shard,
        rows [r N/n, (r + 1) N/n) of the data, ``batch_size / n`` rows a
        step. Returns the losses [n_epochs, n_steps] on the device.

        ``fused``: False (default) takes the step tier. True takes the
        megakernel tier (K2 with the K6 ring; its plain version on the CPU)
        or raises ``ValueError`` when the model is not eligible; "auto"
        takes it on a CUDA device when the model is eligible, else the step
        tier."""
        if fused not in ("auto", True, False):
            raise ValueError("fused must be 'auto', False or True, got %r"
                             % (fused,))
        x_all, y_all = self.stage(x_all, y_all)
        n = self.n_devices
        if x_all.shape[0] % n or batch_size % n:
            raise ValueError(
                "dataset size %d and global batch %d must divide by mesh "
                "size %d" % (x_all.shape[0], batch_size, n))
        feat, label_feat = tuple(x_all.shape[1:]), tuple(y_all.shape[1:])
        local_n, local_batch = x_all.shape[0] // n, batch_size // n
        n_steps = local_n // local_batch
        if n_steps == 0:
            raise ValueError("a rank's shard of %d samples is smaller than "
                             "its batch of %d" % (local_n, local_batch))
        state = self._ensure_state((local_batch,) + feat)
        opt = self.model.optimizer

        epoch_fn = self._megakernel(fused, n_steps, (local_batch,) + feat,
                                    (local_batch,) + label_feat)
        used = n_steps * local_batch
        xr = x_all.reshape((n, local_n) + feat)
        yr = y_all.reshape((n, local_n) + label_feat)
        losses = torch.empty((n_epochs, n_steps), device=x_all.device)
        for epoch in range(n_epochs):
            if shuffle:
                gen = self.model._shuffle_generator()
                perms = torch.stack([
                    torch.randperm(local_n, generator=gen,
                                   device=x_all.device)[:used]
                    for _ in range(n)])
                rows = torch.arange(n, device=x_all.device)[:, None]
                xs, ys = xr[rows, perms], yr[rows, perms]
            else:
                xs, ys = xr[:, :used], yr[:, :used]
            xs = xs.reshape((n, n_steps, local_batch) + feat)
            ys = ys.reshape((n, n_steps, local_batch) + label_feat)
            if epoch_fn is None:
                for s in range(n_steps):
                    losses[epoch, s] = self._step(xs[:, s], ys[:, s])
                continue
            replicas = [(self.net.params_tree(), state["slots"])]
            replicas += self._rank_replicas(replicas[0])
            _, rank_losses = epoch_fn(
                [p for p, _ in replicas], [s for _, s in replicas],
                opt.step_count, xs.to(torch.float32).contiguous(),
                ys.to(torch.float32).contiguous())
            opt.advance(n_steps)
            losses[epoch] = rank_losses.sum(0) / n
        return losses

    def _megakernel(self, fused, n_steps, batch_shape, label_shape):
        """The ranked K2 ``epoch_fn`` when this call takes the megakernel
        tier, else None (the step tier). The JAX package's choice: True
        forces it, raising ``ValueError`` when the model is not eligible;
        "auto" takes it only on the accelerator, only for an eligible
        model."""
        from tinynn_autograd_tpu_torch.ops import fused_epoch

        if fused is False or (fused == "auto"
                              and self.model.device.type != "cuda"):
            return None
        reason = fused_epoch.unsupported_reason(
            self.net, self.net.params_tree(), self.model.optimizer,
            self.model.loss, batch_shape, self.n_devices)
        if reason is not None:
            if fused is True:
                raise ValueError("fused=True: model not eligible for the DP "
                                 "megakernel (%s)" % reason)
            return None
        return fused_epoch.build_fused_epoch(
            self.net, self.model.loss, self.model.optimizer, n_steps,
            batch_shape, label_shape, n_ranks=self.n_devices)

    def _rank_replicas(self, rank0):
        """The replicas of ranks 1..n-1, copied from rank 0's where there
        are none yet."""
        if self._replicas is None:
            params, slots = rank0

            def copy(tree):
                return [{k: v.clone() for k, v in d.items()} for d in tree]

            self._replicas = [
                (copy(params), {k: copy(v) for k, v in slots.items()})
                for _ in range(self.n_devices - 1)]
        return self._replicas

    def replica_spread(self):
        """The largest |rank r's parameter - rank 0's| over every parameter
        of every rank: 0.0 outside the megakernel tier."""
        if not self._replicas:
            return 0.0
        rank0 = self.net.params_tree()
        return max(float((v - rank0[i][k]).abs().max())
                   for params, _ in self._replicas
                   for i, d in enumerate(params) for k, v in d.items())

    # -------------------------------------------------------------- predict

    def predict(self, x):
        """Batch-sharded inference: rank r runs the forward on its rows
        with rank 0's parameters, in the model's current phase. A batch that
        does not divide by the mesh size goes to ``model.predict``."""
        x = self.model.stage(x)
        if x.shape[0] % self.n_devices:
            return self.model.predict(x)
        m = x.shape[0] // self.n_devices
        self.model._ensure_init((m,) + tuple(x.shape[1:]))
        return Tensor(torch.cat([self.net.forward(Tensor(shard)).data
                                 for shard in x.split(m)]))

    # ----------------------------------------------------------- checkpoint

    def save(self, path):
        """Rank 0's parameters and optimizer state, in the Model checkpoint
        format."""
        self.model.save(path)

    def load(self, path):
        """Restore a Model-format checkpoint; every rank starts from it."""
        self.model.load(path)
        self._replicas = None

