"""Model: net + loss + optimizer facade on one explicit device.

PyTorch counterpart of the JAX package's nn/model.py, for the MLP trainers,
the transformer sequence classifier (int token ids in, staged and batched as
they are) and the recurrent sequence classifier:

1. The eager loop: ``zero_grad -> forward -> loss -> backward -> step``.
   Dropout draws its masks from the seeder's generator there.
2. ``train_step(x, y)``: forward + tape backward + optimizer update for one
   batch, returning the loss as a device scalar (no host sync). Dropout
   masks are seeded with the optimizer's step counter (``_step``).
3. ``train_epoch``/``train_epochs``: the data staged on the device once, an
   on-device shuffle per epoch (``torch.randperm`` with the model's own
   generator), then one of three tiers over the batches:
   - the whole-epoch kernel (K2, ``ops/fused_epoch.py``): the epoch in one
     CUDA launch, on the CPU its plain version. ``fused=True`` takes it or
     raises ``ValueError`` saying why the net is not eligible.
   - the weight-streaming tier (K3 and K3b, ``ops/streaming_epoch.py``): a
     host loop of streaming steps over the batches, each running the
     DenseStack body's forward in one launch and its backward with the
     optimizer's update in another; on the CPU their plain versions.
     ``fused="stream"`` takes it or raises ``ValueError`` saying why.
   - the step tier, a loop of train steps (``fused=False``). A transformer
     net always runs here: its attention launches the flash kernels
     (``ops/attention.py``) from the tape, and K2 and the streaming tier
     refuse the net with their reasons. So does a recurrent net: each LSTM
     or GRU layer launches its recurrent kernel forward and backward
     (``ops/recurrent.py``) once a step.
   ``fused="auto"``, the default, takes the first of K2, the streaming tier
   and the step tier that can run the net, as the JAX package does; the
   kernels' tiers only on a CUDA device. A build or launch failure of a
   kernel raises; nothing falls back to another tier.

Parameters are updated IN PLACE (``param.add_(step)``), which saves a second
copy of the weights on the device each step. Every parameter and every input
lives on ``device``, which has no default: a model never lands on the CPU
because no GPU was found.

While ``utils/profiler`` records, ``train_epochs``, ``evaluate_batch`` and
``train_step`` and their phases are spans (``tinynn.epoch``, ``tinynn.eval``,
``tinynn.step`` and their children).

Checkpoints (``save``/``load``) use the JAX package's pickle format
``tinynn_tpu_ckpt_v1``, so a checkpoint written by either package loads in
the other.
"""

import pickle

import numpy as np
import torch

from tinynn_autograd_tpu_torch.core.tensor import Tensor, to_torch
from tinynn_autograd_tpu_torch.utils import profiler, seeder
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)


class Model:

    def __init__(self, net, loss, optimizer, device):
        self.net = net
        self.loss = loss
        self.optimizer = optimizer
        self.device = torch.device(device)

        self._phase = "TRAIN"
        self._shuffle_gen = None
        if net.is_init:
            net.to(self.device)

    # ------------------------------------------------------------- staging

    def _stage_one(self, x):
        return to_torch(x).to(self.device)

    def stage(self, x, y=None):
        """Move data to the model's device once; returns device tensor(s).
        Feed the result to ``train_epoch`` so epochs run with no
        host-to-device traffic."""
        if y is None:
            return self._stage_one(x)
        return self._stage_one(x), self._stage_one(y)

    def _ensure_init(self, input_shape):
        if not self.net.is_init:
            self.net.init(input_shape)
        self.net.to(self.device)

    # ------------------------------------------------------------- forward

    def forward(self, inputs):
        """Taped forward; a Tensor already on the device keeps its tape."""
        if not (isinstance(inputs, Tensor) and inputs.device == self.device):
            inputs = Tensor(self._stage_one(inputs))
        self._ensure_init(inputs.shape)
        return self.net.forward(inputs)

    def predict(self, inputs):
        """Inference forward; returns a Tensor with no tape history."""
        x = self._stage_one(inputs)
        self._ensure_init(x.shape)
        return Tensor(self.net.forward(Tensor(x)).data)

    def evaluate_batch(self, x, y, evaluator):
        """TEST-phase forward + argmax for classification eval; restores
        the prior phase."""
        with profiler.span("tinynn.eval"):
            prev = self._phase
            if prev != "TEST":
                self.set_phase("TEST")
            with profiler.span("tinynn.eval.forward"):
                preds = self.predict(x)
            if prev != "TEST":
                self.set_phase(prev)
            with profiler.span("tinynn.eval.readback"):
                logits = preds.numpy()
            pred_idx = np.argmax(logits, axis=1)
            targets = y.numpy() if isinstance(y, Tensor) else np.asarray(y)
            return evaluator.evaluate(pred_idx, targets)

    # ---------------------------------------------------------- train step

    def _apply_grads(self, grads):
        """One optimizer update, written into the parameters in place."""
        params = self.net.get_parameters()
        steps = self.optimizer.compute_step(grads, params)
        for step, param in zip(steps, params):
            for k, p in param.items():
                p.data.add_(step[k])
                p.grad = None

    def _step(self, xb, yb):
        """One train step. Its Dropout masks are seeded with the optimizer's
        step counter before the update, the value the JAX megakernel gives
        the step, so the step loop and K2 draw the same masks as the JAX
        megakernel in interpret mode (not the threefry masks of the JAX
        package's step and scanned tiers)."""
        for param in self.net.get_parameters():
            for p in param.values():
                p.grad = None
        with profiler.span("tinynn.step.forward"):
            pred = self.net.forward(Tensor(xb),
                                    rng=self.optimizer.step_count)
        with profiler.span("tinynn.step.loss"):
            loss_t = self.loss.loss(pred, Tensor(yb))
        with profiler.span("tinynn.step.backward"):
            loss_t.backward()
        with profiler.span("tinynn.step.update"):
            self._apply_grads(self.net.collect_grads())
        return loss_t.data

    def train_step(self, x, y, accum_steps=1):
        """One optimization step; returns the loss as a device scalar (no
        host sync: wrap in float() to wait for it)."""
        if accum_steps != 1:
            raise NotImplementedError(
                "accum_steps > 1 is not ported to the PyTorch package yet "
                "(see ROADMAP.md, queue 1)")
        with profiler.span("tinynn.step"):
            x, y = self.stage(x, y)
            self._ensure_init(x.shape)
            if self._phase != "TRAIN":
                self.set_phase("TRAIN")
            return self._step(x, y)

    def train_epoch(self, x_all, y_all, batch_size=128, shuffle=True,
                    fused="auto"):
        """One full epoch; returns the per-step loss trace [n_steps] on the
        device. The ragged tail (n % batch_size) is dropped."""
        return self.train_epochs(x_all, y_all, n_epochs=1,
                                 batch_size=batch_size, shuffle=shuffle,
                                 fused=fused)[0]

    def _shuffle_generator(self):
        if self._shuffle_gen is None:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=seeder.generator()))
            self._shuffle_gen = torch.Generator(device=self.device)
            self._shuffle_gen.manual_seed(seed)
        return self._shuffle_gen

    def train_epochs(self, x_all, y_all, n_epochs, batch_size=128,
                     shuffle=True, fused="auto"):
        """``n_epochs`` full epochs over data staged on the device; returns
        the loss trace [n_epochs, n_steps] on the device. The call is one
        ``tinynn.epoch`` span."""
        if fused not in ("auto", True, False, "stream"):
            raise ValueError("fused must be 'auto', False, True or 'stream', "
                             "got %r" % (fused,))
        with profiler.span("tinynn.epoch"):
            x_all, y_all = self.stage(x_all, y_all)
            feat = tuple(x_all.shape[1:])
            label_feat = tuple(y_all.shape[1:])
            batch_shape = (batch_size,) + feat
            self._ensure_init(batch_shape)
            if self._phase != "TRAIN":
                self.set_phase("TRAIN")

            n = x_all.shape[0]
            n_steps = n // batch_size
            if n_steps == 0:
                raise ValueError(
                    "dataset of %d samples is smaller than batch_size=%d "
                    "(the ragged tail is dropped; nothing would train)"
                    % (n, batch_size))
            with profiler.span("tinynn.epoch.tier"):
                epoch_fn = self._whole_epoch_kernel(
                    fused, n_steps, batch_shape, (batch_size,) + label_feat)
                step_fn = (self._streaming_step(fused, batch_shape)
                           if epoch_fn is None else None) or self._step
            used = n_steps * batch_size
            losses = torch.empty((n_epochs, n_steps), device=self.device)
            for epoch in range(n_epochs):
                with profiler.span("tinynn.epoch.shuffle"):
                    if shuffle:
                        perm = torch.randperm(
                            n, generator=self._shuffle_generator(),
                            device=self.device)[:used]
                        xs, ys = x_all[perm], y_all[perm]
                    else:
                        xs, ys = x_all[:used], y_all[:used]
                    xs = xs.reshape((n_steps, batch_size) + feat)
                    ys = ys.reshape((n_steps, batch_size) + label_feat)
                    if epoch_fn is not None:
                        xs = xs.to(torch.float32).contiguous()
                        ys = ys.to(torch.float32).contiguous()
                if epoch_fn is not None:
                    opt, params = self.optimizer, self.net.params_tree()
                    _, losses[epoch] = epoch_fn(
                        params, opt.live_state(params)["slots"],
                        opt.step_count, xs, ys)
                    opt.advance(n_steps)
                    continue
                for s in range(n_steps):
                    losses[epoch, s] = step_fn(xs[s], ys[s])
            return losses

    def _whole_epoch_kernel(self, fused, n_steps, batch_shape, label_shape):
        """The K2 ``epoch_fn`` when this call takes the whole-epoch kernel,
        else None (the step tier). The JAX package's tier choice: True
        forces it, raising ``ValueError`` with the reason when the model is
        not eligible (a transformer, or a layer other than Dense, the
        activations and Flatten); "auto" takes it
        only on the accelerator, and only for an eligible model."""
        from tinynn_autograd_tpu_torch.ops import fused_epoch

        if fused in (False, "stream") or (fused == "auto"
                                          and self.device.type != "cuda"):
            return None
        reason = fused_epoch.unsupported_reason(
            self.net, self.net.params_tree(), self.optimizer, self.loss,
            batch_shape)
        if reason is not None:
            if fused is True:
                raise ValueError("fused=True: the whole-epoch kernel (MLPs of "
                                 "Dense layers) cannot run this model: %s"
                                 % reason)
            return None
        return fused_epoch.build_fused_epoch(
            self.net, self.loss, self.optimizer, n_steps, batch_shape,
            label_shape)

    def _streaming_step(self, fused, batch_shape):
        """The streaming tier's ``step_fn`` when this call takes it, else
        None. "stream" forces it, raising ``ValueError`` with the reason
        when the net is not eligible; "auto" takes it only on the
        accelerator, and only for an eligible net."""
        from tinynn_autograd_tpu_torch.ops import streaming_epoch

        if fused not in ("stream", "auto") or (fused == "auto"
                                                and self.device.type != "cuda"):
            return None
        reason = streaming_epoch.unsupported_reason(self.net, self.optimizer,
                                                    batch_shape)
        if reason is not None:
            if fused == "stream":
                raise ValueError("fused='stream': the streaming tier (MLPs "
                                 "with one DenseStack body) cannot run this "
                                 "model: %s" % reason)
            return None
        return streaming_epoch.build_streaming_step(self.net, self.loss,
                                                    self.optimizer)

    # ------------------------------------------------------------ eager step

    def step(self):
        """Collect grads, compute optimizer steps, apply them in place."""
        self._apply_grads([
            {k: v.grad for k, v in param.items()}
            for param in self.net.get_parameters()
        ])

    def zero_grad(self):
        for param in self.net.get_parameters():
            for p in param.values():
                if p is not None:
                    p.zero_grad()

    # ----------------------------------------------------------- checkpoint

    def save(self, path):
        if not self.net.is_init:
            raise RuntimeError(
                "Model.save before parameters exist: the net has lazy layers "
                "that were never initialized (run a forward / train step, or "
                "call net.init(input_shape) first).")
        state = self.optimizer.state_dict()
        opt_state = None
        if state is not None:
            opt_state = {
                "t": np.asarray(state["t"], np.int32),
                "slots": {n: params_to_numpy(tree)
                          for n, tree in state["slots"].items()},
            }
        payload = {
            "format": "tinynn_tpu_ckpt_v1",
            "params": params_to_numpy(self.net.params_tree()),
            "opt_state": opt_state,
            "buffers": self.net.buffers_tree(),
            "layer_names": [l.name for l in self.net.layers],
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        print("Model saved in %s." % path)

    def load(self, path):
        """Load a ``tinynn_tpu_ckpt_v1`` checkpoint (only files this program
        or the JAX package wrote: unpickling runs code)."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        params = payload["params"]
        if len(params) != len(self.net.layers):
            raise ValueError(
                "Incompatible architecture: %d layers in checkpoint vs %d "
                "defined." % (len(params), len(self.net.layers)))
        for i, (saved, layer) in enumerate(zip(params, self.net.layers)):
            if layer.is_init:
                have = layer.param_shapes
            else:
                have = {k: v for k, v in getattr(layer, "shapes", {}).items()}
            for k, arr in saved.items():
                want = have.get(k)
                want = tuple(want) if want is not None else None
                if (want is not None and None not in want
                        and want != tuple(np.shape(arr))):
                    raise ValueError(
                        "Incompatible architecture at layer %d (%s/%s): "
                        "%s in checkpoint vs %s defined."
                        % (i, layer.name, k, tuple(np.shape(arr)), want))
        if any(payload.get("buffers") or []):
            raise ValueError("checkpoint carries layer buffers, which no "
                             "layer of this package holds")
        tree = params_from_jax(params, self.device)
        self.net.bind_params(tree)
        for layer, saved in zip(self.net.layers, tree):
            if hasattr(layer, "_is_init") and saved:
                layer._is_init = True
                if "w" in saved:
                    layer.shapes["w"] = list(saved["w"].shape)
        opt_state = payload.get("opt_state")
        if opt_state is not None:
            self.optimizer.load_state_dict({
                "t": int(np.asarray(opt_state["t"])),
                "slots": {n: params_from_jax(tree, self.device)
                          for n, tree in opt_state["slots"].items()},
            })
        else:
            # weights-only checkpoint: drop any live optimizer state so the
            # restored params don't train against another run's moments
            self.optimizer.load_state_dict(None)
        print("Restored model from %s." % path)

    # ---------------------------------------------------------------- phase

    def get_phase(self):
        return self._phase

    def set_phase(self, phase):
        if phase not in ("TRAIN", "TEST"):
            raise ValueError(phase)
        self.net.set_phase(phase)
        self._phase = phase
