"""Net: ordered layer container, as in the JAX package's nn/net.py.

``init(input_shape)`` materializes all lazy parameters by static shape
inference; ``params_tree``/``bind_params`` convert between the layers'
Tensors and a raw tree (a list of per-layer dicts of torch tensors);
``to(device)`` moves every parameter. No layer of this package carries
non-trainable buffers yet, so the buffers tree is a list of empty dicts.
"""

import torch

from tinynn_autograd_tpu_torch.core.tensor import Tensor, as_tensor
from tinynn_autograd_tpu_torch.ops.dropout import layer_seed


class Net:

    def __init__(self, layers):
        self.layers = layers
        self._phase = "TRAIN"

    def forward(self, inputs, rng=None):
        """Chain the layer forwards. ``rng``, an int step seed where given,
        seeds the layers that take one (``set_rng``: Dropout, and a
        TransformerBlock with dropout): the one at position ``idx`` among
        them, in net order, gets ``rng * 1000003 + idx`` mod 2**32, the
        JAX package's rule inside its megakernel (wrapping int32 there; the
        same bits), which K2 follows too (csrc/hash.cuh). Without it they
        draw from the seeder's generator."""
        inputs = as_tensor(inputs)
        if rng is not None:
            takers = [layer for layer in self.layers
                      if hasattr(layer, "set_rng")]
            for idx, layer in enumerate(takers):
                layer.set_rng(layer_seed(rng, idx))
        for layer in self.layers:
            inputs = layer.forward(inputs)
        return inputs

    def init(self, input_shape):
        """Materialize every lazy parameter by propagating static shapes
        through the stack. Returns the output shape."""
        shape = tuple(input_shape)
        for layer in self.layers:
            init_fn = getattr(layer, "init_params", None)
            if init_fn is not None:
                shape = tuple(init_fn(shape))
        return shape

    @property
    def is_init(self):
        return all(layer.is_init for layer in self.layers)

    def to(self, device):
        """Move every parameter to ``device`` (a new leaf Tensor per
        parameter; those already there are kept)."""
        device = torch.device(device)
        for layer in self.layers:
            for k, v in layer.params.items():
                if v is not None and v.device != device:
                    layer.params[k] = Tensor(v.data.to(device),
                                             requires_grad=True)
        return self

    def get_parameters(self):
        return [layer.params for layer in self.layers]

    def set_parameters(self, params):
        """Key/shape-checked parameter load; accepts Tensors or raw arrays.
        Raw arrays land on the device of the parameter they replace."""
        for i, layer in enumerate(self.layers):
            if layer.params.keys() != params[i].keys():
                raise ValueError("layer %d (%s): keys %s, got %s" % (
                    i, layer.name, sorted(layer.params), sorted(params[i])))
            for key in layer.params.keys():
                old, new = layer.params[key], params[i][key]
                if not isinstance(new, Tensor):
                    new = Tensor(new, requires_grad=True,
                                 device=old.device if old is not None else None)
                if old is not None and tuple(old.shape) != tuple(new.shape):
                    raise ValueError("layer %d (%s/%s): shape %s, got %s" % (
                        i, layer.name, key, tuple(old.shape),
                        tuple(new.shape)))
                layer.params[key] = new

    def params_tree(self):
        """Raw tree (list of per-layer dicts) of current params."""
        return [
            {k: v.data for k, v in layer.params.items() if v is not None}
            for layer in self.layers
        ]

    def bind_params(self, tree):
        """Install a raw tree as the layers' live parameters, wrapped as
        requires_grad leaf Tensors."""
        for layer, layer_tree in zip(self.layers, tree):
            for k, arr in layer_tree.items():
                layer.params[k] = Tensor(arr, requires_grad=True)

    def collect_grads(self):
        """Gradient tree congruent with ``params_tree`` (post-backward); a
        parameter the loss did not reach gets a zero gradient."""
        return [
            {k: (v.grad if v.grad is not None else torch.zeros_like(v.data))
             for k, v in layer.params.items() if v is not None}
            for layer in self.layers
        ]

    def buffers_tree(self):
        """Non-trainable layer state: one empty dict per layer here."""
        return [{} for _ in self.layers]

    # --------------------------------------------------------------- phase

    def get_phase(self):
        return self._phase

    def set_phase(self, phase):
        for layer in self.layers:
            layer.set_phase(phase)
        self._phase = phase
