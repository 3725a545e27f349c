"""The program under test, the PyTorch and CUDA port, as the benchmark uses
it: a ``Model`` of the configuration's family (``families/<family>.py``:
the net built through the port's own model functions, and the family's
loss) with the port's Adam, the benchmark's seeded weights bound in place
of the functions' draws, and what the checks read back from it.

This module and ``families/`` are the harness modules that import the
program.
"""

import importlib

import torch

from tinynn_autograd_tpu_torch.nn.evaluator import AccEvaluator
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.optimizer import Adam
from tinynn_autograd_tpu_torch.utils import seeder

EVALUATOR = AccEvaluator


def family(config):
    """The module of ``families/<family>.py``: the program side of the
    configuration's family."""
    return importlib.import_module("families.%s" % config["family"])


def build(config, traffic, params, seed, device):
    """A Model of the configuration on ``device`` whose parameters are
    copies of ``params`` ({"<layer>.<key>": tensor}); each must match the
    net's own leaf in shape. The program's generator, which seeds its
    on-device shuffle, is seeded from ``seed``."""
    seeder.random_seed(int(seed) % 2 ** 32)
    fam = family(config)
    net = fam.net(config, traffic)
    tree = net.params_tree()
    names = {"%d.%s" % (i, k) for i, leaves in enumerate(tree)
             for k in leaves}
    if names != set(params):
        raise ValueError("the net's leaves %s are not the reference's %s"
                         % (sorted(names), sorted(params)))
    for name, value in params.items():
        i, k = name.split(".", 1)
        if tuple(tree[int(i)][k].shape) != tuple(value.shape):
            raise ValueError("%s: the net's shape %s, the reference's %s"
                             % (name, tuple(tree[int(i)][k].shape),
                                tuple(value.shape)))
        tree[int(i)][k] = value.clone()
    net.bind_params(tree)
    opt = config["optimizer"]
    return Model(net, fam.loss(config),
                 Adam(lr=opt["lr"], beta1=opt["beta1"], beta2=opt["beta2"],
                      epsilon=opt["eps"]), device=device)


def leaves(model):
    """{"<layer>.<key>": the live parameter tensor}."""
    return {"%d.%s" % (i, k): v
            for i, layer in enumerate(model.net.params_tree())
            for k, v in layer.items()}


def moments(model):
    """Adam's slots by slot ("m", "v") and leaf name, as the optimizer's
    state holds them (zeros when it holds none)."""
    state = model.optimizer.state_dict()
    if state is None:
        return {slot: {k: torch.zeros_like(v)
                       for k, v in leaves(model).items()}
                for slot in ("m", "v")}
    return {slot: {"%d.%s" % (i, k): v for i, layer in enumerate(layers)
                   for k, v in layer.items()}
            for slot, layers in state["slots"].items()}


def logits(model, x):
    """The eval's logits of ``x``: ``evaluate_batch``'s forward, in the TEST
    phase, returned before its argmax."""
    prev = model.get_phase()
    model.set_phase("TEST")
    out = model.predict(x).data
    model.set_phase(prev)
    return out


def counter(module, attr):
    """The launch counter of the program's kernel wrapper ``attr`` of
    ``module``."""
    return getattr(importlib.import_module(module), attr)
