"""Plain reference of the MLP classifier (borgwang/tinynn-autograd's MNIST
example): Dense layers with ReLU between them, logits out. The parameters
are named "<i>.w" [fan_in, fan_out] and "<i>.b" [1, fan_out] after the
position i of their Dense layer in the program's net (a ReLU follows each
Dense but the last)."""

import torch

from reference.common import mm


def param_spec(config, traffic):
    sizes = [config["num_in"]] + list(config["hidden"]) + [config["num_out"]]
    spec = []
    for layer, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        spec += [("%d.w" % (2 * layer), (fan_in, fan_out), "xavier"),
                 ("%d.b" % (2 * layer), (1, fan_out), "zeros")]
    return spec


def forward(params, config, x, precision):
    n_layers = len(config["hidden"]) + 1
    h = x
    for layer in range(n_layers):
        h = mm(h, params["%d.w" % (2 * layer)], precision) \
            + params["%d.b" % (2 * layer)]
        if layer < n_layers - 1:
            h = torch.relu(h)
    return h
