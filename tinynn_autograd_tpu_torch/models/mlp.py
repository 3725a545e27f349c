"""MLP configs: the MNIST MLP flagship (784 -> 200 -> 100 -> 70 -> 30 -> 10
Dense stack with ReLU) and the deep MLP."""

from tinynn_autograd_tpu_torch.nn.layers import Dense, DenseStack, ReLU
from tinynn_autograd_tpu_torch.nn.net import Net


def build_mnist_mlp(num_in=784, hidden=(200, 100, 70, 30), num_out=10,
                    activation=ReLU, compute_dtype=None):
    layers = []
    prev = num_in
    for h in hidden:
        layers.append(Dense(h, num_in=prev, compute_dtype=compute_dtype))
        layers.append(activation())
        prev = h
    layers.append(Dense(num_out, num_in=prev, compute_dtype=compute_dtype))
    return Net(layers)


def build_deep_mlp(num_in=256, depth=100, width=256, num_out=10,
                   stacked=False):
    """The deep-graph config: ``depth`` Dense layers, ReLU between them.

    ``stacked=True`` holds the body's ``depth - 2`` width->width layers as
    one DenseStack (the weight-streaming tier's net): the same function up
    to the order of the initial draws."""
    if stacked:
        return Net([
            Dense(width, num_in=num_in), ReLU(),
            DenseStack(depth - 2, width=width, activation="relu"),
            Dense(num_out, num_in=width),
        ])
    layers = []
    prev = num_in
    for _ in range(depth - 1):
        layers.append(Dense(width, num_in=prev))
        layers.append(ReLU())
        prev = width
    layers.append(Dense(num_out, num_in=prev))
    return Net(layers)
