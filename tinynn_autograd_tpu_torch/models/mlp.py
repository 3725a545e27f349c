"""MNIST MLP, the flagship config: 784 -> 200 -> 100 -> 70 -> 30 -> 10 Dense
stack with ReLU."""

from tinynn_autograd_tpu_torch.nn.layers import Dense, ReLU
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
