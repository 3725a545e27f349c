"""The MLP classifier (borgwang/tinynn-autograd's MNIST example) as the
program builds it: ``build_mnist_mlp``, softmax cross-entropy on one-hot
labels."""

from tinynn_autograd_tpu_torch.models import build_mnist_mlp
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss


def net(config, traffic):
    return build_mnist_mlp(num_in=config["num_in"],
                           hidden=tuple(config["hidden"]),
                           num_out=config["num_out"])


def loss(config):
    return SoftmaxCrossEntropyLoss()


def small(config, traffic):
    """The CPU tests' cut: the MLP at its own widths on fewer rows."""
    traffic = dict(traffic)
    traffic["data"] = dict(traffic["data"], n_train=1024, n_test=512)
    traffic["warmup_units"] = 1
    return config, traffic
