"""The transformer sequence classifier (config 6b) as the program builds
it: ``build_tiny_transformer``, softmax cross-entropy on one-hot labels."""

from tinynn_autograd_tpu_torch.models import build_tiny_transformer
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss


def net(config, traffic):
    return build_tiny_transformer(
        vocab=config["vocab"], seq_len=traffic["seq_len"],
        dim=config["dim"], heads=config["heads"], depth=config["depth"],
        num_out=config["num_out"], causal=config["causal"],
        mlp_ratio=config["mlp_ratio"])


def loss(config):
    return SoftmaxCrossEntropyLoss()


def small(config, traffic):
    """The CPU tests' cut: a toy width, short sequences, few of them."""
    config = dict(config, vocab=32, dim=32, heads=4)
    traffic = dict(traffic, batch=4,
                   seq_len=16 if traffic["seq_len"] > 256 else 8,
                   warmup_units=1, data={"kind": "random_tokens", "n_seq": 32})
    return config, traffic
