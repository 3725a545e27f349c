"""A toy next-token language model as the program builds it from its own
layers: token and learned position embeddings, causal pre-LN transformer
blocks and a Dense over the vocabulary at every position, ids [B, T] ->
logits [B, T, vocab]. Its loss takes the next-token ids [B, T] and
one-hots them inside the loss."""

import torch

from tinynn_autograd_tpu_torch.core.tensor import to_torch
from tinynn_autograd_tpu_torch.nn.layers import (
    Dense, Embedding, PositionalEmbedding, TransformerBlock,
)
from tinynn_autograd_tpu_torch.nn.losses import (
    BaseLoss, SoftmaxCrossEntropyLoss,
)
from tinynn_autograd_tpu_torch.nn.net import Net


def net(config, traffic):
    dim, vocab = config["dim"], config["vocab"]
    layers = [Embedding(vocab, dim), PositionalEmbedding(traffic["seq_len"],
                                                         dim)]
    layers += [TransformerBlock(dim, config["heads"],
                                mlp_ratio=config["mlp_ratio"], causal=True)
               for _ in range(config["depth"])]
    layers.append(Dense(vocab, num_in=dim))
    return Net(layers)


class NextTokenLoss(BaseLoss):
    """Softmax cross-entropy of every position's next-token id, the mean
    over all positions."""

    def __init__(self, vocab):
        self._vocab = vocab
        self._ce = SoftmaxCrossEntropyLoss()

    def loss(self, logits, ids):
        onehot = torch.nn.functional.one_hot(
            to_torch(ids).reshape(-1), self._vocab).float()
        return self._ce.loss(logits.reshape((-1, self._vocab)), onehot)


def loss(config):
    return NextTokenLoss(config["vocab"])


def small(config, traffic):
    """Already a CPU test's size."""
    return config, traffic
