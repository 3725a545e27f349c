"""Loss functions: ``BaseLoss``, the per-row, numerically stable
``SoftmaxCrossEntropyLoss`` with its class-weight path, and ``MSELoss``, as
in the JAX package's nn/losses.py; and ``SparseSoftmaxCrossEntropyLoss``,
the same cross-entropy on class ids (a language model's next-token ids)."""

import torch

import tinynn_autograd_tpu_torch.ops as ops
from tinynn_autograd_tpu_torch.core.tensor import as_tensor, to_torch


class BaseLoss:

    def loss(self, predicted, actual):
        raise NotImplementedError

    def __call__(self, predicted, actual):
        return self.loss(predicted, actual)


class SoftmaxCrossEntropyLoss(BaseLoss):
    """L = mean_i  w_i * (-sum_c labels[i,c] * log_softmax(logits)[i,c])

    ``labels`` is one-hot [m, C]. ``weight`` is an optional per-class [C]
    vector; each sample's NLL is scaled by the weight of its true class.
    The denominator is m (sample count).
    """

    def __init__(self, weight=None):
        self._weight = (to_torch(weight, dtype=torch.float32)
                        if weight is not None else None)

    def loss(self, logits, labels):
        logits = as_tensor(logits)
        labels = as_tensor(labels, logits.device)
        m = logits.shape[0]
        log_p = ops.log_softmax_(logits, axis=-1)
        nll = -(log_p * labels).sum(axis=1, keepdims=True)
        if self._weight is not None:
            if self._weight.device != labels.device:
                self._weight = self._weight.to(labels.device)
            per_sample_w = (labels * self._weight).sum(axis=1, keepdims=True)
            nll = nll * per_sample_w
        return nll.sum() / m


class SparseSoftmaxCrossEntropyLoss(BaseLoss):
    """L = mean over every position of -log_softmax(logits)[id]: logits
    [..., C] and int class ids [...] of the same leading shape (a language
    model's next-token ids [B, T] against its logits [B, T, vocab]). No
    one-hot rows are made."""

    def loss(self, logits, ids):
        logits = as_tensor(logits)
        n_classes = logits.shape[-1]
        log_p = ops.log_softmax_(logits.reshape((-1, n_classes)), axis=-1)
        index = to_torch(ids).to(log_p.device).reshape(-1, 1)
        return -ops.take_along_axis_(log_p, index).mean()


class MSELoss(BaseLoss):
    """Mean over the batch of each sample's sum of squared errors."""

    def loss(self, predicted, actual):
        predicted = as_tensor(predicted)
        actual = as_tensor(actual, predicted.device)
        m = predicted.shape[0]
        return ((predicted - actual) ** 2).sum() / m
