"""Offline metric evaluators: the ``evaluate(predictions, targets) -> dict``
classmethod contract of the JAX package's nn/evaluator.py, for accuracy."""

import numpy as np


def _to_np(x):
    from tinynn_autograd_tpu_torch.core.tensor import Tensor

    if isinstance(x, Tensor):
        return x.numpy()
    return np.asarray(x)


class BaseEvaluator:

    @classmethod
    def evaluate(cls, predictions, targets):
        raise NotImplementedError("Must specify evaluator.")


class AccEvaluator(BaseEvaluator):

    @classmethod
    def evaluate(cls, predictions, targets):
        predictions, targets = _to_np(predictions), _to_np(targets)
        total_num = len(predictions)
        hit_num = int(np.sum(predictions == targets))
        return {
            "total_num": total_num,
            "hit_num": hit_num,
            "accuracy": 1.0 * hit_num / total_num,
        }
