from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn import layers, losses, optimizer, initializer, evaluator

__all__ = [
    "Net", "Model", "layers", "losses", "optimizer", "initializer",
    "evaluator",
]
