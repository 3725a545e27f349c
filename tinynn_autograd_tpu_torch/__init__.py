"""tinynn_autograd_tpu_torch: the tape-based autodiff framework on PyTorch.

The PyTorch and CUDA port of ``tinynn_autograd_tpu``. Tensors wrap
``torch.Tensor``s, reverse-mode autodiff is the framework's own tape (not
``torch.autograd``), and the matmul under every Dense layer runs through a
hand-written CUDA kernel on the GPU (``ops/kernels.py``, ``csrc/matmul.cu``).
This package covers the MLP trainers and the transformer sequence
classifier, whose attention runs through hand-written flash-attention
kernels (``ops/attention.py``, ``csrc/attention.cu``); see ROADMAP.md for
what remains.
"""

from tinynn_autograd_tpu_torch.core.tensor import Tensor, as_tensor
from tinynn_autograd_tpu_torch import ops
from tinynn_autograd_tpu_torch.nn import Model, Net
from tinynn_autograd_tpu_torch.nn import layers, losses, optimizer, initializer, evaluator
from tinynn_autograd_tpu_torch import utils

__version__ = "0.1.0"

__all__ = [
    "Tensor", "as_tensor", "ops", "Model", "Net", "layers", "losses",
    "optimizer", "initializer", "evaluator", "utils", "__version__",
]
