from tinynn_autograd_tpu_torch.core.tensor import Tensor, as_tensor

__all__ = ["Tensor", "as_tensor"]
