from tinynn_autograd_tpu_torch.models.mlp import build_mnist_mlp

__all__ = ["build_mnist_mlp"]
