from tinynn_autograd_tpu_torch.models.mlp import build_deep_mlp, build_mnist_mlp
from tinynn_autograd_tpu_torch.models.moe_lm import (
    build_mla_moe_lm, build_moe_lm,
)
from tinynn_autograd_tpu_torch.models.rnn import build_rnn_classifier
from tinynn_autograd_tpu_torch.models.transformer import build_tiny_transformer

__all__ = ["build_mnist_mlp", "build_deep_mlp", "build_tiny_transformer",
           "build_rnn_classifier", "build_moe_lm", "build_mla_moe_lm"]
