"""Tiny transformer sequence classifier, as in the JAX package's
models/transformer.py: embeddings, pre-LN transformer blocks whose attention
core is the flash-attention primitive, mean pooling and a linear head."""

from tinynn_autograd_tpu_torch.nn.layers import (
    Dense, Embedding, GlobalAvgPool1D, PositionalEmbedding, TransformerBlock,
)
from tinynn_autograd_tpu_torch.nn.net import Net


def build_tiny_transformer(vocab=32, seq_len=16, dim=64, heads=4, depth=2,
                           num_out=10, causal=False, mlp_ratio=4,
                           dropout=0.0, attn_dropout=0.0, attn_window=None,
                           compute_dtype=None):
    """int token ids [B, T] -> class logits [B, num_out]."""
    layers = [Embedding(vocab, dim), PositionalEmbedding(seq_len, dim)]
    for _ in range(depth):
        layers.append(TransformerBlock(dim, heads, mlp_ratio=mlp_ratio,
                                       causal=causal, dropout=dropout,
                                       attn_dropout=attn_dropout,
                                       attn_window=attn_window,
                                       compute_dtype=compute_dtype))
    layers += [GlobalAvgPool1D(),
               Dense(num_out, num_in=dim, compute_dtype=compute_dtype)]
    return Net(layers)
