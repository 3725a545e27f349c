"""Decoder language models with sparse experts: int token ids [B, T] ->
next-token logits [B, T, vocab].

``build_moe_lm`` (the Mellum 2 layout): each layer is an ``AttentionBlock``
(pre-RMSNorm, RoPE, grouped-query attention, sliding-window or full) and a
``TokenChoiceMoE`` (pre-RMSNorm, top-k routing over SwiGLU experts), in that
order. ``build_mla_moe_lm`` (the DeepSeek-V3 layout): each layer is a
``LatentAttentionBlock`` (multi-head latent attention) and, in the leading
dense layers, a ``SwiGLU`` MLP, after them a ``TokenChoiceMoE`` with a
sigmoid router and a shared expert. In both a final ``RMSNorm`` and an
untied head without bias close the net. Nothing has a bias.
"""

from tinynn_autograd_tpu_torch.nn.layers import (
    AttentionBlock, Dense, Embedding, LatentAttentionBlock, RMSNorm, SwiGLU,
    TokenChoiceMoE,
)
from tinynn_autograd_tpu_torch.nn.net import Net

LAYER_TYPES = ("sliding_attention", "full_attention")


def build_moe_lm(vocab, dim, heads, kv_heads, head_dim, layer_types,
                 window, num_experts, top_k, expert_width, experts_held=None,
                 rope_theta=10000.0, yarn=None, eps=1e-6):
    """The net, one layer per entry of ``layer_types``: a
    "sliding_attention" layer bands its attention to ``window`` keys and
    rotates by the plain tables of ``rope_theta``; a "full_attention"
    layer attends to every earlier key and rotates by YaRN's tables of
    ``rope_theta`` where ``yarn`` gives its parameters, else the plain
    ones. Every layer holds the experts ``experts_held`` (all
    ``num_experts`` by default) of its router over ``num_experts``.

    The net's layers: the embedding, then each layer's attention and
    expert blocks, then the final norm and the head."""
    layers = [Embedding(vocab, dim)]
    for kind in layer_types:
        if kind not in LAYER_TYPES:
            raise ValueError("layer type %r is not one of %s"
                             % (kind, LAYER_TYPES))
        full = kind == "full_attention"
        layers.append(AttentionBlock(
            dim, heads, kv_heads, head_dim, window=None if full else window,
            rope_theta=rope_theta, yarn=yarn if full else None, eps=eps))
        layers.append(TokenChoiceMoE(
            dim, expert_width, num_experts, top_k, experts_held=experts_held,
            eps=eps))
    layers += [RMSNorm(dim, eps=eps), Dense(vocab, num_in=dim, bias=False)]
    return Net(layers)


def build_mla_moe_lm(vocab, dim, heads, qk_nope_dim, qk_rope_dim, v_dim,
                     kv_rank, n_layers, first_dense, dense_width, num_experts,
                     top_k, expert_width, shared_width, experts_held=None,
                     routed_scaling=1.0, rope_theta=10000.0, eps=1e-6):
    """The net, ``n_layers`` layers: each a ``LatentAttentionBlock`` (query
    and key heads of ``qk_nope_dim`` + ``qk_rope_dim``, value heads of
    ``v_dim``, a latent of ``kv_rank``), then in the first ``first_dense``
    layers a ``SwiGLU`` of ``dense_width``, in the others a
    ``TokenChoiceMoE`` of ``expert_width`` with a sigmoid router (top
    ``top_k`` of ``num_experts``, weights scaled by ``routed_scaling``),
    holding ``experts_held`` (all by default), and a shared expert of
    ``shared_width``.

    The net's layers: the embedding, then each layer's attention and MLP
    or expert blocks, then the final norm and the head."""
    layers = [Embedding(vocab, dim)]
    for i in range(n_layers):
        layers.append(LatentAttentionBlock(
            dim, heads, qk_nope_dim, qk_rope_dim, v_dim, kv_rank,
            rope_theta=rope_theta, eps=eps))
        if i < first_dense:
            layers.append(SwiGLU(dim, dense_width, eps=eps))
        else:
            layers.append(TokenChoiceMoE(
                dim, expert_width, num_experts, top_k,
                experts_held=experts_held, eps=eps, scoring="sigmoid",
                routed_scaling=routed_scaling, shared_width=shared_width))
    layers += [RMSNorm(dim, eps=eps), Dense(vocab, num_in=dim, bias=False)]
    return Net(layers)
