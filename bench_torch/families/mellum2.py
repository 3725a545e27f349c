"""Mellum 2 (a decoder LM with 64 SwiGLU experts in every layer) as the
program builds it: ``build_moe_lm`` at the configuration's published
widths, with its cut (``layers`` of ``layer_types``, ``experts_held`` of
``num_experts``, a ``vocab`` slice); its router renormalises the top-k
weights (``norm_topk_prob``); softmax cross-entropy of every position's
next-token id."""

from tinynn_autograd_tpu_torch.models import build_moe_lm
from tinynn_autograd_tpu_torch.nn.losses import SparseSoftmaxCrossEntropyLoss


def yarn(config):
    """The full layers' YaRN parameters, or None where they rotate plain."""
    rope = config["rope_parameters"]["full_attention"]
    return rope if rope["rope_type"] == "yarn" else None


def net(config, traffic):
    return build_moe_lm(
        vocab=config["vocab"], dim=config["hidden_size"],
        heads=config["num_attention_heads"],
        kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
        layer_types=config["layer_types"][:config["layers"]],
        window=config["sliding_window"], num_experts=config["num_experts"],
        top_k=config["num_experts_per_tok"],
        expert_width=config["moe_intermediate_size"],
        experts_held=range(config["experts_held"]),
        rope_theta=config["rope_parameters"]["sliding_attention"]
        ["rope_theta"], yarn=yarn(config), eps=config["rms_norm_eps"])


def loss(config):
    return SparseSoftmaxCrossEntropyLoss()


def small(config, traffic):
    """The CPU tests' cut: hidden 64, 4 query and 2 KV heads of 16, 8
    experts of width 24 (top 3, 4 held), a window of 4 over 16 tokens, one
    whole period of layer types, 32 ids."""
    config = dict(config, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, num_experts=8,
                  num_experts_per_tok=3, experts_held=4,
                  moe_intermediate_size=24, sliding_window=4, vocab=32)
    traffic = dict(traffic, batch=4, seq_len=16, warmup_units=1,
                   trace_units=2, data=dict(traffic["data"], n_seq=16))
    return config, traffic
