"""Moonlight-16B-A3B (the DeepSeek-V3 layout: multi-head latent attention,
a leading dense SwiGLU layer, then 64 routed and 2 shared SwiGLU experts
behind a sigmoid top-6 router) as the program builds it:
``build_mla_moe_lm`` at the configuration's published widths, with its cut
(``layers`` of ``num_hidden_layers``, ``experts_held`` of
``n_routed_experts``, a ``vocab`` slice); softmax cross-entropy of every
position's next-token id."""

from tinynn_autograd_tpu_torch.models import build_mla_moe_lm
from tinynn_autograd_tpu_torch.nn.losses import SparseSoftmaxCrossEntropyLoss


def net(config, traffic):
    return build_mla_moe_lm(
        vocab=config["vocab"], dim=config["hidden_size"],
        heads=config["num_attention_heads"],
        qk_nope_dim=config["qk_nope_head_dim"],
        qk_rope_dim=config["qk_rope_head_dim"],
        v_dim=config["v_head_dim"], kv_rank=config["kv_lora_rank"],
        n_layers=config["layers"],
        first_dense=config["first_k_dense_replace"],
        dense_width=config["intermediate_size"],
        num_experts=config["n_routed_experts"],
        top_k=config["num_experts_per_tok"],
        expert_width=config["moe_intermediate_size"],
        shared_width=(config["n_shared_experts"]
                      * config["moe_intermediate_size"]),
        experts_held=range(config["experts_held"]),
        routed_scaling=config["routed_scaling_factor"],
        rope_theta=config["rope_theta"], eps=config["rms_norm_eps"])


def loss(config):
    return SparseSoftmaxCrossEntropyLoss()


def small(config, traffic):
    """The CPU tests' cut: hidden 64, 4 heads of 24 (16 + a rotated 8) for
    queries and keys and 16 for values, a latent of 16, a dense layer of
    96, 8 experts of width 24 (top 3, 4 held) and 2 shared, 16 tokens, the
    dense layer and 4 expert layers, 32 ids."""
    config = dict(config, hidden_size=64, num_attention_heads=4,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  kv_lora_rank=16, intermediate_size=96,
                  n_routed_experts=8, num_experts_per_tok=3,
                  experts_held=4, moe_intermediate_size=24, vocab=32)
    traffic = dict(traffic, batch=4, seq_len=16, warmup_units=1,
                   trace_units=2, data=dict(traffic["data"], n_seq=16))
    return config, traffic
