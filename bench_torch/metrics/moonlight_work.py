"""Not a metric: the work of one train step of the ``moonlight`` family at
the cell's shapes, which its readers share (operations and bytes by the
peak rule of ``harness/costs.py``).

- K1's products: each layer's q, kv_a, kv_b and o projections, the dense
  layer's SwiGLU and each expert layer's router and shared expert, and
  the head, each forward, dX and dW over all the step's tokens (the
  embedding is trained, so every layer's input needs its gradient); each
  held expert's three products forward and six backward (dh, ddown, dX's
  two, dgate, dup) over its rows, taken here as the step's routed pairs
  (``moe.routed_pairs``, from the program's table) shared evenly among the
  held experts of each expert layer: the products are bound by their
  operations at these sizes, so the split among experts does not move the
  sum. A SwiGLU's nine products are ``grouped_swiglu_``'s.
- Attention: the (query, key) pairs the causal mask leaves visible, times
  the heads, at 2 (d_qk + d_v) FLOPs a pair forward (S over d_qk, P V over
  d_v) and 4 (d_qk + d_v) backward (S and dQ, dK over d_qk; dP and dV over
  d_v), ``costs.attention_costs``' 4 d and 8 d at split head dims; bytes
  with q and k at d_qk and v, o, dO at d_v.
"""

from harness import manifest


def expert_layers(config):
    return config["layers"] - config["first_k_dense_replace"]


def routed_pairs(config):
    """The (token, held expert) pairs a step computed in the traced
    stretch: the program's ``moe.routed_pairs`` over its ``tinynn.moe``
    calls, times the expert layers; None where the program counts
    neither."""
    table = manifest.reader("program_totals").table()
    pairs, calls = table.get("moe.routed_pairs"), table.get("tinynn.moe")
    if not pairs or not calls or not calls["count"]:
        return None
    return pairs / calls["count"] * expert_layers(config)


def _trained(forward):
    """Each (m, k, n) product forward, its dX and its dW."""
    return [p for m, k, n in forward for p in ((m, k, n), (m, n, k),
                                               (k, m, n))]


def swiglu(rows, d, width):
    """The nine products of one SwiGLU MLP on ``rows`` rows, as
    ``grouped_swiglu_`` runs them."""
    return [(rows, d, width), (rows, d, width), (rows, width, d),
            (rows, d, width), (width, rows, d), (rows, width, d),
            (rows, width, d), (d, rows, width), (d, rows, width)]


def products(config, tokens, pairs):
    """The step's K1 products as (m, k, n), with ``pairs`` routed pairs
    (rounded to whole rows an expert)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    qk = config["qk_nope_head_dim"] + config["qk_rope_head_dim"]
    nv = config["qk_nope_head_dim"] + config["v_head_dim"]
    rank = config["kv_lora_rank"] + config["qk_rope_head_dim"]
    held = config["experts_held"]
    rows = max(1, round(pairs / expert_layers(config) / held))
    shared = config["n_shared_experts"] * config["moe_intermediate_size"]
    attention = _trained([(tokens, d, h * qk), (tokens, d, rank),
                          (tokens, config["kv_lora_rank"], h * nv),
                          (tokens, h * config["v_head_dim"], d)])
    dense = swiglu(tokens, d, config["intermediate_size"])
    experts = (_trained([(tokens, d, config["n_routed_experts"])])
               + held * swiglu(rows, d, config["moe_intermediate_size"])
               + swiglu(tokens, d, shared))
    return (config["layers"] * attention
            + config["first_k_dense_replace"] * dense
            + expert_layers(config) * experts
            + _trained([(tokens, d, config["vocab"])]))


def attention_costs(config, batch, t):
    """((FLOPs, bytes) forward, (FLOPs, bytes) backward) of one layer's
    causal attention at the split head dims."""
    f32, h = 4, config["num_attention_heads"]
    dqk = config["qk_nope_head_dim"] + config["qk_rope_head_dim"]
    dv = config["v_head_dim"]
    pairs = batch * h * (t * (t + 1) // 2)
    rows = batch * h * t
    forward = (2.0 * (dqk + dv) * pairs,
               f32 * (rows * (2 * dqk + 2 * dv) + rows))
    backward = (4.0 * (dqk + dv) * pairs,
                f32 * (rows * (4 * dqk + 3 * dv) + 2 * rows))
    return forward, backward


def attention_layers(config, batch, t):
    """Each layer's attention costs, in order."""
    return [attention_costs(config, batch, t)] * config["layers"]


def step_flops(costs, config, traffic, pairs):
    """The FLOPs of a train step: K1's products and attention's pairs (the
    norms, rotations, routing and elementwise work left out)."""
    batch, t = traffic["batch"], traffic["seq_len"]
    attention = sum(fwd[0] + bwd[0]
                    for fwd, bwd in attention_layers(config, batch, t))
    return costs.products_flops(products(config, batch * t, pairs)) \
        + attention
