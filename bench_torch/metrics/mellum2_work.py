"""Not a metric: the work of one train step of the ``mellum2`` family at
the cell's shapes, which its readers share (operations and bytes by the
peak rule of ``harness/costs.py``).

- K1's products: each layer's q, k, v and o projections and its router,
  and the head, each forward, dX and dW over all the step's tokens (the
  embedding is trained, so every layer's input needs its gradient); each
  held expert's three products forward and six backward (dh, ddown, dX's
  two, dgate, dup) over its rows, taken here as the step's routed pairs
  (``moe.routed_pairs``, from the program's table) shared evenly among the
  held experts of each layer: the products are bound by their operations
  at these sizes, so the split among experts does not move the sum.
- Attention: the (query, key) pairs the mask leaves visible, a
  ``sliding_window`` band on sliding layers and the causal triangle on
  full ones, times the query heads, at 4 d FLOPs a pair forward and 8 d
  backward, as ``costs.attention_costs`` counts them; bytes with k and v
  at the kv heads.
"""

from harness import manifest


def routed_pairs(config):
    """The (token, held expert) pairs a step computed in the traced
    stretch: the program's ``moe.routed_pairs`` over its ``tinynn.moe``
    calls, times the layers; None where the program counts neither."""
    table = manifest.reader("program_totals").table()
    pairs, calls = table.get("moe.routed_pairs"), table.get("tinynn.moe")
    if not pairs or not calls or not calls["count"]:
        return None
    return pairs / calls["count"] * config["layers"]


def _trained(forward):
    """Each (m, k, n) product forward, its dX and its dW."""
    return [p for m, k, n in forward for p in ((m, k, n), (m, n, k),
                                               (k, m, n))]


def products(config, tokens, pairs):
    """The step's K1 products as (m, k, n), with ``pairs`` routed pairs
    (rounded to whole rows an expert)."""
    d, hd = config["hidden_size"], config["head_dim"]
    q = config["num_attention_heads"] * hd
    kv = config["num_key_value_heads"] * hd
    width, held = config["moe_intermediate_size"], config["experts_held"]
    rows = max(1, round(pairs / config["layers"] / held))
    layer = _trained([(tokens, d, q), (tokens, d, kv), (tokens, d, kv),
                      (tokens, q, d), (tokens, d, config["num_experts"])])
    expert = [(rows, d, width), (rows, d, width), (rows, width, d),
              (rows, d, width), (width, rows, d), (rows, width, d),
              (rows, width, d), (d, rows, width), (d, rows, width)]
    return (config["layers"] * (layer + held * expert)
            + _trained([(tokens, d, config["vocab"])]))


def visible_pairs(t, window):
    """The (query, key) pairs of one head at positions 0..t-1 that a causal
    mask leaves visible, banded to ``window`` keys where given."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def attention_costs(config, batch, t, window):
    """((FLOPs, bytes) forward, (FLOPs, bytes) backward) of one layer."""
    f32, hd = 4, config["head_dim"]
    h, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    pairs = batch * h * visible_pairs(t, window)
    q, kv, rows = batch * h * t * hd, batch * hkv * t * hd, batch * h * t
    forward = (4.0 * pairs * hd, f32 * (2 * q + 2 * kv + rows))
    backward = (8.0 * pairs * hd, f32 * (3 * q + 4 * kv + 2 * rows))
    return forward, backward


def attention_layers(config, batch, t):
    """Each layer's attention costs, in order."""
    return [attention_costs(config, batch, t,
                            config["sliding_window"]
                            if kind == "sliding_attention" else None)
            for kind in config["layer_types"][:config["layers"]]]


def step_flops(costs, config, traffic, pairs):
    """The FLOPs of a train step: K1's products and attention's pairs (the
    norms, rotations, routing and elementwise work left out)."""
    batch, t = traffic["batch"], traffic["seq_len"]
    attention = sum(fwd[0] + bwd[0]
                    for fwd, bwd in attention_layers(config, batch, t))
    return costs.products_flops(products(config, batch * t, pairs)) \
        + attention
