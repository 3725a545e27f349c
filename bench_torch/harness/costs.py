"""Operations and bytes of the work the benchmark's shapes need, and the one
peak rule every roofline and MFU share of the benchmark is read against.

The peak rule (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): an
f32 product counts at 164.9 TFLOP/s, the dense TF32 tensor-core peak of
494.7 divided by three, since 3xTF32 (three TF32 products) is the fastest
route to f32-accurate products on this chip and the one the attention
kernels take. Bytes count each input read once and each output written
once, at 3.35 TB/s of HBM3. A kernel's least time is the larger of its
operations over the first and its bytes over the second. A share counts
the work the shapes need, whatever kernel does it: no recomputation, no
re-reads, so no faster kernel can read above 100%.

Adapted from chip_smoke.py's ``bound``, ``product_cost``, ``epoch_cost``,
``visible_pairs`` and ``attention_costs``, which used two peaks (67 TFLOP/s
f32 FMA, and 3xTF32 for attention alone).
"""

PEAK_TF32_DENSE = 494.7e12
PEAK_FLOPS = PEAK_TF32_DENSE / 3.0
PEAK_BYTES = 3.35e12
F32 = 4


def bound_s(flops, n_bytes):
    """The least seconds the card could take for ``flops`` f32 operations
    and ``n_bytes`` of traffic."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def product_cost(m, k, n):
    """(FLOPs, bytes) of one f32 [m, k] @ [k, n]: both inputs read once,
    the output written once."""
    return 2.0 * m * k * n, F32 * (m * k + k * n + m * n)


def mlp_dims(config):
    """(fan_in, fan_out) of each Dense layer of an MLP configuration."""
    sizes = [config["num_in"]] + list(config["hidden"]) + [config["num_out"]]
    return list(zip(sizes[:-1], sizes[1:]))


def mlp_products(config, rows, train=True):
    """The f32 products an MLP step on ``rows`` rows needs, as (m, k, n):
    each layer's forward; with ``train`` each layer's dW and each dX but
    the first layer's (its input needs no gradient)."""
    dims = mlp_dims(config)
    out = [(rows, i, o) for i, o in dims]
    if train:
        out += [(i, rows, o) for i, o in dims]
        out += [(rows, o, i) for i, o in dims[1:]]
    return out


def products_flops(products):
    return sum(product_cost(*p)[0] for p in products)


def products_bound_s(products):
    """The least seconds of a set of launches, one product each."""
    return sum(bound_s(*product_cost(*p)) for p in products)


def k2_epoch_cost(config, n_steps, batch, n_slots=2):
    """(FLOPs, bytes) of one whole-epoch launch: the products of
    ``n_steps`` train steps (the elementwise work, about 2% more, left
    out); the batches, the losses, and the parameters and the optimizer's
    ``n_slots`` slots read once and written once."""
    dims = mlp_dims(config)
    flops = n_steps * products_flops(mlp_products(config, batch))
    leaves = sum(i * o + o for i, o in dims)
    n_bytes = F32 * (n_steps * batch * (dims[0][0] + dims[-1][1]) + n_steps
                     + 2 * (1 + n_slots) * leaves)
    return flops, n_bytes


def visible_pairs(t, causal):
    """The (query, key) pairs of one head that the mask leaves visible."""
    return t * (t + 1) // 2 if causal else t * t


def attention_costs(batch, heads, t, head_dim, causal):
    """(FLOPs, bytes) of one attention layer's forward and of its backward,
    on the visible pairs only. Forward: S = QK^T and P.V, 4 d FLOPs a
    pair; q, k, v read, o and the row statistics written. Backward:
    dP = dO.V^T, dV = P^T.dO, dQ = dS.K and dK = dS^T.Q, 8 d a pair, with
    S not recomputed; q, k, v, dO and the row statistics read (two rows a
    query), dq, dk and dv written."""
    pairs = batch * heads * visible_pairs(t, causal)
    qkv = batch * heads * t * head_dim
    rows = batch * heads * t
    forward = (4.0 * pairs * head_dim, F32 * (4 * qkv + rows))
    backward = (8.0 * pairs * head_dim, F32 * (7 * qkv + 2 * rows))
    return forward, backward


def transformer_step_flops(config, batch, t):
    """FLOPs of one train step of the transformer classifier at ``batch``
    sequences of ``t`` tokens: every block's six products (q, k, v, the
    output projection, the MLP's two) forward, dW and dX (the blocks'
    inputs need gradients: the embeddings are trained), attention's 4 d a
    visible pair forward and 8 d backward, and the head's products on the
    pooled rows. The embedding lookups, layer norms and elementwise work
    are left out."""
    d, hidden = config["dim"], config["dim"] * config["mlp_ratio"]
    tokens = batch * t
    block_macs = 4 * d * d + 2 * d * hidden
    dense = 3 * 2.0 * tokens * block_macs * config["depth"]
    fwd, bwd = attention_costs(batch, config["heads"], t,
                               d // config["heads"], config["causal"])
    attn = (fwd[0] + bwd[0]) * config["depth"]
    head = 3 * 2.0 * batch * d * config["num_out"]
    return dense + attn + head
