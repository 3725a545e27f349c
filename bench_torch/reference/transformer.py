"""Plain reference of the transformer sequence classifier (the repository's
config 6b): token and learned position embeddings, pre-LN blocks
x + MHA(LN(x)) and x + MLP(LN(x)) with a tanh-GELU MLP, mean pooling over
the sequence and a linear head. Attention materialises the [T, T] scores
and masks the future with -inf. The parameters are named "<i>.<key>" after
the position i of their layer in the program's net: the embedding 0, the
position table 1, the blocks 2 .. depth + 1, the head depth + 3."""

import math

import torch
import torch.nn.functional as F

from reference.common import mm

BLOCK = (("wq", "d d"), ("wk", "d d"), ("wv", "d d"), ("wo", "d d"),
         ("w1", "d h"), ("b1", "1 h"), ("w2", "h d"), ("b2", "1 d"),
         ("g1", "1 d"), ("be1", "1 d"), ("g2", "1 d"), ("be2", "1 d"))


def _law(key):
    if key.startswith("g"):
        return "ones"
    if key.startswith("b"):
        return "zeros"
    return "xavier"


def param_spec(config, traffic):
    d = config["dim"]
    sizes = {"1": 1, "d": d, "h": d * config["mlp_ratio"]}
    spec = [("0.w", (config["vocab"], d), "normal"),
            ("1.pos", (1, traffic["seq_len"], d), "normal")]
    for block in range(config["depth"]):
        spec += [("%d.%s" % (2 + block, key),
                  tuple(sizes[s] for s in shape.split()), _law(key))
                 for key, shape in BLOCK]
    head = config["depth"] + 3
    spec += [("%d.w" % head, (d, config["num_out"]), "xavier"),
             ("%d.b" % head, (1, config["num_out"]), "zeros")]
    return spec


def _layer_norm(x, gamma, beta):
    return F.layer_norm(x, x.shape[-1:], gamma.reshape(-1), beta.reshape(-1),
                        eps=1e-5)


def _block(p, x, heads, causal, precision):
    b, t, d = x.shape
    hd = d // heads

    def split(y):
        return y.reshape(b, t, heads, hd).transpose(1, 2)

    xn = _layer_norm(x, p["g1"], p["be1"])
    q, k, v = (split(mm(xn, p[w], precision)) for w in ("wq", "wk", "wv"))
    scores = mm(q, k.transpose(-1, -2), precision) * (1.0 / math.sqrt(hd))
    if causal:
        future = torch.ones((t, t), dtype=torch.bool,
                            device=x.device).triu(1)
        scores = scores.masked_fill(future, float("-inf"))
    ctx = mm(torch.softmax(scores, dim=-1), v, precision)
    x = x + mm(ctx.transpose(1, 2).reshape(b, t, d), p["wo"], precision)
    yn = _layer_norm(x, p["g2"], p["be2"])
    hidden = F.gelu(mm(yn, p["w1"], precision) + p["b1"], approximate="tanh")
    return x + mm(hidden, p["w2"], precision) + p["b2"]


def forward(params, config, ids, precision):
    x = params["0.w"][ids] + params["1.pos"]
    for block in range(config["depth"]):
        prefix = "%d." % (2 + block)
        p = {k[len(prefix):]: v for k, v in params.items()
             if k.startswith(prefix)}
        x = _block(p, x, config["heads"], config["causal"], precision)
    head = config["depth"] + 3
    pooled = x.mean(dim=1)
    return mm(pooled, params["%d.w" % head], precision) \
        + params["%d.b" % head]
