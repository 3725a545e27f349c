"""Plain reference of the toy next-token language model: token and learned
position embeddings, causal pre-LN blocks as ``reference/transformer.py``
has them, and a linear head over the vocabulary at every position. Its
loss takes the next-token ids as they are. The parameters are named
"<i>.<key>" after the position i of their layer in the program's net: the
embedding 0, the position table 1, the blocks 2 .. depth + 1, the head
depth + 2."""

import torch.nn.functional as F

from reference import transformer
from reference.common import mm


def param_spec(config, traffic):
    d, vocab = config["dim"], config["vocab"]
    sizes = {"1": 1, "d": d, "h": d * config["mlp_ratio"]}
    spec = [("0.w", (vocab, d), "normal"),
            ("1.pos", (1, traffic["seq_len"], d), "normal")]
    for block in range(config["depth"]):
        spec += [("%d.%s" % (2 + block, key),
                  tuple(sizes[s] for s in shape.split()), transformer._law(key))
                 for key, shape in transformer.BLOCK]
    head = config["depth"] + 2
    return spec + [("%d.w" % head, (d, vocab), "xavier"),
                   ("%d.b" % head, (1, vocab), "zeros")]


def forward(params, config, ids, precision):
    x = params["0.w"][ids] + params["1.pos"]
    for block in range(config["depth"]):
        prefix = "%d." % (2 + block)
        p = {k[len(prefix):]: v for k, v in params.items()
             if k.startswith(prefix)}
        x = transformer._block(p, x, config["heads"], True, precision)
    head = config["depth"] + 2
    return mm(x, params["%d.w" % head], precision) + params["%d.b" % head]


def loss(logits, ids):
    """The mean over all positions of each next-token id's cross-entropy."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           ids.reshape(-1))
