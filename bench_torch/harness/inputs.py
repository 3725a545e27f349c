"""Everything a run makes from its ``--seed``: the data and the initial
weights, on the device with a ``torch.Generator`` there, in a few large
calls. The program gets only what is made here; the plain references make
the same tensors again from the same seed.

Each use draws from a generator of its own (``generator(seed, stream)``),
so the data do not depend on the weights' sizes, nor the order of the
batches on either.
"""

import importlib
import math

import torch

DATA, WEIGHTS, ORDER = 1, 2, 3


def generator(seed, stream, device):
    """A generator on ``device`` for ``stream`` of ``seed`` (any whole number
    of 64 bits or fewer)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def make_data(config, traffic, seed, device):
    """The run's data, drawn by the traffic's data kind
    (``data/<kind>.py``) from the seed's data stream."""
    kind = importlib.import_module("data.%s" % traffic["data"]["kind"])
    return kind.make(generator(seed, DATA, device), config, traffic, device)


def make_params(spec, seed, device):
    """The initial weights of a parameter ``spec`` [(name, shape, law)]:
    "xavier" U(-a, a) with a = sqrt(6 / (fan_in + fan_out)) of a 2-D
    [fan_in, fan_out] leaf, "normal" N(0, 0.02^2), "zeros", "ones" (the
    program's own initializers' laws). One uniform and one normal draw on
    the device for all leaves; returns {name: contiguous f32 tensor}."""
    gen = generator(seed, WEIGHTS, device)
    sizes = {law: sum(math.prod(shape) for _, shape, lw in spec if lw == law)
             for law in ("xavier", "normal")}
    pools = {"xavier": torch.rand(sizes["xavier"], generator=gen,
                                  device=device),
             "normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device)}
    offsets = {"xavier": 0, "normal": 0}
    out = {}
    for name, shape, law in spec:
        n = math.prod(shape)
        if law in pools:
            draw = pools[law][offsets[law]:offsets[law] + n].view(shape)
            offsets[law] += n
            if law == "xavier":
                a = math.sqrt(6.0 / (shape[0] + shape[1]))
                out[name] = (2.0 * a) * draw - a
            else:
                out[name] = 0.02 * draw
        elif law in ("zeros", "ones"):
            out[name] = torch.full(shape, 1.0 if law == "ones" else 0.0,
                                   device=device)
        else:
            raise ValueError("unknown law %r of %s" % (law, name))
    return out
