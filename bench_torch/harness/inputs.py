"""Everything a run makes from its ``--seed``: the data and the initial
weights, on the device with a ``torch.Generator`` there, in a few large
calls. The program gets only what is made here; the plain references make
the same tensors again from the same seed.

Each use draws from a generator of its own (``generator(seed, stream)``),
so the data do not depend on the weights' sizes, nor the order of the
batches on either.
"""

import math

import torch

DATA, WEIGHTS, ORDER = 1, 2, 3


def generator(seed, stream, device):
    """A generator on ``device`` for ``stream`` of ``seed`` (any whole number
    of 64 bits or fewer)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def synthetic_mnist(gen, n_train, n_test, dim, classes, device):
    """``utils/datasets.synthetic_mnist``'s task drawn on the device: a shared
    sparse background and a sparse signature per class make 10
    prototypes; each row keeps half its prototype's pixels at random and
    adds uniform noise of 0.85 at most, clipped to [0, 1]. Returns the
    train rows [n_train, dim] with one-hot labels [n_train, classes], and
    the test rows with their class indices."""
    shared = (torch.rand(dim, generator=gen, device=device) > 0.8).float()
    signature = (torch.rand((classes, dim), generator=gen, device=device)
                 > 0.9).float()
    prototypes = torch.clamp(shared * 0.5 + signature * 0.38, 0.0, 1.0)

    def split(n):
        labels = torch.randint(0, classes, (n,), generator=gen, device=device)
        keep = torch.rand((n, dim), generator=gen, device=device) > 0.5
        noise = 0.85 * torch.rand((n, dim), generator=gen, device=device)
        x = torch.clamp(prototypes[labels] * keep + noise, 0.0, 1.0)
        return x, labels

    x, labels = split(n_train)
    x_test, labels_test = split(n_test)
    onehot = torch.nn.functional.one_hot(labels, classes).float()
    return {"x": x, "y": onehot, "x_test": x_test, "labels_test": labels_test}


def random_tokens(gen, n_seq, seq_len, vocab, classes, device):
    """Config 6b's data: uniform token ids [n_seq, seq_len] and uniform
    labels, one-hot [n_seq, classes]."""
    x = torch.randint(0, vocab, (n_seq, seq_len), generator=gen,
                      device=device)
    labels = torch.randint(0, classes, (n_seq,), generator=gen, device=device)
    return {"x": x, "y": torch.nn.functional.one_hot(labels, classes).float()}


def make_data(config, traffic, seed, device):
    data = traffic["data"]
    gen = generator(seed, DATA, device)
    if data["kind"] == "synthetic_mnist":
        return synthetic_mnist(gen, data["n_train"], data["n_test"],
                               config["num_in"], config["num_out"], device)
    if data["kind"] == "random_tokens":
        return random_tokens(gen, data["n_seq"], traffic["seq_len"],
                             config["vocab"], config["num_out"], device)
    raise ValueError("unknown data kind %r" % data["kind"])


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
