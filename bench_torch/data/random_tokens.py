"""Config 6b's data: uniform token ids [n_seq, seq_len] and uniform labels,
one-hot [n_seq, num_out]."""

import torch


def make(gen, config, traffic, device):
    n_seq, seq_len = traffic["data"]["n_seq"], traffic["seq_len"]
    x = torch.randint(0, config["vocab"], (n_seq, seq_len), generator=gen,
                      device=device)
    labels = torch.randint(0, config["num_out"], (n_seq,), generator=gen,
                           device=device)
    return {"x": x,
            "y": torch.nn.functional.one_hot(labels, config["num_out"]).float()}
