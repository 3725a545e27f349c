"""Next-token data: uniform ids [n_seq, seq_len + 1] over the
configuration's ``vocab`` drawn on the device; ``x`` the first
``seq_len`` of each row, ``y`` the row shifted by one, the next id of each
position: [n_seq, seq_len] class ids."""

import torch


def make(gen, config, traffic, device):
    ids = torch.randint(0, config["vocab"],
                        (traffic["data"]["n_seq"], traffic["seq_len"] + 1),
                        generator=gen, device=device)
    return {"x": ids[:, :-1].contiguous(), "y": ids[:, 1:].contiguous()}
