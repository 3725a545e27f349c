"""``utils/datasets.synthetic_mnist``'s task drawn on the device: a shared
sparse background and a sparse signature per class make 10 prototypes;
each row keeps half its prototype's pixels at random and adds uniform
noise of 0.85 at most, clipped to [0, 1]. The train rows [n_train,
num_in] with one-hot labels [n_train, num_out], and the test rows with
their class indices."""

import torch


def make(gen, config, traffic, device):
    n_train, n_test = traffic["data"]["n_train"], traffic["data"]["n_test"]
    dim, classes = config["num_in"], config["num_out"]
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
