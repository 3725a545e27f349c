"""The recurrent model family: stacked LSTM or GRU sequence classifiers and
regressors, as in the JAX package's models/rnn.py. Each recurrent layer is
one tape primitive, whose forward and backward are one recurrent kernel
launch each on a GPU (ops/recurrent.py)."""

from tinynn_autograd_tpu_torch.nn.layers import GRU, LSTM, Dense
from tinynn_autograd_tpu_torch.nn.net import Net

_CELLS = {"lstm": LSTM, "gru": GRU}


def build_rnn_classifier(num_in, num_out, hidden=(64,), cell="lstm",
                         seed=None):
    """Stacked recurrent classifier over [B, T, num_in] -> [B, num_out]
    logits. All but the last recurrent layer return full sequences, so that
    stacking composes; the last returns its final hidden state, followed by
    a Dense head. ``cell`` is "lstm" or "gru"."""
    cell_cls = _CELLS[cell]
    layers = []
    prev = num_in
    for i, h in enumerate(hidden):
        last = i == len(hidden) - 1
        layers.append(cell_cls(
            h, num_in=prev, return_sequences=not last,
            seed=None if seed is None else seed + i))
        prev = h
    layers.append(Dense(num_out, num_in=prev,
                        seed=None if seed is None else seed + len(hidden)))
    return Net(layers)
