"""The data kinds, one module a kind, found by the traffic's
``data["kind"]`` (``harness/inputs.py``): ``make(gen, config, traffic,
device)`` draws the run's data from the generator ``gen`` on the device
and returns {"x", "y"} (and, for an eval, "x_test" and "labels_test").
``y`` holds the targets as the configuration's loss takes them: one-hot
rows [n, C] or class ids of any shape, such as next-token ids [n, T]."""
