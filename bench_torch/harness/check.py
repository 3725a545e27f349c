"""The comparison that decides ``correct``.

A run's set-up drives the model that the window then trains through the
window's own entry from the seed's weights: the eval's logits of the whole
test set at those weights (cells with an eval), then three train steps on
rows that all differ (0-B, B-2B, 2B-3B of the staged training set, in that
order). The first step is one call and the other two one more: for
``train_epoch`` a one-step epoch, whose optimizer state can be read, then
a two-step epoch, so that the whole-epoch kernel loops over its steps
inside one launch, starting from the state the first launch wrote back;
for ``train_step`` three calls. The plain reference of the configuration
follows the same three steps from the same seed once the window has
closed and the model is freed. The numbers, of which each cell compares
those its limits name (``workloads/<cell>.json``):

- "loss": the relative gap of the first step's loss. The later steps'
  losses are not compared: Adam's first steps are sign-like, so a gradient
  element within rounding of 0 (or a ReLU input within rounding of 0)
  steps the other way in one of the two and moves the next losses by up
  to 2e-5 of themselves on some seeds;
- "grad": the first step's gradient as the optimizer got it, m / (1 - b1)
  from Adam's state after one step, by the worst leaf: the gap between
  the program's and the reference's norms of the leaf, over the larger of
  the reference's norm of that leaf and of the median leaf;
- "change": each leaf's change over the three steps, by the worst leaf as
  "grad", leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off);
- "change_first": the same over the first step alone;
- "state": Adam's m and v after the third step: for each, the median
  over the leaves of the leaf's gap as "grad"; the larger of the two (v
  alone carries beta2, and both carry the state from one call to the
  next). The median, since the worst leaf inherits the later steps'
  sign-like noise of one small leaf;
- "logits": the eval's largest gap of a logit over the largest logit of
  the reference.
"""

import importlib
import statistics

import torch

from harness import inputs

N_STEPS = 3
QUIET_LEAF = 1e-3


def reference_module(config):
    return importlib.import_module("reference.%s" % config["family"])


def _batches(data, batch):
    return [(data["x"][i * batch:(i + 1) * batch],
             data["y"][i * batch:(i + 1) * batch]) for i in range(N_STEPS)]


def _train(model, traffic, batches):
    """The losses of ``batches`` trained through the window's entry in one
    call (``train_epoch``: one launch, in order) or one call a batch."""
    if traffic["entry"] == "train_epoch":
        x = torch.cat([b[0] for b in batches])
        y = torch.cat([b[1] for b in batches])
        return [float(v) for v in model.train_epoch(
            x, y, batch_size=traffic["batch"], shuffle=False,
            fused=traffic["fused"])]
    return [float(model.train_step(x, y)) for x, y in batches]


def program_readings(model, data, traffic, config):
    """Drive ``model`` through the check's first steps; returns its
    readings."""
    from harness import program

    out = {"logits": None}
    if traffic.get("eval"):
        out["logits"] = program.logits(model, data["x_test"]).clone()
    before = {k: v.clone() for k, v in program.leaves(model).items()}
    b1 = config["optimizer"]["beta1"]
    batches = _batches(data, traffic["batch"])
    losses = _train(model, traffic, batches[:1])
    out["grad"] = {k: m / (1.0 - b1)
                   for k, m in program.moments(model)["m"].items()}
    out["change_first"] = {k: v - before[k]
                           for k, v in program.leaves(model).items()}
    losses += _train(model, traffic, batches[1:])
    out["losses"] = losses
    out["change"] = {k: v - before[k]
                     for k, v in program.leaves(model).items()}
    out["state"] = {slot: {k: v.clone() for k, v in leaves.items()}
                    for slot, leaves in program.moments(model).items()}
    return out


def reference_readings(config, traffic, seed, device, precision="f32",
                       fault=None):
    """The plain reference's readings of the same steps and eval, from its
    own weights and data made again from the seed, trained on the
    reference module's ``loss(logits, y)`` where it has one, else on
    ``common.cross_entropy`` (one-hot rows)."""
    from reference import common

    common.exact()
    ref = reference_module(config)
    params = inputs.make_params(ref.param_spec(config, traffic), seed, device)
    data = inputs.make_data(config, traffic, seed, device)

    def forward(p, x, prec):
        return ref.forward(p, config, x, prec)

    out = common.train_readings(forward, getattr(ref, "loss",
                                                 common.cross_entropy),
                                params, _batches(data, traffic["batch"]),
                                config["optimizer"], precision, fault)
    out["logits"] = None
    if traffic.get("eval"):
        out["logits"] = common.eval_logits(forward, params, data["x_test"],
                                           precision, fault)
    return out


def _norms(tree):
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _leaf_gaps(got, want, keep=None):
    got, want = _norms(got), _norms(want)
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return [abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in names]


def compare(got, want):
    """The numbers, from the program's (or a stand-in's) readings ``got``
    and the reference's ``want``."""
    out = {"loss": abs(got["losses"][0] - want["losses"][0])
           / abs(want["losses"][0])}
    out["grad"] = max(_leaf_gaps(got["grad"], want["grad"]))
    grad_norms = _norms(want["grad"])
    median = statistics.median(grad_norms.values())
    keep = {k for k, n in grad_norms.items() if n >= QUIET_LEAF * median}
    for name in ("change", "change_first"):
        out[name] = max(_leaf_gaps(got[name], want[name], keep))
    out["state"] = max(statistics.median(_leaf_gaps(got["state"][slot],
                                                    want["state"][slot]))
                       for slot in want["state"])
    if want["logits"] is not None:
        z, z_ref = got["logits"].double(), want["logits"].double()
        out["logits"] = float((z - z_ref).abs().max() / z_ref.abs().max())
    if not all(n == n for n in out.values()):
        out = {k: (float("inf") if n != n else n) for k, n in out.items()}
    return out


def judge(numbers, limits):
    """{name: {"value", "limit"}} of the numbers ``limits`` names, and
    whether each is within its limit."""
    checks = {k: {"value": numbers[k], "limit": limit}
              for k, limit in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def free_device():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
