"""The optimizer as the one owner of a step's update (nn/optimizer.py): the
kernel rules' codes and constants each class gives, ``update`` against a
leaf-by-leaf ``step_leaf`` loop, and the state's lifetime across the tiers
that train through it (the step loop, plain K2, the streaming tier and
DataParallel's two tiers). No JAX: the JAX optimizers' parity is
tests/test_torch_dense_stack.py's.
"""

import numpy as np
import pytest
import torch

from tinynn_autograd_tpu_torch.models import build_deep_mlp, build_mnist_mlp
from tinynn_autograd_tpu_torch.nn import optimizer, scheduler
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.ops import fused_epoch, streaming_epoch
from tinynn_autograd_tpu_torch.parallel import DataParallel, make_mesh
from tinynn_autograd_tpu_torch.utils import seeder

# Each rule built away from its defaults: its arguments, its code in
# csrc/optim_rules.cuh and the constants c0.. the kernels read, then one
# attribute set after construction and the constants it gives.
KERNEL_RULES = {
    "SGD": (dict(lr=0.05), 0, (), None),
    "Adam": (dict(lr=1e-3, beta1=0.8, beta2=0.9, epsilon=1e-7), 1,
             (1.0 - 0.8, 1.0 - 0.9, 1e-7),
             ("_b2", 0.99, (1.0 - 0.8, 1.0 - 0.99, 1e-7))),
    "Momentum": (dict(lr=0.01, momentum=0.8), 2, (0.8,),
                 ("_momentum", 0.5, (0.5,))),
    "Lion": (dict(lr=1e-4, beta1=0.8, beta2=0.95), 3,
             (0.8, 1.0 - 0.8, 0.95, 1.0 - 0.95),
             ("_b1", 0.5, (0.5, 1.0 - 0.5, 0.95, 1.0 - 0.95))),
    "RMSProp": (dict(lr=1e-3, decay=0.9, momentum=0.5, epsilon=1e-6), 4,
                (1.0 - 0.9, 0.5, 1e-6),
                ("_eps", 1e-3, (1.0 - 0.9, 0.5, 1e-3))),
    "Adagrad": (dict(lr=0.05, epsilon=1e-6), 5, (1e-6,),
                ("_eps", 1e-4, (1e-4,))),
    "Adadelta": (dict(lr=1.0, decay=0.95, epsilon=1e-6), 6,
                 (1.0 - 0.95, 1e-6), ("_decay", 0.9, (1.0 - 0.9, 1e-6))),
}


def _f32(consts):
    return tuple(float(np.float32(c)) for c in consts + (0.0,) * 4)[:4]


def _small_mlp():
    net = build_mnist_mlp(num_in=5, hidden=(4,), num_out=3)
    net.init((2, 5))
    return net


@pytest.mark.parametrize("rule", sorted(KERNEL_RULES))
def test_kernel_rule_pins_code_and_constants(rule):
    kw, code, consts, late = KERNEL_RULES[rule]
    opt = getattr(optimizer, rule)(**kw)
    assert opt.kernel_rule() == (code, _f32(consts))
    assert fused_epoch.OPTIMIZERS[code] == rule
    # read at the call: an attribute set after construction (as a planted
    # fault sets Adam's beta2) reaches the spec K2 is launched with
    opt.weight_decay = 0.25
    if late is not None:
        name, value, consts = late
        setattr(opt, name, value)
    spec = fused_epoch.epoch_spec(_small_mlp(), opt)
    assert (spec.optimizer, spec.consts) == (code, _f32(consts))
    assert spec.weight_decay == 0.25
    assert spec.slot_names == opt.slot_names


def test_a_subclass_has_no_kernel_rule():
    class Nesterov(optimizer.Momentum):
        def rule(self, g, scalars, slots):
            acc = slots["acc"].mul_(self._momentum).add_(g)
            return scalars[0] * (g + self._momentum * acc)

    opt = Nesterov(0.01)
    assert optimizer.Momentum.kernel_code == 2 and opt.kernel_code is None
    with pytest.raises(ValueError, match="Nesterov has no rule"):
        opt.kernel_rule()
    mlp = _small_mlp()
    assert "Nesterov has no rule" in fused_epoch.unsupported_reason(
        mlp, mlp.params_tree(), opt, SoftmaxCrossEntropyLoss())
    net = build_deep_mlp(num_in=8, depth=4, width=32, num_out=3,
                         stacked=True)
    assert "Nesterov has no rule" in streaming_epoch.unsupported_reason(
        net, opt)


@pytest.mark.parametrize("rule", sorted(KERNEL_RULES))
def test_update_is_a_step_leaf_loop(rule):
    sched = scheduler.WarmupCosineLR(0.01, warmup_steps=2, decay_steps=6)
    kw = dict(KERNEL_RULES[rule][0], lr=sched, weight_decay=1e-2)
    a, b = (getattr(optimizer, rule)(**kw) for _ in range(2))
    rng = np.random.RandomState(3)
    params = [{"w": torch.from_numpy(rng.randn(2, 5, 4).astype(np.float32)),
               "b": torch.from_numpy(rng.randn(2, 1, 4).astype(np.float32))},
              {}, {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}]
    state = a.init_state(params)
    slots = b.init_state(params)["slots"]
    for t in range(1, 6):
        grads = [{k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
                  for k, v in d.items()} for d in params]
        steps, state = a.update(grads, params, state)
        assert state["t"] == t
        for i, d in enumerate(params):
            for k in sorted(d):
                leaf_slots = {n: slots[n][i][k] for n in b.slot_names}
                want, _ = b.step_leaf(grads[i][k], sched(t), t, leaf_slots)
                want = want - 1e-2 * d[k]
                assert torch.equal(steps[i][k], want), (t, i, k)
                for n in b.slot_names:
                    assert torch.equal(state["slots"][n][i][k],
                                       leaf_slots[n]), (t, i, k, n)
        for d, s in zip(params, steps):
            for k in d:
                d[k] = d[k] + s[k]


TIERS = ("step", "fused", "stream", "dp_step", "dp_fused")
N, BATCH = 32, 8  # four steps an epoch, on one rank or two


def _train(tier, model, x, y, n_epochs):
    if tier.startswith("dp_"):
        dp = DataParallel(model, mesh=make_mesh(
            devices=[torch.device("cpu")] * 2))
        return dp.train_epochs(x, y, n_epochs, batch_size=BATCH,
                               fused=tier == "dp_fused")
    fused = {"step": False, "fused": True, "stream": "stream"}[tier]
    return model.train_epochs(x, y, n_epochs, batch_size=BATCH, fused=fused)


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("tier", TIERS)
def test_every_tier_counts_its_steps_on_one_state(tier, reset):
    seeder.random_seed(0)
    net = (build_deep_mlp(num_in=8, depth=4, width=32, num_out=3,
                          stacked=True) if tier == "stream"
           else build_mnist_mlp(num_in=8, hidden=(16,), num_out=3))
    opt = optimizer.Adam(1e-3)
    model = Model(net, SoftmaxCrossEntropyLoss(), opt, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(N, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, N)]
    steps = N // BATCH

    assert opt.step_count == 0 and opt.state_dict() is None
    _train(tier, model, x, y, 1)
    state = opt.state_dict()
    assert opt.step_count == state["t"] == steps
    def shapes(tree):
        return [{k: v.shape for k, v in d.items()} for d in tree]

    for n in opt.slot_names:
        assert shapes(state["slots"][n]) == shapes(net.params_tree())
    if reset:
        opt.reset()
        assert opt.step_count == 0 and opt.state_dict() is None
    losses = _train(tier, model, x, y, 2)
    assert torch.isfinite(losses).all()
    assert (opt.state_dict() is state) is not reset
    assert opt.step_count == opt.state_dict()["t"] \
        == (2 if reset else 3) * steps
