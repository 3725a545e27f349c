"""K2's optimizer rules in the PyTorch package against the JAX package: the
port's K2 plain version (``fused_epoch_reference``, through
``train_epoch(fused=True)`` on the CPU) with each of the seven optimizers and
weight decay, a learning-rate schedule and ``clip_norm``, against the JAX
megakernel in interpret mode; the optimizer-only probe's plain version
(P2, ``ops/mega_probe.py``) against a JAX loop of the same ``step_leaf``;
and the entry points ``examples/mnist/optimizer_sweep_torch.py``,
``bench_mega_probe_torch.py`` and ``k2_seed_scan.py`` with ``--device
cpu``.

The net is the Dropout MLP 16-32-32-10 (ReLU, Dropout 0.3 after the two
first), batch 16, 8 steps, from the JAX side's parameters (seed 5, as the
flagship parity draws are pinned in tests/test_torch_fused_epoch.py: Adam
and Adadelta turn a gradient whose terms nearly cancel into a full-size
step). Held at K2's gates: losses rtol 1e-5/atol 1e-6, parameters and
slots rtol 1e-4/atol 1e-5. The clipping norm is summed in another order
than the JAX tree sum.

The CUDA kernels run only on a card: tests/test_torch_cuda.py compares them
with these plain versions there.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn import scheduler as jsched
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.net import Net as JNet
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch.nn import layers, optimizer, scheduler
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.ops import fused_epoch, kernels, mega_probe
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
PARITY_SEED = 5
WD = 1e-2
# (optimizer class, its arguments, schedule or None)
RULES = {
    "sgd": ("SGD", dict(lr=0.1, weight_decay=WD), None),
    "momentum": ("Momentum", dict(lr=0.05, momentum=0.9, weight_decay=WD),
                 None),
    "adam": ("Adam", dict(lr=1e-2, weight_decay=WD), None),
    "lion": ("Lion", dict(lr=1e-3, weight_decay=WD), None),
    "rmsprop": ("RMSProp", dict(lr=1e-3, momentum=0.5, weight_decay=WD),
                None),
    "adagrad": ("Adagrad", dict(lr=3e-2, weight_decay=WD), None),
    "adadelta": ("Adadelta", dict(lr=1.0, weight_decay=WD), None),
    "adam_schedule": ("Adam", dict(), ("WarmupCosineLR",
                                       dict(lr=1e-2, warmup_steps=3,
                                            decay_steps=8))),
    "sgd_clip_norm": ("SGD", dict(lr=0.1, clip_norm=0.5), None),
    "adam_clip_norm": ("Adam", dict(lr=1e-2, clip_norm=0.5), None),
}


def _make(pkg_opt, pkg_sched, case):
    cls, kwargs, sched = RULES[case]
    kwargs = dict(kwargs)
    if sched is not None:
        kwargs["lr"] = getattr(pkg_sched, sched[0])(**sched[1])
    return getattr(pkg_opt, cls)(**kwargs)


def _mlp_layers(pkg):
    return [pkg.Dense(32, num_in=16), pkg.ReLU(), pkg.Dropout(0.3),
            pkg.Dense(32, num_in=32), pkg.ReLU(), pkg.Dropout(0.3),
            pkg.Dense(10, num_in=32)]


def _assert_trees_close(jtree, ttree, what):
    jtree = jax.tree.map(np.asarray, jtree)
    for i, (a, b) in enumerate(zip(jtree, params_to_numpy(ttree))):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="%s layer %d %s"
                                       % (what, i, k), **STATE_TOL)


@pytest.mark.parametrize("case", sorted(RULES))
def test_fused_epoch_rule_matches_jax_megakernel(case):
    rng = np.random.RandomState(0)
    x = rng.randn(128, 16).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 128)]
    jax_seeder.random_seed(PARITY_SEED)
    jm = JModel(JNet(_mlp_layers(jlayers)), JCE(), _make(jopt, jsched, case))
    tm = Model(Net(_mlp_layers(layers)), SoftmaxCrossEntropyLoss(),
               _make(optimizer, scheduler, case), device="cpu")
    tm.net.set_parameters(params_from_jax(jm.net.params_tree(), "cpu"))
    assert fused_epoch.unsupported_reason(
        tm.net, tm.net.params_tree(), tm.optimizer, tm.loss, (16, 16)) is None
    lj = np.asarray(jm.train_epoch(x, y, batch_size=16, shuffle=False,
                                   fused=True))
    lt = tm.train_epoch(x, y, batch_size=16, shuffle=False, fused=True)
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_trees_close(jm.net.params_tree(), tm.net.params_tree(), "params")
    state = tm.optimizer.state_dict()
    assert int(jm._opt_state["t"]) == state["t"] == 8
    for name in tm.optimizer.slot_names:
        _assert_trees_close(jm._opt_state["slots"][name],
                            state["slots"][name], name)


def test_epoch_spec_carries_the_rule():
    net = Net(_mlp_layers(layers))
    spec = fused_epoch.epoch_spec(net, optimizer.RMSProp(
        lr=1e-3, decay=0.9, momentum=0.5, epsilon=1e-7, weight_decay=1e-4,
        clip_norm=2.0))
    assert spec.optimizer == 4 and spec.slot_names == ("ms", "mom")
    np.testing.assert_array_equal(
        spec.consts, np.float32([1.0 - 0.9, 0.5, 1e-7, 0.0]))
    assert spec.weight_decay == float(np.float32(1e-4))
    assert spec.clip_norm == 2.0
    assert fused_epoch.phase_names(spec)[-2:] == ["clip norm", "optimizer"]
    assert [layer[3:] for layer in spec.layers] == [(0.3, 0), (0.3, 1),
                                                    (0.0, -1)]


# --------------------------------------------------------------------------
# P2: the optimizer-only probe's plain version
# --------------------------------------------------------------------------

PROBES = {"sgd": ("SGD", 1e-2), "momentum": ("Momentum", 1e-2),
          "rmsprop": ("RMSProp", 1e-3), "adam": ("Adam", 1e-3)}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_mega_probe_reference_matches_a_jax_step_leaf_loop(name):
    cls, lr = PROBES[name]
    rng = np.random.RandomState(0)
    start = [rng.randn(*s).astype(np.float32) * 0.05
             for s in mega_probe.LEAF_SHAPES]
    jax_o = getattr(jopt, cls)(lr)
    jp = [jnp.asarray(p) for p in start]
    js = {n: [jnp.zeros_like(p) for p in jp] for n in jax_o.slot_names}
    t0, n_steps = 1, 50

    @jax.jit
    def probe_step(jp, js, t):
        jp, js = list(jp), {n: list(v) for n, v in js.items()}
        for j in range(len(jp)):
            step, new = jax_o.step_leaf(
                jp[j] * 1e-3, jax_o._lr_at(t), t,
                {n: js[n][j] for n in jax_o.slot_names}, salt=j)
            jp[j] = jp[j] + step
            for n in jax_o.slot_names:
                js[n][j] = new[n]
        return jp, js

    for i in range(n_steps):
        jp, js = probe_step(jp, js, jnp.int32(t0 + i))
    torch_o = getattr(optimizer, cls)(lr)
    tp = [torch.from_numpy(p.copy()) for p in start]
    ts = {n: [torch.zeros_like(p) for p in tp] for n in torch_o.slot_names}
    mega_probe.mega_probe_reference(torch_o, tp, ts, t0, n_steps)
    for j, (a, b) in enumerate(zip(jp, tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7, err_msg="leaf %d" % j)
        for n in torch_o.slot_names:
            np.testing.assert_allclose(ts[n][j].numpy(), np.asarray(js[n][j]),
                                       rtol=1e-5, atol=1e-9,
                                       err_msg="%s %d" % (n, j))


def test_probe_scalars_start_at_t0():
    # the probe's step i runs at t = t0 + i; its wrapper passes the kernel
    # step_scalars(t0 - 1, n), whose first row is step t0's
    adam = optimizer.Adam(1e-3)
    np.testing.assert_array_equal(adam.step_scalars(1 - 1, 3)[0],
                                  np.float32(adam.scalars(1e-3, 1)))
    # and the plain version takes its step t0 at _lr_at(t0) and t0's bias
    # corrections: from zero slots Adam's first step is -lr sign(g)
    p = torch.tensor([0.5, -0.25])
    mega_probe.mega_probe_reference(adam, [p], {"m": [torch.zeros(2)],
                                                "v": [torch.zeros(2)]}, 1, 1)
    np.testing.assert_allclose(p.numpy(), [0.5 - 1e-3, -0.25 + 1e-3],
                               rtol=1e-6)


def test_mega_probe_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(mega_probe)
    assert "ctypes" not in vars(mod)
    assert "mega_probe" not in kernels._loaded
    assert mod.cuda_mega_probe.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        mod.cuda_mega_probe(optimizer.SGD(0.1), [torch.ones(3)], {}, 1, 5)
    assert mod.cuda_mega_probe.launches == 0
    cmd = kernels.nvcc_command("nvcc", mod.SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


# --------------------------------------------------------------------------
# the entry points on the CPU
# --------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*path):
    spec = importlib.util.spec_from_file_location(
        "_".join(path).replace(".py", ""), os.path.join(REPO, *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sweep_example_keeps_the_jax_table():
    jax_table = _load("examples", "mnist", "optimizer_sweep.py").OPTIMIZERS
    table = _load("examples", "mnist", "optimizer_sweep_torch.py").OPTIMIZERS
    assert list(table) == list(jax_table)
    for name in table:
        a, b = jax_table[name](1e-3), table[name](1e-3)
        assert type(a).__name__ == type(b).__name__
        assert {k: v for k, v in vars(a).items() if not k.startswith("_state")
                and isinstance(v, float)} == {
            k: v for k, v in vars(b).items() if isinstance(v, float)}, name


# what each entry point prints on the CPU
PRINTED = {"optimizer_sweep_torch.py": ["lion", "best:"],
           "bench_mega_probe_torch.py": ['"mega_opt_adam_delta_vs_sgd_us"'],
           "k2_seed_scan.py": ["data seed 0: least ReLU input over the 10 "
                               "steps"]}


@pytest.mark.parametrize("script,args", [
    (("examples", "mnist", "optimizer_sweep_torch.py"),
     ["--num_ep", "1", "--batch_size", "2048"]),
    (("bench_mega_probe_torch.py",), ["--steps", "3", "--repeats", "1"]),
    (("k2_seed_scan.py",), ["--seeds", "1"])])
def test_entry_point_runs_on_the_cpu(script, args):
    tpu_file = os.path.join(REPO, "MEGA_PROBE.json")  # the TPU's, untouched
    before = open(tpu_file, "rb").read()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, *script), "--device", "cpu"]
        + args, capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert open(tpu_file, "rb").read() == before
    assert all(text in out.stdout for text in PRINTED[script[-1]])
